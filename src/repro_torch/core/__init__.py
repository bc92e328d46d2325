"""The paper's runtime in the PyTorch port: broadcast at init, gradient
all-reduce after every batch, and the transparent trainer that injects
both around a sequential loss."""
