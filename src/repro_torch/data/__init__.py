"""Rank-sharded data readers and the input pipeline of the PyTorch port
(the paper's §III-F)."""
