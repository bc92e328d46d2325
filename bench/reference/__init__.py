"""Plain float32 references of the served families, one module per family.

Each family module gives ``param_shapes(cfg)`` (the parameter tree the
served program takes, as shapes), ``leaf_std(path, shape)`` (the spread the
benchmark draws each leaf with) and ``logits_at(cfg, weights, seqs, wanted,
precision=...)``.  They import torch and nothing of the program: every
quantity the program derives from the weights is worked out again here.
"""
