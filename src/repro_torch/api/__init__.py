"""``repro_torch.api`` — the user-transparent facade of the PyTorch port.

    from repro_torch import api

    session = api.load("qwen2.5-14b")                 # on CUDA
    session.train(steps=10, seq_len=2048, global_batch=2)
    session.generate([3, 1, 4, 1, 5], max_new=16)     # continuous batching
    session.serve(list_of_prompts, max_new=8)         # closed batch

``api.load(arch, smoke=True, device="cpu")`` runs the same script on the
CPU with the kernels' plain PyTorch versions; ``api.load(arch,
mesh="2x2")`` runs it over a mesh of four processes.
"""
from repro_torch.api.session import (CapabilityError, Session, TrainResult,
                                     load, parse_mesh)

__all__ = ["CapabilityError", "Session", "TrainResult", "load", "parse_mesh"]
