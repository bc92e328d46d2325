"""The whole step's share of the card's bf16 peak in the profiled slice,
for a model of windowed and global layers with a held share of its
experts (``work_hybrid.step_mfu``: its own FLOP count)."""
from bench.core.work_hybrid import step_mfu as read  # noqa: F401
