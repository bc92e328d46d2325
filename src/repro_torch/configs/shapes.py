"""The four assigned input-shape presets (LM-family)."""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", kind="train", seq_len=4_096, global_batch=256)
PREFILL_32K = ShapeConfig(name="prefill_32k", kind="prefill", seq_len=32_768, global_batch=32)
DECODE_32K = ShapeConfig(name="decode_32k", kind="decode", seq_len=32_768, global_batch=128)
LONG_500K = ShapeConfig(name="long_500k", kind="decode", seq_len=524_288, global_batch=1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}") from None
