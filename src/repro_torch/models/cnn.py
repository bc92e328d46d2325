"""The paper's CNNs: AlexNet (its Table II) and a TinyCNN for the Fig. 7
sequential-vs-distributed loss-equivalence experiment.

The port of ``src/repro/models/cnn.py``, plain functions on tensors with
the reference's pytree keys.  AlexNet is the paper's network (LRN as
identity, a documented deviation of the reference); TinyCNN runs the same
trainer path at laptop scale.  There is no registry bundle for the family,
as in the JAX package: train it through
``repro_torch.core.transparent.TransparentTrainer`` with ``cnn_loss``.

Layouts are the reference's: images NHWC, conv weights HWIO, dense weights
``[in, out]``, so ``repro_torch.convert.from_jax_params`` stays a key-for-
key copy.  At call time the weights are permuted to OIHW and the
activations to NCHW as views: the NCHW view of an NHWC tensor is in the
channels-last memory format, which cuDNN convolves directly, and its
output permuted back is NHWC again, so no activation is copied.

The reference's AlexNet works at 227 x 227 input only: at the 224 x 224
its docstring and ``configs/alexnet.py`` name, ``f6`` would contract 6400
against 9216.  The port computes what the reference computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def conv_spec(kh, kw, cin, cout):
    return {
        "w": ParamSpec((kh, kw, cin, cout), (None, None, None, "mlp"),
                       fan_in_axis=-2),
        "b": ParamSpec((cout,), ("mlp",), init="zeros"),
    }


def dense_spec(fin, fout, shard_out=True):
    return {
        "w": ParamSpec((fin, fout), ("embed", "mlp" if shard_out else None)),
        "b": ParamSpec((fout,), ("mlp" if shard_out else None,), init="zeros"),
    }


def _same_pads(size: int, k: int, stride: int):
    """``lax`` "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride=1, padding="SAME"):
    """x: [B,H,W,Cin] NHWC; p["w"]: [kh,kw,Cin,Cout] HWIO -> [B,H',W',Cout]
    (``lax.conv_general_dilated`` with ``("NHWC", "HWIO", "NHWC")``)."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)           # OIHW view
    xc = x.permute(0, 3, 1, 2)                            # NCHW view
    if padding == "SAME":
        kh, kw = w.shape[2:]
        (t, b), (l, r) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
        if t == b and l == r:
            y = F.conv2d(xc, w, stride=stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(xc, (l, r, t, b)), w, stride=stride)
    elif padding == "VALID":
        y = F.conv2d(xc, w, stride=stride)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def maxpool(x, k=3, s=2):
    """VALID max pool of NHWC ``x`` with window ``k`` and stride ``s``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def _dense(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# AlexNet (input 227x227x3, 1000 classes)
# ---------------------------------------------------------------------------

def alexnet_specs(num_classes: int = 1000):
    return {
        "c1": conv_spec(11, 11, 3, 96),
        "c2": conv_spec(5, 5, 96, 256),
        "c3": conv_spec(3, 3, 256, 384),
        "c4": conv_spec(3, 3, 384, 384),
        "c5": conv_spec(3, 3, 384, 256),
        "f6": dense_spec(256 * 6 * 6, 4096),
        "f7": dense_spec(4096, 4096),
        "f8": dense_spec(4096, num_classes, shard_out=False),
    }


def alexnet_forward(params, images):
    x = images
    x = maxpool(F.relu(conv2d(params["c1"], x, 4, "VALID")))
    x = maxpool(F.relu(conv2d(params["c2"], x)))
    x = F.relu(conv2d(params["c3"], x))
    x = F.relu(conv2d(params["c4"], x))
    x = maxpool(F.relu(conv2d(params["c5"], x)))
    x = x.reshape(x.shape[0], -1)
    x = F.relu(_dense(params["f6"], x))
    x = F.relu(_dense(params["f7"], x))
    return _dense(params["f8"], x)


# ---------------------------------------------------------------------------
# TinyCNN (16x16x3, for CPU-scale equivalence runs)
# ---------------------------------------------------------------------------

def tinycnn_specs(num_classes: int = 10):
    return {
        "c1": conv_spec(3, 3, 3, 16),
        "c2": conv_spec(3, 3, 16, 32),
        "f1": dense_spec(32 * 4 * 4, 64),
        "f2": dense_spec(64, num_classes, shard_out=False),
    }


def tinycnn_forward(params, images):
    x = images
    x = maxpool(F.relu(conv2d(params["c1"], x)), 2, 2)
    x = maxpool(F.relu(conv2d(params["c2"], x)), 2, 2)
    x = x.reshape(x.shape[0], -1)
    x = F.relu(_dense(params["f1"], x))
    return _dense(params["f2"], x)


def cnn_loss(forward_fn, params, batch, num_classes: int):
    """batch: {"images": [B,H,W,C], "labels": [B]} -> mean CE (fp32)."""
    logits = forward_fn(params, batch["images"]).float()
    onehot = F.one_hot(batch["labels"].long(), num_classes).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))
