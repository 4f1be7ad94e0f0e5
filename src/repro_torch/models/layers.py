"""Shared primitive layers: norms, init helpers, rotary embeddings (+M-RoPE).

PyTorch counterpart of the JAX package's ``models/layers.py``.  Parameter
layouts are the JAX package's (a dense weight is ``(in_dim, *out_shape)``),
so parameters carry across with :mod:`repro_torch.models.convert`.  Random
init draws from an explicit ``torch.Generator`` on the target device; its
numbers differ from ``jax.random``'s for the same seed, so the differential
tests carry the JAX parameters across instead of re-drawing them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[
        name
    ]


# --------------------------------------------------------------------------- #
# Init helpers
# --------------------------------------------------------------------------- #
#: the standard normal's CDF at -2 and +2
_CDF_LO, _CDF_HI = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))


def trunc_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill f32 ``w`` in place with a standard normal truncated at +-2, by
    the inverse CDF of a uniform draw from ``gen``.  The inverse CDF is
    ``torch.special.ndtri``, not the ``erfinv`` of
    ``torch.nn.init.trunc_normal_``: once, on the H100 machine's host,
    ``erfinv`` gave other bits for the same input bits in two runs of one
    process (the buffers at 0 and 128 mod 256); what triggers that is not
    known, and the hypothesis is that its vectorised path depends on the
    buffer's address (ROADMAP P4, D12)."""
    w.uniform_(_CDF_LO, _CDF_HI, generator=gen)
    torch.special.ndtri(w, out=w)
    return w.clamp_(-2.0, 2.0)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype) -> torch.Tensor:
    """Truncated-normal (at +-2) fan-in init, shape (in_dim, *out_shape), on
    the generator's device."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32, device=gen.device)
    return trunc_normal_(w, gen).mul_(1.0 / np.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 1.0, generator=gen).mul_(0.02).to(dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale) + bias).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary embeddings
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Computed in numpy f32 exactly as the JAX package does, then moved to
    the device by the callers."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) int
    theta: float,
) -> torch.Tensor:
    freqs = torch.from_numpy(rope_frequencies(x.shape[-1], theta)).to(x.device)
    angles = positions[..., None].float() * freqs  # (B, S, d/2)
    return _rotate(x, angles)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Split of the half-dim rotary channels across (t, h, w) position
    streams; Qwen2-VL uses (16, 24, 24) for head_dim=128."""
    half = head_dim // 2
    a = half // 3
    return (half - 2 * a, a, a)


def apply_mrope(
    x: torch.Tensor,          # (B, S, H, D)
    positions: torch.Tensor,  # (3, B, S) int — temporal / height / width
    theta: float,
) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: rotary channel groups are driven by
    different position streams (text tokens use identical streams)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(d, theta)).to(x.device)
    stream_of = np.concatenate(
        [np.full(s, i, dtype=np.int64) for i, s in enumerate(mrope_sections(d))]
    )  # (d/2,)
    pos = positions.float()[torch.from_numpy(stream_of).to(x.device)]  # (d/2, B, S)
    angles = torch.movedim(pos, 0, -1) * freqs  # (B, S, d/2)
    return _rotate(x, angles)
