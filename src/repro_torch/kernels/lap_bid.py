"""Auction bid step — batched masked row-wise top-2 (CUDA kernel + plain).

Given a benefit matrix ``a`` (B, n, m) and prices ``p`` (B, m), each row
needs, per auction round::

    vals[b, i, j] = a[b, i, j] - p[b, j]
    best_v[b, i]  = max_j vals[b, i, j]
    best_j[b, i]  = first argmax_j vals[b, i, j]            (int32)
    second[b, i]  = max_{j != best_j} vals[b, i, j]   (-1e30 when m == 1)

The hand-written kernel is ``csrc/lap_bid.cu`` (its header says what bounds
it and how it is laid out); it replaces the Pallas kernels
``lap_bid_pallas`` / ``lap_bid_pallas_batched`` of the JAX package.  The
wrapper :func:`lap_bid_batched` launches it for CUDA tensors and takes the
plain version :func:`lap_bid_top2_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: "no second column" value of the kernel (the Pallas kernel's NEG_INF).
NEG_INF = -1e30

_GRID_LIMIT = (1 << 31) - 1


def lap_bid_top2_plain(a: torch.Tensor, prices: torch.Tensor):
    """Plain PyTorch version: ``a`` (B, n, m) f32, ``prices`` (B, m) f32 ->
    ``(best_v (B, n) f32, best_j (B, n) int32, second (B, n) f32)``."""
    vals = a - prices[:, None, :]
    best_j = torch.argmax(vals, dim=-1)
    best_v = torch.gather(vals, -1, best_j[..., None])[..., 0]
    masked = vals.scatter(-1, best_j[..., None], NEG_INF)
    second = masked.max(dim=-1).values
    return best_v, best_j.to(torch.int32), second


def _check(a: torch.Tensor, prices: torch.Tensor) -> None:
    if a.ndim != 3 or prices.ndim != 2:
        raise ValueError(
            f"lap_bid_batched: want a (B, n, m) and prices (B, m), got "
            f"{tuple(a.shape)} and {tuple(prices.shape)}"
        )
    if a.dtype != torch.float32 or prices.dtype != torch.float32:
        raise ValueError(
            f"lap_bid_batched: want float32, got {a.dtype} and {prices.dtype}"
        )
    b, n, m = a.shape
    if tuple(prices.shape) != (b, m):
        raise ValueError(
            f"lap_bid_batched: prices {tuple(prices.shape)} do not match a "
            f"{tuple(a.shape)} (want {(b, m)})"
        )
    if a.device != prices.device:
        raise ValueError(
            f"lap_bid_batched: a on {a.device}, prices on {prices.device}"
        )


def lap_bid_batched(a: torch.Tensor, prices: torch.Tensor):
    """Bid top-2 over ``a`` (B, n, m) with ``prices`` (B, m), both f32.

    CUDA tensors launch the kernel (contiguous operands, one launch, counted
    in ``lap_bid_batched.launches``); CPU tensors take
    :func:`lap_bid_top2_plain`.  Any other device raises.
    """
    _check(a, prices)
    if a.device.type == "cpu":
        return lap_bid_top2_plain(a, prices)
    if a.device.type != "cuda":
        raise ValueError(f"lap_bid_batched: unsupported device {a.device}")
    if not (a.is_contiguous() and prices.is_contiguous()):
        raise ValueError("lap_bid_batched: a and prices must be contiguous")
    b, n, m = a.shape
    best_v = torch.empty((b, n), dtype=torch.float32, device=a.device)
    best_j = torch.empty((b, n), dtype=torch.int32, device=a.device)
    second = torch.empty((b, n), dtype=torch.float32, device=a.device)
    if b * n == 0 or m == 0:
        return best_v, best_j, second
    group = 1
    while group < m and group < 32:
        group *= 2
    if (b * n * group + 255) // 256 > _GRID_LIMIT:
        raise ValueError(f"lap_bid_batched: {b * n} rows exceed one launch")
    lib = build.library("lap_bid")
    fn = lib.lap_bid_batched
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), prices.data_ptr(), best_v.data_ptr(), best_j.data_ptr(),
            second.data_ptr(), b, n, m, stream,
        )
    build.check(err, "lap_bid_batched")
    lap_bid_batched.launches += 1
    return best_v, best_j, second


lap_bid_batched.launches = 0
