"""Algorithm-3 pairwise migration-cost matrix (CUDA kernel + plain), f64.

For GPU u of the previous round with job set JS_u and GPU v of the new
round with job set JS_v::

    C[u, v] = sum_{j in JS_u symdiff JS_v} 1 / (2 * num_gpus(j))

from the dense slot encoding: ``slots_u`` (U, P) / ``slots_v`` (V, P) int32
job ids (-1 empty, P = MAX_PACK = 2) and per-slot f64 weights ``w_u`` /
``w_v`` (0 for empty slots).  The hand-written kernel is
``csrc/migration_cost.cu``; it replaces the Pallas kernel
``migration_cost_pallas`` of the JAX package and is bit-identical to the
numpy host computation (``core.migration.pairwise_migration_cost``).
How it is launched is decided here, by :func:`launch_geometry` (which the
CPU tests reach), and passed to the kernel's entry point.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.device import NO_TIMER
from repro_torch.kernels import build

#: slots per GPU the kernel is unrolled for (core.cluster.MAX_PACK)
P = 2
#: threads per CTA (the kernel's ``__launch_bounds__`` allow up to 256)
THREADS = 256
#: the fewest column pairs a CTA row spans, a warp
MIN_TX = 32
#: rows per thread on large outputs (the kernel is built for 1, 2, 4 and 8)
ROWS = 8
#: outputs of this many cells and more take ``ROWS`` rows per thread
MANY_CELLS = 1 << 21
#: the largest y grid of a launch; more row tiles are looped over
MAX_GRID_Y = 65535
_GRID_LIMIT = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How ``csrc/migration_cost.cu`` covers a (U, V) output.

    Blocks are ``block = (tx, ty)`` threads.  Thread ``(x, y)`` of block
    ``(bx, by)`` owns column pair ``k = bx * tx + x`` (``< pairs``) and, in
    each row tile ``t = by, by + grid[1], ...`` (of ``ty * rows`` rows),
    the rows ``t * ty * rows + r * ty + y`` for ``r < rows``.  In row ``u``
    it writes cells ``2k + s`` and ``2k + s + 1`` as one 16-byte store,
    where ``s = 1`` on a row that starts 8 bytes past a 16-byte boundary (V
    odd, u odd) and 0 elsewhere.  A pair reaching past V leaves a one-cell
    tail (a scalar store); on a shifted row the pair-0 thread also writes
    cell 0, the scalar head."""

    block: tuple
    rows: int
    pairs: int
    row_tiles: int
    grid: tuple


def launch_geometry(u: int, v: int) -> Geometry:
    """The kernel's launch for a (U, V) output (U, V >= 1): ``tx`` the
    column pairs rounded up to a power of two in [32, 256], ``ty = 256 /
    tx``; 8 rows per thread from 2^21 cells on, 1 below."""
    if u < 1 or v < 1:
        raise ValueError(f"migration_cost: want U, V >= 1, got {u}x{v}")
    pairs = (v + 1) // 2
    tx = MIN_TX
    while tx < THREADS and tx < pairs:
        tx *= 2
    ty = THREADS // tx
    rows = ROWS if u * v >= MANY_CELLS else 1
    row_tiles = -(-u // (ty * rows))
    grid = (-(-pairs // tx), min(row_tiles, MAX_GRID_Y))
    if grid[0] > _GRID_LIMIT:
        raise ValueError(f"migration_cost: {u}x{v} exceeds one launch")
    return Geometry((tx, ty), rows, pairs, row_tiles, grid)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` on a 16-byte-aligned base (the kernel's vector loads need it);
    a fresh copy only where a view starts elsewhere.  The operands are 24
    bytes per GPU."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def migration_cost_plain(slots_u, slots_v, w_u, w_v) -> torch.Tensor:
    """Plain PyTorch version, same operation order as the numpy reference:
    per side, the masked weights summed slot by slot, then out + in."""
    eq = slots_u[:, None, :, None] == slots_v[None, :, None, :]  # (U, V, P, P)
    u_in_v = eq.any(dim=-1)  # (U, V, P)
    v_in_u = eq.any(dim=-2)
    out_terms = torch.where(u_in_v, 0.0, w_u[:, None, :])
    in_terms = torch.where(v_in_u, 0.0, w_v[None, :, :])
    cost_out = out_terms[..., 0]
    cost_in = in_terms[..., 0]
    for a in range(1, slots_u.shape[1]):
        cost_out = cost_out + out_terms[..., a]
        cost_in = cost_in + in_terms[..., a]
    return cost_out + cost_in


def _check(slots_u, slots_v, w_u, w_v) -> None:
    if slots_u.ndim != 2 or slots_v.ndim != 2 or slots_u.shape[1] != slots_v.shape[1]:
        raise ValueError(
            f"migration_cost: want slots (U, P) / (V, P), got "
            f"{tuple(slots_u.shape)} and {tuple(slots_v.shape)}"
        )
    if w_u.shape != slots_u.shape or w_v.shape != slots_v.shape:
        raise ValueError(
            f"migration_cost: weights {tuple(w_u.shape)} / {tuple(w_v.shape)} "
            f"do not match slots {tuple(slots_u.shape)} / {tuple(slots_v.shape)}"
        )
    if slots_u.dtype != torch.int32 or slots_v.dtype != torch.int32:
        raise ValueError(
            f"migration_cost: slots must be int32, got {slots_u.dtype} / {slots_v.dtype}"
        )
    if w_u.dtype != torch.float64 or w_v.dtype != torch.float64:
        raise ValueError(
            f"migration_cost: weights must be float64, got {w_u.dtype} / {w_v.dtype}"
        )
    devs = {t.device for t in (slots_u, slots_v, w_u, w_v)}
    if len(devs) != 1:
        raise ValueError(f"migration_cost: operands on several devices {devs}")


def migration_cost(slots_u, slots_v, w_u, w_v, timer=NO_TIMER) -> torch.Tensor:
    """(U, V) f64 cost matrix.  CUDA tensors launch the kernel (P must be 2;
    counted in ``migration_cost.launches``); CPU tensors take
    :func:`migration_cost_plain`.  Any other device raises.  ``timer``
    (``repro_torch.device.device_timer``) hands the C entry its event pair,
    recorded right before and right after the launch."""
    _check(slots_u, slots_v, w_u, w_v)
    dev = slots_u.device
    if dev.type == "cpu":
        return migration_cost_plain(slots_u, slots_v, w_u, w_v)
    if dev.type != "cuda":
        raise ValueError(f"migration_cost: unsupported device {dev}")
    if slots_u.shape[1] != P:
        raise ValueError(f"migration_cost: the kernel takes P = {P}, got {slots_u.shape[1]}")
    if not all(t.is_contiguous() for t in (slots_u, slots_v, w_u, w_v)):
        raise ValueError("migration_cost: operands must be contiguous")
    u, v = slots_u.shape[0], slots_v.shape[0]
    out = torch.empty((u, v), dtype=torch.float64, device=dev)
    if u * v == 0:
        return out
    geo = launch_geometry(u, v)
    slots_u, slots_v, w_u, w_v = (_aligned(t) for t in (slots_u, slots_v, w_u, w_v))
    fn = build.library("migration_cost").migration_cost
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            slots_u.data_ptr(), slots_v.data_ptr(), w_u.data_ptr(), w_v.data_ptr(),
            out.data_ptr(), u, v, *geo.block, geo.rows, geo.row_tiles, *geo.grid, stream,
            *timer.handles(),
        )
    build.check(err, "migration_cost")
    migration_cost.launches += 1
    return out


migration_cost.launches = 0
