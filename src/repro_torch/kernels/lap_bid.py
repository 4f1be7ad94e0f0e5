"""Auction bid step — batched masked row-wise top-2 (CUDA kernel + plain).

Given a benefit matrix ``a`` (B, n, m) and prices ``p`` (B, m), each row
needs, per auction round::

    vals[b, i, j] = a[b, i, j] - p[b, j]
    best_v[b, i]  = max_j vals[b, i, j]
    best_j[b, i]  = first argmax_j vals[b, i, j]            (int32)
    second[b, i]  = max_{j != best_j} vals[b, i, j]   (-1e30 when m == 1)

The FUSED variant takes a raw cost matrix instead and assembles the benefit
per element, ``a[b, i, j] = tb[b] * (i+1)^2 * (j+1) - cost[b, i, j]`` (the
positional tie-break ramp of the fused migrate stage, ``tb = 0`` for none),
so the benefit never exists as a tensor.

The hand-written kernel is ``csrc/lap_bid.cu`` (its header says what bounds
it and how it is laid out); it replaces the Pallas kernels
``lap_bid_pallas`` / ``lap_bid_pallas_batched`` and ``lap_bid_fused_pallas``
/ ``lap_bid_fused_pallas_batched`` of the JAX package.  The wrappers
:func:`lap_bid_batched` and :func:`lap_bid_fused_batched` launch it for CUDA
tensors and take the plain versions :func:`lap_bid_top2_plain` /
:func:`lap_bid_fused_top2_plain` only for CPU tensors.  How the kernel is
launched is decided here, by :func:`launch_geometry` (which the CPU tests
reach), and passed to the kernel's entry points.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

#: "no second column" value of the kernel (the Pallas kernel's NEG_INF).
NEG_INF = -1e30

#: threads per CTA (the kernel's ``__launch_bounds__`` allow up to 256)
THREADS = 256
#: the most lanes that share a row (the kernel merges within a warp)
MAX_GROUP = 32
#: columns below which a row takes no more lanes
COLS_PER_LANE = 16

_GRID_LIMIT = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How ``csrc/lap_bid.cu`` covers a (B, n, m) batch: ``group`` lanes own
    each row (row ``bx * rows_per_cta + t // group`` for thread ``t`` of
    block ``bx``), ``rows_per_cta = threads // group`` rows to a CTA, and
    ``grid`` CTAs.  Within a row, lane ``l`` reads the aligned float4
    chunks ``l, l + group, ...``, lane 0 the scalar head before them and
    lane ``group - 1`` the scalar tail after them.  A row's instance is
    ``row // n``, computed as ``(row * div_mul >> 32) >> div_shr``
    (:func:`row_divisor`)."""

    group: int
    rows_per_cta: int
    threads: int
    grid: int
    div_mul: int
    div_shr: int


def launch_geometry(b: int, n: int, m: int) -> Geometry:
    """The kernel's launch for a (B, n, m) batch (B * n >= 1, m >= 1): the
    fewest lanes per row, a power of two up to a warp, that leave each lane
    about :data:`COLS_PER_LANE` columns (one thread per row up to 16
    columns)."""
    if b * n < 1 or m < 1:
        raise ValueError(f"lap_bid: want B * n >= 1 and m >= 1, got {(b, n, m)}")
    group = 1
    while group < MAX_GROUP and COLS_PER_LANE * group < m:
        group *= 2
    rows_per_cta = THREADS // group
    grid = -(-(b * n) // rows_per_cta)
    if grid > _GRID_LIMIT:
        raise ValueError(f"lap_bid: {b * n} rows exceed one launch")
    return Geometry(group, rows_per_cta, THREADS, grid, *row_divisor(n))


def row_divisor(n: int):
    """``(mul, shr)`` with ``row // n == (row * mul >> 32) >> shr`` for every
    ``0 <= row < 2**31`` and ``n >= 2`` (Granlund and Montgomery's rounding-up
    multiplier, ``mul = ceil(2**(31 + l) / n)``, ``l = ceil(log2 n)``);
    ``(0, 0)`` for ``n = 1``, whose instance is the row, and from ``n =
    2**31`` on.  The kernel divides for real from ``2**31`` rows on."""
    if n < 2 or n >= 1 << 31:
        return 0, 0
    log2 = (n - 1).bit_length()
    return -(-(1 << (31 + log2)) // n), log2 - 1


def lap_bid_top2_plain(a: torch.Tensor, prices: torch.Tensor):
    """Plain PyTorch version: ``a`` (B, n, m) f32, ``prices`` (B, m) f32 ->
    ``(best_v (B, n) f32, best_j (B, n) int32, second (B, n) f32)``."""
    vals = a - prices[:, None, :]
    best_j = torch.argmax(vals, dim=-1)
    best_v = torch.gather(vals, -1, best_j[..., None])[..., 0]
    masked = vals.scatter(-1, best_j[..., None], NEG_INF)
    second = masked.max(dim=-1).values
    return best_v, best_j.to(torch.int32), second


def fused_benefit(cost: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """``(tb * (i+1)^2) * (j+1) - cost`` over a (B, n, m) cost batch with
    ``tb`` (B,), in the fused kernels' operation order."""
    b, n, m = cost.shape
    gi = (torch.arange(n, dtype=torch.float32, device=cost.device) + 1.0).view(1, n, 1)
    gj = (torch.arange(m, dtype=torch.float32, device=cost.device) + 1.0).view(1, 1, m)
    return tb.view(b, 1, 1) * (gi * gi) * gj - cost


def lap_bid_fused_top2_plain(cost: torch.Tensor, prices: torch.Tensor, tb: torch.Tensor):
    """Plain PyTorch version of the fused bid: ``cost`` (B, n, m) f32,
    ``prices`` (B, m) f32, ``tb`` (B,) f32; the benefit is
    :func:`fused_benefit`, assembled in the kernel's order."""
    return lap_bid_top2_plain(fused_benefit(cost, tb), prices)


def _check(what: str, a: torch.Tensor, prices: torch.Tensor, tb=None) -> None:
    if a.ndim != 3 or prices.ndim != 2:
        raise ValueError(
            f"{what}: want a (B, n, m) and prices (B, m), got "
            f"{tuple(a.shape)} and {tuple(prices.shape)}"
        )
    operands = (a, prices) if tb is None else (a, prices, tb)
    if any(t.dtype != torch.float32 for t in operands):
        raise ValueError(
            f"{what}: want float32, got {', '.join(str(t.dtype) for t in operands)}"
        )
    b, n, m = a.shape
    if tuple(prices.shape) != (b, m):
        raise ValueError(
            f"{what}: prices {tuple(prices.shape)} do not match a "
            f"{tuple(a.shape)} (want {(b, m)})"
        )
    if tb is not None and tuple(tb.shape) != (b,):
        raise ValueError(
            f"{what}: tb {tuple(tb.shape)} does not match a {tuple(a.shape)} (want {(b,)})"
        )
    if any(t.device != a.device for t in operands):
        raise ValueError(
            f"{what}: operands on {', '.join(str(t.device) for t in operands)}"
        )


def _launch(what: str, entry: str, a: torch.Tensor, prices: torch.Tensor, tb=None):
    """Launch the C entry point ``entry`` of ``csrc/lap_bid.cu`` on CUDA
    operands (already checked) and return its three outputs."""
    if a.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {a.device}")
    operands = (a, prices) if tb is None else (a, prices, tb)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{what}: operands must be contiguous")
    b, n, m = a.shape
    best_v = torch.empty((b, n), dtype=torch.float32, device=a.device)
    best_j = torch.empty((b, n), dtype=torch.int32, device=a.device)
    second = torch.empty((b, n), dtype=torch.float32, device=a.device)
    if b * n == 0 or m == 0:
        return best_v, best_j, second
    geo = launch_geometry(b, n, m)
    fn = getattr(build.library("lap_bid"), entry)
    fn.argtypes = ([ctypes.c_void_p] * (len(operands) + 3) + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in operands), best_v.data_ptr(), best_j.data_ptr(),
            second.data_ptr(), b, n, m, geo.group, geo.threads, geo.grid, geo.div_mul,
            geo.div_shr, stream,
        )
    build.check(err, what)
    return best_v, best_j, second


def lap_bid_batched(a: torch.Tensor, prices: torch.Tensor):
    """Bid top-2 over ``a`` (B, n, m) with ``prices`` (B, m), both f32.

    CUDA tensors launch the kernel (contiguous operands, one launch, counted
    in ``lap_bid_batched.launches``); CPU tensors take
    :func:`lap_bid_top2_plain`.  Any other device raises.
    """
    _check("lap_bid_batched", a, prices)
    if a.device.type == "cpu":
        return lap_bid_top2_plain(a, prices)
    out = _launch("lap_bid_batched", "lap_bid_batched", a, prices)
    lap_bid_batched.launches += 1
    return out


lap_bid_batched.launches = 0


def lap_bid_fused_batched(cost: torch.Tensor, prices: torch.Tensor, tb: torch.Tensor):
    """Fused bid top-2 over a raw ``cost`` (B, n, m) with ``prices`` (B, m)
    and a per-instance tie-break scale ``tb`` (B,), all f32.

    CUDA tensors launch the kernel (counted in
    ``lap_bid_fused_batched.launches``); CPU tensors take
    :func:`lap_bid_fused_top2_plain`.  Any other device raises.
    """
    _check("lap_bid_fused_batched", cost, prices, tb)
    if cost.device.type == "cpu":
        return lap_bid_fused_top2_plain(cost, prices, tb)
    out = _launch("lap_bid_fused_batched", "lap_bid_fused_batched", cost, prices, tb)
    lap_bid_fused_batched.launches += 1
    return out


lap_bid_fused_batched.launches = 0
