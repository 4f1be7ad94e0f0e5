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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: slots per GPU the kernel is unrolled for (core.cluster.MAX_PACK)
P = 2


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


def migration_cost(slots_u, slots_v, w_u, w_v) -> torch.Tensor:
    """(U, V) f64 cost matrix.  CUDA tensors launch the kernel (P must be 2;
    counted in ``migration_cost.launches``); CPU tensors take
    :func:`migration_cost_plain`.  Any other device raises."""
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
    if (u * v + 255) // 256 > (1 << 31) - 1:
        raise ValueError(f"migration_cost: {u}x{v} exceeds one launch")
    fn = build.library("migration_cost").migration_cost
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            slots_u.data_ptr(), slots_v.data_ptr(), w_u.data_ptr(), w_v.data_ptr(),
            out.data_ptr(), u, v, stream,
        )
    build.check(err, "migration_cost")
    migration_cost.launches += 1
    return out


migration_cost.launches = 0
