"""Flash decoding — one query token per (batch, head) against a KV cache
(CUDA kernel + plain).

For q (B, H, D), a cache k/v (B, S, KV, D), G = H / KV and a scalar
``valid_len``::

    out[b, h] = softmax_{s < valid_len}(q[b, h] . k[b, s, h // G] / sqrt(D)) v[b, s, h // G]

in f32, the result in q's type, and ZEROS when ``valid_len`` is 0 — what
the Pallas kernel gives, since it skips every tile.  (The oracle
``ref.flash_decode`` keeps the reference oracle's semantics there: the
uniform mean of V; ROADMAP F6.)  ``valid_len`` is a scalar (ROADMAP F1): a
Python int, or a 0-d integer tensor on q's device, which the kernel reads
on the card with no host sync.

The hand-written kernel is ``csrc/flash_decode.cu`` (its header says what
bounds it and how it is laid out); it replaces the Pallas kernel
``flash_decode_pallas`` of the JAX package.  :func:`flash_decode` launches
it for CUDA tensors and takes the plain version :func:`flash_decode_plain`
only for CPU tensors.  :func:`launch_plan` is everything the wrapper
computes for a launch (instance, split-K grid, shared memory, heads per
warp), so it is tested on a host without a card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
#: head dims with a kernel instance (reduced and full GQA configs; 80 is
#: zamba2's shared block, 192 nemotron-4's)
HEAD_DIMS = (64, 80, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: cache slots per kernel tile (csrc/flash_decode.cu DBK)
TILE = 64
#: blocks the split-K grid aims for: four per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 4 * 132
#: warps of the partial kernels; a bf16 warp serves at most four heads
WARPS = 4
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the bf16 ring's budget: at most this much shared memory (two blocks per
#: SM) and at most ``_MAX_STAGES`` tiles
_RING_BYTES, _MAX_STAGES = 110 * 1024, 4


def flash_decode_plain(q, k, v, valid_len) -> torch.Tensor:
    """Plain PyTorch version in f32: masked softmax over the valid slots,
    written so that no valid slot gives zeros, as the kernel does."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, d) * (1.0 / d**0.5)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    ok = torch.arange(s, device=q.device) < valid_len
    logits = logits.masked_fill(~ok, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / torch.clamp(
        p.sum(dim=-1, keepdim=True), min=1e-30
    )
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k, v, valid_len) -> None:
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_decode: want q (B,H,D), k/v (B,S,KV,D); got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"flash_decode: k/v cache shapes differ ({tuple(k.shape)} vs {tuple(v.shape)})")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)} and cache {tuple(k.shape)} disagree on "
            "batch or head dim"
        )
    if q.shape[1] % k.shape[2]:
        raise ValueError(f"flash_decode: H={q.shape[1]} must be a multiple of KV={k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_decode: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_decode: operands on several devices")
    if torch.is_tensor(valid_len):
        if valid_len.ndim != 0 or valid_len.dtype.is_floating_point or valid_len.dtype == torch.bool:
            raise ValueError(
                f"flash_decode: valid_len must be a scalar integer (an int or a 0-d "
                f"tensor), got shape {tuple(valid_len.shape)} {valid_len.dtype}"
            )
        if valid_len.device != q.device:
            raise ValueError(f"flash_decode: valid_len on {valid_len.device}, q on {q.device}")
    elif not isinstance(valid_len, int):
        raise ValueError(f"flash_decode: valid_len must be an int or a 0-d tensor, got {type(valid_len)}")


def splits_for(batch_kv: int, cache_len: int):
    """(splits, tiles per split) of the split-K grid for ``batch_kv`` = B*KV
    blocks' worth of cache of ``cache_len`` slots."""
    tiles = max(1, (cache_len + TILE - 1) // TILE)
    want = min(tiles, max(1, -(-_TARGET_BLOCKS // batch_kv)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def ring_stages(d: int) -> int:
    """K/V tiles in flight in the bf16 kernel's ring (``ring::stages<D>``)."""
    return min(_MAX_STAGES, _RING_BYTES // (2 * TILE * d * 2))


def launch_plan(q_shape, cache_shape, dtype) -> dict:
    """What a launch of ``flash_decode`` on q (B, H, D) against a cache
    (B, S, KV, D) of ``dtype`` hands the C entry: the partial kernel's
    instance, split-K grid, the scratch its splits write, its dynamic shared
    memory and (bf16) heads per warp.  The C entry checks the last two
    against its own."""
    b, h, d = q_shape
    s, kvh = cache_shape[1], cache_shape[2]
    g = h // kvh
    nsplit, per = splits_for(b * kvh, s)
    plan = dict(splits=nsplit, tiles_per_split=per, part_floats=b * kvh * nsplit * g * (d + 2))
    if dtype == torch.bfloat16:
        plan.update(instance="ring_bf16", heads_per_warp=-(-g // WARPS),
                    smem_bytes=ring_stages(d) * 2 * TILE * d * 2)
    elif dtype == torch.float32:
        plan.update(instance="cc_f32", heads_per_warp=0,
                    smem_bytes=4 * (TILE * (d + 1) + TILE * d + 2 * g * d + g * TILE + 3 * g))
    else:
        raise ValueError(f"flash_decode: the kernel takes float32 or bfloat16, got {dtype}")
    return plan


def flash_decode(q, k, v, valid_len) -> torch.Tensor:
    """(B, H, D) decode attention.  CUDA tensors launch the kernel (bf16 or
    f32, D in ``HEAD_DIMS``; counted in ``flash_decode.launches``); CPU
    tensors take :func:`flash_decode_plain`.  Any other device raises."""
    _check(q, k, v, valid_len)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_plain(q, k, v, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode: the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_decode: no kernel instance for head dim {q.shape[-1]} (have {HEAD_DIMS})")
    return _launch(q, k, v, valid_len, launch_plan(q.shape, k.shape, q.dtype))


def _launch(q, k, v, valid_len, plan) -> torch.Tensor:
    """Launch the partial and merge kernels as ``plan`` says (checked
    operands on one CUDA device)."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    if plan["smem_bytes"] > SMEM_LIMIT or plan["heads_per_warp"] > 4:
        raise ValueError(
            f"flash_decode: no kernel instance for {h // kvh} query heads per KV head at head dim "
            f"{d} ({plan['smem_bytes']} bytes of shared memory)"
        )
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    part = torch.empty((plan["part_floats"],), dtype=torch.float32, device=dev)
    if torch.is_tensor(valid_len):
        vl_tensor = valid_len.to(torch.int32)  # stays on the device: no sync
        vl_ptr, vl_host = vl_tensor.data_ptr(), 0
    else:
        vl_ptr, vl_host = None, valid_len
    q, k, v = build.aligned_view(q), build.aligned_view(k), build.aligned_view(v)
    fn = build.library("flash_decode").flash_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vl_ptr, vl_host, out.data_ptr(),
            part.data_ptr(), _DTYPES[q.dtype], b, s, h, kvh, d, plan["splits"],
            plan["tiles_per_split"], *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            plan["smem_bytes"], plan["heads_per_warp"], stream,
        )
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
