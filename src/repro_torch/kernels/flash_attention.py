"""Flash attention forward with GQA routing (CUDA kernel + plain).

For q (B, S, H, D) and k/v (B, S, KV, D) with G = H / KV::

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(D)) v[b, j, h // G]

over j < S, and j <= i when causal; f32 accumulation, the result in q's
type.  The hand-written kernel is ``csrc/flash_attention.cu`` (its header
says what bounds it and how it is laid out); it replaces the Pallas kernel
``flash_attention_pallas`` of the JAX package, which takes (BH, S, D) with
the KV heads already repeated — ``ops.flash_attention`` keeps that
contract.  :func:`flash_attention` launches the kernel for CUDA tensors
and takes the plain version :func:`flash_attention_plain` only for CPU
tensors.  :func:`launch_plan` is everything the wrapper computes for a
launch — the instance (bf16 tensor cores or f32 CUDA cores), its work
items and launched grid, shared memory and the bf16 instance's TMA tensor
maps — so it is tested on a host without a card.
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
#: the bf16 tensor-core instance (csrc/flash_attention.cu, namespace tc):
#: query rows per CTA, keys per K/V tile, ring stages, bf16 per 128-byte
#: swizzled TMA box row
TC_BLOCK_Q, TC_BLOCK_K, TC_STAGES, TC_PANEL = 128, 128, 3, 64
#: keys per K/V tile past a 128-wide row (``tc::BN_WIDE``, D = 192): Q plus
#: the ring fit the 227 KB of shared memory
TC_BLOCK_K_WIDE = 64
#: threads per CTA: two consumer warpgroups and the producer warpgroup
TC_THREADS = 384
#: registers a thread after ``setmaxnreg``: the producer warpgroup's and
#: the consumers' (24 x 128 + 240 x 256 = 168 x 384, the launch's grant)
TC_PRODUCER_REGS, TC_CONSUMER_REGS = 24, 240
#: the named barriers on which consumer warpgroups 0 and 1 wait their turn
#: to issue GEMMs (0 is ``__syncthreads``)
TC_TURN_BARRIERS = (1, 2)
#: the f32 CUDA-core instance (namespace cc): query rows per CTA, threads
#: per CTA (eight warps of 16 rows), P's floats per key in a warp's buffer
CC_BLOCK_Q, CC_THREADS, CC_P_ROW = 128, 256, 16
#: SMs of an H100 SXM: the bf16 instance's persistent grid where no card is
#: asked (the wrapper passes the card's own count)
H100_SMS = 132
#: one launch's limits: a grid's y dimension, and the int the bf16 walk
#: indexes its items with
GRID_Y_MAX, INT_MAX = 65535, (1 << 31) - 1


def flash_attention_plain(q, k, v, causal: bool = True, block_k: int = 512) -> torch.Tensor:
    """Plain PyTorch version: an online softmax over key tiles of
    ``block_k`` in f32, so it fits in memory at S = 32768.  A causal key
    tile only meets the query rows at or below its first key."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = (q.float() * (1.0 / d**0.5)).reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4)
    m = torch.full((b, kvh, g, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, s, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, s, d), device=q.device)
    rows_all = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        r0 = k0 if causal else 0
        kt = k[:, k0:k1].float().permute(0, 2, 1, 3)[:, :, None]  # (B, KV, 1, BK, D)
        vt = v[:, k0:k1].float().permute(0, 2, 1, 3)[:, :, None]
        sc = qf[:, :, :, r0:] @ kt.transpose(-1, -2)  # (B, KV, G, S - r0, BK)
        if causal:
            ok = rows_all[r0:, None] >= torch.arange(k0, k1, device=q.device)[None, :]
            sc.masked_fill_(~ok, NEG_INF)
        m_prev = m[:, :, :, r0:]
        m_cur = torch.maximum(m_prev, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_cur)
        alpha = torch.exp(m_prev - m_cur)
        l[:, :, :, r0:] = l[:, :, :, r0:] * alpha + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, r0:] = acc[:, :, :, r0:] * alpha + p @ vt
        m[:, :, :, r0:] = m_cur
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention: want q (B,S,H,D) and k/v (B,S,KV,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k/v shapes differ: {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on "
            "batch, sequence or head dim"
        )
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: H={h} must be a multiple of KV={k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: operands on several devices")


def tensor_map(shape, strides, box_rows: int, elem_bytes: int = 2) -> dict:
    """The 4-D TMA map of one (B, S, heads, D) operand: dims innermost first
    (D, heads, S, B), the byte strides of heads, S and B, and a box of
    ``TC_PANEL`` x 1 x ``box_rows`` x 1 (a 128-byte swizzled row holds 64
    bf16, so a D = 128 row takes two boxes).  The innermost dim stays the
    real D where the instance pads it (D = 80 takes two boxes too): TMA
    zero-fills the box's columns past D, even where memory runs on (a
    fused-qkv view).  A dim of size 1 gets the stride it would have
    contiguous: its stride is never used, and TMA wants every stride a
    non-zero multiple of 16 bytes."""
    b, s, heads, d = shape
    natural = (d * elem_bytes, heads * d * elem_bytes, s * heads * d * elem_bytes)
    sizes = (heads, s, b)
    byte_strides = tuple(
        nat if n == 1 else st * elem_bytes for st, n, nat in zip(strides[2::-1], sizes, natural)
    )
    return dict(dims=(d, heads, s, b), strides=byte_strides, box=(TC_PANEL, 1, box_rows, 1))


def tc_padded_dim(d: int) -> int:
    """The width the bf16 instance lays a row of head dim ``d`` out at in
    shared memory (``tc::padded``): whole 64-wide panels, 128 for D = 80."""
    return -(-d // TC_PANEL) * TC_PANEL


def tc_block_k(d: int) -> int:
    """Keys per K/V tile of the bf16 instance for head dim ``d``
    (``tc::block_k``): 128 up to a 128-wide row, 64 past it."""
    return TC_BLOCK_K_WIDE if tc_padded_dim(d) > 128 else TC_BLOCK_K


def tc_takes_turns(d: int) -> bool:
    """Whether the bf16 instance's two consumer warpgroups take turns to
    issue their GEMMs by named barriers (``tc::takes_turns``): up to a
    128-wide row; past it (D = 192) they issue as they come."""
    return tc_padded_dim(d) <= 128


def tc_walk(items: int, ctas: int) -> list:
    """The work items each CTA of the bf16 instance's persistent grid takes,
    in order (``tc::item_of``): CTA c takes one a round, the rounds running
    back and forth over the CTAs (c, then 2 * ctas - 1 - c, ...)."""
    walks = []
    for c in range(ctas):
        walk, r = [], 0
        while (i := r * ctas + (ctas - 1 - c if r & 1 else c)) < items:
            walk.append(i)
            r += 1
        walks.append(walk)
    return walks


def _tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the bf16 instance for head dim ``d``
    (``tc::Smem<padded(D)>::BYTES``): 1 KB to align to the swizzle atom, Q,
    the K/V ring, its mbarriers (Q full and empty, a full and an empty one
    per stage)."""
    dp = tc_padded_dim(d)
    return 1024 + 2 * TC_BLOCK_Q * dp + TC_STAGES * 2 * 2 * tc_block_k(d) * dp + 8 * (2 + 2 * TC_STAGES)


def cc_threads_per_row(d: int) -> int:
    """Lanes of the f32 instance that share a query row (``cc::threads_per_row``):
    16, or 8 past a 128-wide row (D = 192), where O's columns fill a lane's
    registers."""
    return 8 if d > 128 else 16


def cc_block_k(d: int) -> int:
    """Keys per K/V tile of the f32 instance (``cc::block_k``): four a lane
    of a row group, 64 (32 at D = 192)."""
    return 4 * cc_threads_per_row(d)


def cc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the f32 instance for head dim ``d``
    (``cc::Smem<D>::BYTES``): Q (128 x D), two K stages (rows padded by a
    float4), two V stages, and each of the eight warps' P (keys x 16)."""
    bk = cc_block_k(d)
    return 4 * (CC_BLOCK_Q * d + 2 * bk * (d + 4) + 2 * bk * d + (CC_THREADS // 32) * bk * CC_P_ROW)


def launch_plan(q_shape, kv_heads: int, dtype, q_strides=None, k_strides=None, v_strides=None,
                sms: int = H100_SMS) -> dict:
    """What a launch of ``flash_attention`` on q (B, S, H, D) and k/v
    (B, S, ``kv_heads``, D) of ``dtype`` hands the C entry or checks before
    it: the instance, its work ``items`` (b * h x 128-query tiles) and the
    ``grid`` it launches — the f32 instance a block an item, (b * h, query
    tiles); the bf16 instance a persistent 1-D grid of min(items, ``sms``)
    CTAs that walk them (:func:`fits_one_launch` holds each to its limits)
    — the threads per block, the dynamic shared memory (the C entry checks
    it against its own), the keys per K/V tile, and the bf16 instance's
    turns and tensor maps (the C entry checks the maps' box rows too).
    Strides (elements, default contiguous) matter only to the maps."""
    b, s, h, d = q_shape
    if dtype == torch.bfloat16:
        kv_shape = (b, s, kv_heads, d)
        contiguous = (s * h * d, h * d, d, 1), (s * kv_heads * d, kv_heads * d, d, 1)
        bk = tc_block_k(d)
        items = b * h * -(-s // TC_BLOCK_Q)
        return dict(
            instance="tc_bf16", items=items, grid=(min(items, sms),), threads=TC_THREADS,
            dynamic_smem_bytes=_tc_smem_bytes(d), block_k=bk, turns=tc_takes_turns(d),
            maps=dict(
                q=tensor_map(q_shape, q_strides or contiguous[0], TC_BLOCK_Q),
                k=tensor_map(kv_shape, k_strides or contiguous[1], bk),
                v=tensor_map(kv_shape, v_strides or contiguous[1], bk),
            ),
        )
    if dtype == torch.float32:
        qt = -(-s // CC_BLOCK_Q)
        return dict(instance="cc_f32", items=b * h * qt, grid=(b * h, qt), threads=CC_THREADS,
                    dynamic_smem_bytes=cc_smem_bytes(d), block_k=cc_block_k(d),
                    threads_per_row=cc_threads_per_row(d), maps=None)
    raise ValueError(f"flash_attention: the kernel takes float32 or bfloat16, got {dtype}")


def fits_one_launch(plan) -> bool:
    """Whether one launch takes ``plan``: the f32 grid's query tiles are its
    y dimension (at most ``GRID_Y_MAX``) and its b * h its x; the bf16 grid
    is at most one CTA an SM, and its walk indexes the items with an int."""
    if plan["instance"] == "cc_f32":
        return plan["grid"][1] <= GRID_Y_MAX and plan["grid"][0] <= INT_MAX
    return plan["items"] <= INT_MAX


def _maps_arg(maps) -> ctypes.Array:
    """The three maps as the C entry reads them: 11 values each."""
    flat = [x for name in ("q", "k", "v") for key in ("dims", "strides", "box") for x in maps[name][key]]
    return (ctypes.c_ulonglong * len(flat))(*flat)


def _tma_view(x):
    """``x`` as a TMA source: ``build.aligned_view``, and contiguous where a
    dim of size > 1 has stride 0 (a broadcast view, which a map cannot read)."""
    x = build.aligned_view(x)
    if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        x = x.contiguous()
    return x


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention output, contiguous.  CUDA tensors launch the
    kernel (bf16 or f32, D in ``HEAD_DIMS``; counted in
    ``flash_attention.launches``); CPU tensors take
    :func:`flash_attention_plain`.  Any other device raises, and so does a
    call that autograd records: the kernel has no backward, and its output
    would cut the gradient to q/k/v without a word."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the kernel has no backward (nor has the reference's Pallas "
            "kernel), so it cannot run under autograd; unset REPRO_USE_FLASH to train on "
            "the einsum path"
        )
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel instance for head dim {d} (have {HEAD_DIMS})")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    view = _tma_view if q.dtype == torch.bfloat16 else build.aligned_view
    q, k, v = view(q), view(k), view(v)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(q.shape, kvh, q.dtype, q.stride(), k.stride(), v.stride(), sms=sms)
    if not fits_one_launch(plan):
        raise ValueError(f"flash_attention: {tuple(q.shape)} exceeds one launch")
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    maps = _maps_arg(plan["maps"]) if plan["maps"] else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, h, kvh, d, int(causal),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            maps, plan["dynamic_smem_bytes"], stream,
        )
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
