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
computes for a launch (instance, split-K grid, head chunks, shared memory,
heads per warp, blocks per SM), so it is tested on a host without a card.

Bytes bound it: every valid slot's K and V are read once.  Its instances:

- ``mma_bf16`` (bf16, every D): the scores and P V on the tensor cores
  (``mma.sync`` m16n8k16, the group's heads as M), warp w owning slots
  [16w, 16w + 16) of every 64-slot tile (:func:`mma_warp_slots`), so all
  four warps score at group 1 too, read from a ring of
  :func:`mma_stages` tiles whose rows are swizzled, or at D 80 padded to
  an odd chunk count (:func:`mma_chunk_offset`).  Its shared memory holds
  :func:`mma_min_blocks` blocks on an SM (4 at D 64, 3 at D 80 and 128, 2
  at D 192), and the launch bounds keep registers from binding first.
- ``ffma_f32`` (f32, every D): exact f32 FFMAs on the CUDA cores
  (``ffma::flash_decode_partial_ffma``).  A ring of ``cp.async`` copies of
  32-slot tiles (:func:`ffma_stages` of them, rows padded by a float4:
  :func:`ffma_row_offset`), warp w owning slots [8w, 8w + 8) of each
  (:func:`ffma_warp_slots`), every lane scoring one slot against every head
  of a chunk of at most 16, 12 at D 192 (``heads_per_warp`` = the chunk's
  size class, :func:`ffma_head_class`; a grid z per chunk, so a larger
  group reads the cache once a chunk) and holding every head's O at its
  columns for P V.  Its shared memory holds 3 blocks on an SM at D 64 and
  2 at D 80, 128, 192, and the launch bounds keep registers from binding
  first.

Both instances' split-K grids are sized to the blocks the card holds at
once (:func:`resident_splits`): one wave where B * KV allows.
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
#: warps of the partial kernels
WARPS = 4
#: the H100: SMs, shared memory per SM (of which a block reserves 1 KB) and
#: one block may use (227 KB), 32-bit registers per SM
SMS, SM_SMEM, BLOCK_SMEM_RESERVED, SMEM_LIMIT, SM_REGISTERS = 132, 233_472, 1024, 232_448, 65_536
#: the ``ffma_f32`` ring's budget: at most this much shared memory and at
#: most ``_MAX_STAGES`` tiles
_RING_BYTES, _MAX_STAGES = 110 * 1024, 4
#: the ``mma_bf16`` instance (csrc/flash_decode.cu ``mma::``): its largest
#: group (the M rows of one m16n8k16), and the slots a warp owns in every tile
MMA_MAX_GROUP, MMA_WARP_SLOTS = 16, TILE // WARPS
#: the ``ffma_f32`` instance (csrc/flash_decode.cu ``ffma::``): cache slots
#: per tile, the slots a warp owns in every tile, and the chunk sizes with
#: an instance (a chunk of the group runs on the least that holds it; 16
#: only below D 192, :func:`ffma_max_group`)
FFMA_TILE, FFMA_WARP_SLOTS = 32, 32 // WARPS
FFMA_HEAD_CLASSES = (1, 2, 4, 8, 12, 16)
#: the largest ``heads_per_warp`` each instance has
_MAX_HEADS_PER_WARP = dict(mma_bf16=MMA_MAX_GROUP, ffma_f32=16)


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


def resident_splits(batch_kv: int, cache_len: int, resident: int, tile: int = TILE):
    """(splits, tiles per split) of the ``mma_bf16`` and ``ffma_f32``
    split-K grids over ``tile``-slot tiles: as many even splits as keep
    ``batch_kv`` (B*KV, times the head chunks) * splits within the
    ``resident`` blocks the card holds at once (one wave), and one split per
    block of ``batch_kv`` when that alone fills it."""
    tiles = max(1, -(-cache_len // tile))
    per = -(-tiles // max(1, min(tiles, resident // batch_kv)))
    return -(-tiles // per), per


def blocks_per_sm(smem_bytes: int, registers: int | None = None) -> int:
    """Blocks of ``WARPS`` warps one SM holds with ``smem_bytes`` of dynamic
    shared memory each and, where given, ``registers`` a thread (allocated
    per warp in units of 256)."""
    by_smem = SM_SMEM // (smem_bytes + BLOCK_SMEM_RESERVED)
    if registers is None:
        return by_smem
    per_warp = -(-registers * 32 // 256) * 256
    return min(by_smem, SM_REGISTERS // (per_warp * WARPS))


def mma_stages(d: int) -> int:
    """64-slot K+V tiles in the ``mma_bf16`` ring at head dim ``d``
    (``mma::stages<D>``)."""
    return 2 if d > 80 else 3


def mma_row_chunks(d: int) -> int:
    """16-byte chunks of a K or V row staged by ``mma_bf16``
    (``mma::row_chunks<D>``): ``d / 8``, and at D 80 one of padding."""
    return d // 8 if d % 64 == 0 else d // 8 + 1


def mma_smem(d: int) -> int:
    """``mma_bf16``'s dynamic shared memory at head dim ``d``
    (``mma::smem_bytes<D>``): its ring."""
    return mma_stages(d) * 2 * TILE * mma_row_chunks(d) * 16


def mma_min_blocks(d: int) -> int:
    """Blocks per SM the ``mma_bf16`` instance's launch bounds ask for at
    head dim ``d`` (``mma::min_blocks<D>``): what its shared memory holds."""
    return SM_SMEM // (mma_smem(d) + BLOCK_SMEM_RESERVED)


def mma_registers(d: int) -> int:
    """Registers a thread of the ``mma_bf16`` instance may take at head dim
    ``d``: the launch bounds' budget, in units of 8, at most 255."""
    return min(255, SM_REGISTERS // (mma_min_blocks(d) * WARPS * 32) // 8 * 8)


def mma_chunk_offset(row: int, chunk: int, d: int) -> int:
    """Byte offset in a K or V tile of the ``mma_bf16`` ring of 16-byte chunk
    ``chunk`` of cache row ``row`` (``mma::chunk_offset``): where ``2 d`` is
    0 mod 128, the chunk is stored at ``chunk ^ (row & 7)`` of its row;
    else (D 80) at ``chunk`` of a row padded to an odd chunk count."""
    if d % 64 == 0:
        return row * (2 * d) + ((chunk ^ (row & 7)) << 4)
    return (row * mma_row_chunks(d) + chunk) << 4


def mma_warp_slots(warp: int) -> range:
    """The slots of every 64-slot tile that warp ``warp`` of the
    ``mma_bf16`` instance scores."""
    return range(MMA_WARP_SLOTS * warp, MMA_WARP_SLOTS * (warp + 1))


def ffma_max_group(d: int) -> int:
    """Query heads an ``ffma_f32`` block serves at head dim ``d``, a chunk of
    the group (``ffma::max_group``): 16, but 12 at D 192, where 16 heads'
    96 floats of O a lane spill past 255 registers."""
    return 12 if d > 128 else 16


def ffma_head_class(g: int, d: int) -> int:
    """The chunk size whose ``ffma_f32`` instance serves ``g`` query heads
    per KV head at head dim ``d`` (``ffma::head_class`` of the largest
    chunk): the least of ``FFMA_HEAD_CLASSES`` that holds it, its rows past
    the chunk's heads zero."""
    return next(c for c in FFMA_HEAD_CLASSES if c >= min(g, ffma_max_group(d)))


def ffma_head_chunks(g: int, d: int) -> range:
    """The first heads of the chunks that the ``ffma_f32`` grid's z axis
    walks for ``g`` query heads per KV head at head dim ``d``."""
    return range(0, g, ffma_max_group(d))


def ffma_row4(d: int) -> int:
    """float4s of a K or V row staged by ``ffma_f32`` (``ffma::row4``):
    ``d / 4`` and one of padding, an odd count."""
    return d // 4 + 1


def ffma_row_offset(row: int, chunk: int, d: int) -> int:
    """Byte offset in a K or V tile of ``ffma_f32``'s ring of float4
    ``chunk`` of cache row ``row``."""
    return 16 * (row * ffma_row4(d) + chunk)


def ffma_stages(d: int) -> int:
    """32-slot K+V tiles in ``ffma_f32``'s ring (``ffma::stages``): as many
    as fit in ~110 KB, at most four."""
    return min(_MAX_STAGES, _RING_BYTES // (2 * FFMA_TILE * ffma_row4(d) * 16))


def ffma_smem(d: int, gp: int) -> int:
    """``ffma_f32``'s dynamic shared memory at head dim ``d`` and chunk size
    ``gp`` (``ffma::smem_bytes``): the ring, Q (gp x d) and each warp's P
    (8 slots x gp), f32."""
    ring = ffma_stages(d) * 2 * FFMA_TILE * ffma_row4(d) * 16
    return ring + 4 * gp * d + 4 * WARPS * FFMA_WARP_SLOTS * gp


def ffma_min_blocks(d: int) -> int:
    """Blocks per SM ``ffma_f32``'s launch bounds ask for at head dim ``d``
    (``ffma::min_blocks``): what its shared memory holds at the largest
    chunk."""
    return SM_SMEM // (ffma_smem(d, ffma_max_group(d)) + BLOCK_SMEM_RESERVED)


def ffma_registers(d: int) -> int:
    """Registers a thread of ``ffma_f32`` may take at head dim ``d``: the
    launch bounds' budget, in units of 8, at most 255."""
    return min(255, SM_REGISTERS // (ffma_min_blocks(d) * WARPS * 32) // 8 * 8)


def ffma_warp_slots(warp: int) -> range:
    """The slots of every 32-slot tile that warp ``warp`` of ``ffma_f32``
    scores: slot ``sl`` by lanes ``sl``, ``sl + 8``, ``sl + 16``, ``sl + 24``,
    a quarter of the row each."""
    return range(FFMA_WARP_SLOTS * warp, FFMA_WARP_SLOTS * (warp + 1))


def launch_plan(q_shape, cache_shape, dtype) -> dict:
    """What a launch of ``flash_decode`` on q (B, H, D) against a cache
    (B, S, KV, D) of ``dtype`` hands the C entry: the partial kernel's
    instance, its tile, split-K grid (``blocks`` = B * KV * splits *
    chunks; ``chunks`` > 1 only for ``ffma_f32`` past its largest chunk),
    the scratch its splits write, its dynamic shared memory and heads per
    warp, which the C entry checks against its own; and the blocks an SM
    holds."""
    b, h, d = q_shape
    s, kvh = cache_shape[1], cache_shape[2]
    g = h // kvh
    if dtype == torch.float32:
        tile, chunks, gp = FFMA_TILE, len(ffma_head_chunks(g, d)), ffma_head_class(g, d)
        smem = ffma_smem(d, gp)
        plan = dict(instance="ffma_f32", heads_per_warp=gp, smem_bytes=smem,
                    blocks_per_sm=blocks_per_sm(smem, ffma_registers(d)))
    elif dtype == torch.bfloat16:
        tile, chunks, smem = TILE, 1, mma_smem(d)
        plan = dict(instance="mma_bf16", heads_per_warp=g, smem_bytes=smem,
                    blocks_per_sm=blocks_per_sm(smem, mma_registers(d)))
    else:
        raise ValueError(f"flash_decode: the kernel takes float32 or bfloat16, got {dtype}")
    nsplit, per = resident_splits(b * kvh * chunks, s, plan["blocks_per_sm"] * SMS, tile)
    plan.update(tile=tile, chunks=chunks, splits=nsplit, tiles_per_split=per,
                blocks=b * kvh * nsplit * chunks, part_floats=b * kvh * nsplit * g * (d + 2))
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
    if plan["smem_bytes"] > SMEM_LIMIT or plan["heads_per_warp"] > _MAX_HEADS_PER_WARP[plan["instance"]]:
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


def card_blocks_per_sm(plan, d: int) -> int:
    """The blocks of ``plan``'s partial kernel (any instance) at head dim
    ``d`` that one SM of the current card holds, by the runtime's occupancy
    calculator (to hold ``plan["blocks_per_sm"]`` to; needs the card)."""
    fn = build.library("flash_decode").flash_decode_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    dtype = _DTYPES[torch.float32 if plan["instance"] == "ffma_f32" else torch.bfloat16]
    build.check(fn(dtype, d, plan["heads_per_warp"], ctypes.byref(n)), "flash_decode_blocks_per_sm")
    return n.value
