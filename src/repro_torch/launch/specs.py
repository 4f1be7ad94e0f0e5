"""Input shapes, abstract stand-ins, and per-leaf sharding rules.

PyTorch counterpart of the JAX package's ``launch/specs.py``.
``input_specs(cfg, shape)`` builds every model input as a tensor on the
``meta`` device — shapes and dtypes, no storage — where the reference
builds ``jax.ShapeDtypeStruct``\\ s.  ``logical_axes_for(path, shape)`` names
each param/optimizer/cache leaf's logical axes;
:class:`repro_torch.launch.pspec.ShardingRules` maps those to mesh axes with
divisibility fallbacks (e.g. qwen2-vl's 12 heads stay replicated on a
16-way model axis while its 8960-wide FFN shards).

The port keeps a model's layers as a list of per-layer dicts where the
reference stacks them.  :func:`tree_paths_and_leaves` reads such a list as
one stacked leaf per key, as ``train/checkpoint.py`` writes it: the path
``layers.attn.wq`` and a ``meta`` tensor with the layer count as its
leading dim.  So the port's trees get the reference's paths, logical axes,
specs and bytes per device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.pspec import NamedSharding, ShardingRules


# --------------------------------------------------------------------------- #
# The four assigned input shapes
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def token_dtype() -> torch.dtype:
    return torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins (``meta`` tensors) for one (arch, shape) pair."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), token_dtype())}

    batch: Dict[str, torch.Tensor] = {
        "tokens": _meta((b, s), token_dtype()),
    }
    if shape.kind == "train":
        batch["targets"] = _meta((b, s), token_dtype())
    if cfg.frontend == "vision":
        batch["image_embeds"] = _meta((b, cfg.frontend_len, cfg.d_model), torch.float32)
        if cfg.mrope:
            batch["mrope_positions"] = _meta((3, b, s + cfg.frontend_len), token_dtype())
    elif cfg.frontend == "audio":
        batch["audio_frames"] = _meta((b, cfg.frontend_len, cfg.d_model), torch.float32)
    return batch


def batch_logical_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    if name == "mrope_positions":
        return (None, "batch") + (None,) * (ndim - 2)
    return ("batch",) + (None,) * (ndim - 1)


# --------------------------------------------------------------------------- #
# Parameter / optimizer / cache leaf -> logical axes
# --------------------------------------------------------------------------- #
_RULES = [
    # (regex on the dict path, logical axes WITHOUT the stacked-layer dim)
    (r"embed$", ("vocab", "fsdp")),
    (r"lm_head$", ("fsdp", "vocab")),
    (r"(final_norm|enc_norm|norm\d?|norm_x|q_norm|k_norm|kv_norm)$", None),  # 1-D: replicate
    # attention
    (r"attn.*wq$", ("fsdp", "heads", None)),
    (r"attn.*w[kv]$", ("fsdp", "kv_heads", None)),
    (r"attn.*wo$", ("heads_flat", "fsdp")),
    (r"attn.*wkv_a$", ("fsdp", None)),
    (r"attn.*wkv_b$", (None, "heads", None)),
    # dense ffn
    (r"(ffn|shared).*w_(gate|up)$", ("fsdp", "ff")),
    (r"(ffn|shared).*w_down$", ("ff", "fsdp")),
    # moe
    (r"moe.*router$", ("fsdp", None)),
    (r"moe\.w_(gate|up)$", ("expert", "fsdp", None)),
    (r"moe\.w_down$", ("expert", None, "fsdp")),
    # mamba
    (r"mamba\.in_proj$", ("fsdp", "ssm_inner")),
    (r"mamba\.out_proj$", ("ssm_inner", "fsdp")),
    (r"mamba\.(conv_w|conv_b|a_log|d_skip|dt_bias|norm)$", None),
    # zamba shared block concat projection
    (r"shared_attn\.in_proj$", ("fsdp", None)),
]


def logical_axes_for(path: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    """Logical axes for a leaf.  Leaves under "layers"/"enc_layers"/...
    carry a leading stacked-layer dim (never sharded)."""
    stacked = bool(re.search(r"(^|\.)((dec_|enc_)?layers)\.", path))
    ndim = len(shape)
    body_ndim = ndim - 1 if stacked else ndim
    axes: Tuple[Optional[str], ...] = (None,) * body_ndim
    for pat, rule in _RULES:
        if re.search(pat, path):
            if rule is None:
                axes = (None,) * body_ndim
            else:
                axes = tuple(rule)[:body_ndim]
                if len(axes) < body_ndim:
                    axes = axes + (None,) * (body_ndim - len(axes))
            break
    if stacked:
        axes = (None,) + axes
    return axes


def cache_logical_axes(path: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    ndim = len(shape)
    if "cross_" in path:  # (L, B, F, KV, hd)
        return (None, "batch", None, "kv_heads", None)
    if path.endswith("state"):  # (L, B, H, P, N)
        return (None, "batch", "ssm_heads", None, None)
    if path.endswith("conv"):  # (L, B, W, CH)
        return (None, "batch", None, None)
    if path.endswith("ckv") or path.endswith("k_rope"):  # (L, B, S, r)
        return (None, "batch", "cache_seq", None)
    if path.endswith("k") or path.endswith("v"):  # (L, B, S, KV, hd)
        return (None, "batch", "cache_seq", "kv_heads", None)
    return (None,) * ndim


def _walk(tree, prefix: Tuple[str, ...] = ()):
    """(path parts, leaf) pairs, dict keys sorted; for a list the leaf is the
    list of that key's per-entry tensors, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        per_entry = [list(_walk(t, prefix)) for t in tree]
        for items in zip(*per_entry):
            yield items[0][0], [leaf for _, leaf in items]
    else:
        yield prefix, tree


def tree_paths_and_tensors(tree) -> List[Tuple[str, List[torch.Tensor]]]:
    """[(dotted_path, tensors)]: the tensors one path of
    :func:`tree_paths_and_leaves` stands for, one per layer of a stacked
    leaf, else the one leaf."""
    return [(".".join(parts), leaf if isinstance(leaf, list) else [leaf])
            for parts, leaf in _walk(tree)]


def tree_paths_and_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """[(dotted_path, leaf)] for a nested dict of tensors; a list of
    per-layer dicts gives one stacked leaf per key, a ``meta`` tensor of
    shape ``(len(list), *per-layer shape)`` and the per-layer dtype."""
    out = []
    for parts, leaf in _walk(tree):
        if isinstance(leaf, list):
            leaf = _meta((len(leaf), *leaf[0].shape), leaf[0].dtype)
        out.append((".".join(parts), leaf))
    return out


def sharding_tree(tree, rules: ShardingRules, axes_fn) -> Dict[str, NamedSharding]:
    """Each leaf's :class:`NamedSharding` via ``axes_fn(path, shape)``, keyed by
    its dotted path (a stacked leaf: one sharding for all its layers)."""
    return {path: rules.sharding_for(tuple(leaf.shape), axes_fn(path, tuple(leaf.shape)))
            for path, leaf in tree_paths_and_leaves(tree)}


def shard_count(sh: NamedSharding) -> int:
    """How many shards ``sh`` cuts an array into: the product of the mesh
    axes its spec names."""
    denom = 1
    for spec in sh.spec:
        if spec is None:
            continue
        for nm in spec if isinstance(spec, tuple) else (spec,):
            denom *= sh.mesh.shape[nm]
    return denom


def bytes_per_device(tree, shardings: Dict[str, NamedSharding]) -> int:
    """Exact per-device bytes of a sharded tree (shape/spec arithmetic)."""
    return sum(leaf.numel() * leaf.element_size() // shard_count(shardings[path])
               for path, leaf in tree_paths_and_leaves(tree))
