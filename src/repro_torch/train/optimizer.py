"""AdamW with a configurable moment-dtype policy (no external deps).

PyTorch counterpart of the JAX package's ``train/optimizer.py``: plain
functions on tensors over the port's params layout (nested dicts, the
layers a list of per-layer dicts).  The arithmetic is the reference's: f32
math cast back to each leaf's dtype, an int32 step, the bias corrections
``1 - b ** step`` in f32, and bf16 or f32 moments.  One difference of
form: :func:`adamw_update` writes the new params and optimizer state into
the given tensors and returns them — the reference's train step donates
its state, so nothing reads the old one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    #: dtype for the m/v moments: "float32" | "bfloat16"
    moment_dtype: str = "float32"
    #: linear warmup steps then constant
    warmup_steps: int = 100


# --------------------------------------------------------------------------- #
# trees: nested dicts and lists of tensors
# --------------------------------------------------------------------------- #
def tree_leaves(tree) -> list:
    """The tensors of ``tree``, dict keys in sorted order (as ``jax.tree``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in :func:`tree_leaves`' order;
    the result has that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves`' order) put into ``tree``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def adamw_init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    md = _mdtype(cfg)
    zeros = lambda p: torch.zeros_like(p, dtype=md)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.learning_rate * warm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, opt_state) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step: ``params`` and ``opt_state`` (m, v, step) are
    updated in place and returned.  Every number stays on the device."""
    step = opt_state["step"].add_(1)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - b1**stepf
    bc2 = 1.0 - b2**stepf
    for g, p, m, v in zip(tree_leaves(grads), tree_leaves(params),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)  # copy_ rounds to p's dtype
        m.copy_(mf)
        v.copy_(vf)
    return params, opt_state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda leaf: (leaf.float() * scale).to(leaf.dtype), tree), norm
