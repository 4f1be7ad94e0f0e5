"""Train step: loss, grad accumulation (microbatching), remat, AdamW apply.

PyTorch counterpart of the JAX package's ``train/step.py``.  ``make_train_step``
returns ``train_step(state, batch) -> (state, metrics)``.  Gradients come
from ``torch.autograd.grad`` on detached leaves that share the params'
storage; the layers run under the remat policy of ``models/scan_util.py``
and attention takes the einsum path (ROADMAP D8).  With
``microbatches > 1`` the global batch is split on the batch axis (axis 1
of ``mrope_positions``) and the gradients accumulate in f32, as the
reference's ``lax.scan`` does.  The AdamW update is written into the state
in place (the reference's step donates its state), and every metric stays
a device tensor: a step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    grad_clip: float = 1.0
    #: cross-entropy z-loss coefficient (stabilises large-vocab logits)
    z_loss: float = 1e-4


def loss_fn(
    params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], train_cfg: TrainConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    model = get_model(cfg)
    logits, aux = model.forward(params, cfg, batch)
    targets = batch["targets"]
    # frontend positions (vision patches) carry no LM loss: logits for the
    # prepended P embeddings are sliced off.
    if logits.shape[1] != targets.shape[1]:
        logits = logits[:, logits.shape[1] - targets.shape[1]:]
    logits_f = logits.float()
    logz = torch.logsumexp(logits_f, dim=-1)
    tgt_logit = torch.gather(logits_f, -1, targets[..., None])[..., 0]
    nll = (logz - tgt_logit).mean()
    zl = train_cfg.z_loss * (logz**2).mean()
    loss = nll + aux + zl
    return loss, {"nll": nll, "aux": aux, "z_loss": zl}


def train_state_init(gen: torch.Generator, cfg: ModelConfig, train_cfg: TrainConfig):
    """Random params from ``gen`` and a fresh AdamW state, on ``gen``'s device."""
    params = get_model(cfg).init(gen, cfg)
    return {"params": params, "opt": adamw_init(train_cfg.optimizer, params)}


def make_train_step(
    cfg: ModelConfig, train_cfg: TrainConfig
) -> Callable[[Dict, Dict[str, torch.Tensor]], Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch) -> (state, metrics); ``state`` is
    updated in place and returned."""

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, batch, train_cfg)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(live, grads)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        mb = train_cfg.microbatches
        if mb == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            bsz = batch["tokens"].shape[0]

            def split(k, v):
                if k == "mrope_positions":  # (3, B, S): batch on axis 1
                    return v.reshape(v.shape[0], mb, bsz // mb, *v.shape[2:]).movedim(1, 0)
                return v.reshape(mb, bsz // mb, *v.shape[1:])

            split_keys = [
                k for k, v in batch.items() if (v.shape[0] == bsz or k == "mrope_positions")
            ]
            static = {k: v for k, v in batch.items() if k not in split_keys}
            stacked = {k: split(k, batch[k]) for k in split_keys}
            acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             params)
            acc_l = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(mb):
                full = dict(static)
                full.update({k: v[i] for k, v in stacked.items()})
                loss, metrics, grads = grads_of(params, full)
                for a, g in zip(tree_leaves(acc_g), tree_leaves(grads)):
                    a.add_(g.float())
                acc_l = acc_l + loss
                del grads
            for a in tree_leaves(acc_g):
                a.div_(mb)
            grads, loss = acc_g, acc_l / mb

        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        adamw_update(train_cfg.optimizer, grads, params, opt)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step
