"""Feed-forward variants (SwiGLU, squared-ReLU, GeLU) and MoE.

PyTorch counterpart of the JAX package's ``models/mlp.py``.  The MoE layer
dispatches by capacity as the reference does: each token picks its top-k
experts, its slot in an expert's buffer comes from a one-hot cumsum over
the tokens of its group, and choices past ``capacity_of`` are dropped
(Switch/GShard).  The expert products are batched GEMMs over the
``(E, G * C, D)`` buffer, as the reference's einsums are; no hand-written
kernel runs here.

Three choices keep the port's routing equal to the reference's:

* the top-k takes ties lowest index first, as ``jax.lax.top_k`` does
  (``torch.topk`` orders ties otherwise), through a stable descending sort
  (ROADMAP D10);
* the routing arithmetic (router logits, softmax, the gates'
  renormalisation, the Switch aux loss, the group-local cumsum) and the
  gate-weighted combine run in f32, as there;
* the reference scatters into the buffer with ``.at[].add(mode="drop")``;
  kept choices have unique ``(expert, slot)`` pairs and dropped ones add
  zeros, so the port writes the kept rows with a plain indexed write and
  sends every dropped choice to one spare slot past the buffer's end,
  which nothing reads (no atomics, no host read of the kept count; ROADMAP
  D11).

The reference's ``moe_ffn_sharded`` (``REPRO_MOE_SHARDMAP``, expert
parallelism under ``shard_map``) has no counterpart: it runs only under a
device mesh, and on one card it is this function.  The sharding hints
(``constrain``) have no counterpart on one card and are dropped.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, trunc_normal_


def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int, dtype) -> Dict:
    d = cfg.d_model
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d, d_ff, dtype),
            "w_up": dense_init(gen, d, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d, dtype),
        }
    return {
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = x @ p["w_up"]
        if cfg.mlp_type == "squared_relu":  # nemotron-4
            r = F.relu(u.float())
            h = (r * r).to(x.dtype)
        else:  # gelu; jax.nn.gelu is the tanh approximation
            h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def _expert_init(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return trunc_normal_(w, gen).mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": _expert_init(gen, (e, d, ff), d, dtype),
        "w_up": _expert_init(gen, (e, d, ff), d, dtype),
        "w_down": _expert_init(gen, (e, ff, d), ff, dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(gen, cfg, cfg.moe_d_ff * cfg.num_shared_experts, dtype)
    return p


def capacity_of(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(
        math.ceil(num_tokens * cfg.num_experts_per_token / cfg.num_experts * cfg.capacity_factor)
    )
    return max(8, (cap + 7) // 8 * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, descending, ties
    lowest index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(cfg: ModelConfig, probs: torch.Tensor, groups: int) -> Dict[str, torch.Tensor]:
    """Routing of ``T`` tokens from their f32 router probabilities ``probs``
    (T, E): the renormalised ``gates`` and ``experts`` (T, k), each
    choice's slot ``pos`` in its expert's buffer of its group and ``keep``
    (G, T/G * k) in group-major token order, the group capacity
    ``capacity`` and the Switch ``aux`` loss."""
    t, e = probs.shape
    k = cfg.num_experts_per_token
    gates, experts = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    tg = t // groups
    capacity = capacity_of(cfg, tg)
    flat_e = experts.reshape(groups, tg * k)  # group-major token order
    # (G, Tg*k, E); a compare, not F.one_hot, which may read its input's range back
    onehot = (flat_e[..., None] == torch.arange(e, device=probs.device)).long()
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat_e[..., None])[..., 0]

    # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
    token_frac = onehot.sum(dim=(0, 1)).float() / (t * k)
    aux = cfg.router_aux_coef * e * torch.sum(token_frac * probs.mean(dim=0))
    return dict(gates=gates, experts=experts, pos=pos, keep=pos < capacity, capacity=capacity,
                aux=aux)


def _experts(p: Dict, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """The expert FFNs on their buffers ``(E, N, D)``, batched over E."""
    if cfg.mlp_type == "swiglu":
        g = torch.bmm(buf, p["w_gate"])
        u = torch.bmm(buf, p["w_up"])
        h = F.silu(g.float()).to(buf.dtype) * u
        del g, u
    else:
        u = torch.bmm(buf, p["w_up"])
        h = F.gelu(u.float(), approximate="tanh").to(buf.dtype)
        del u
    return torch.bmm(h, p["w_down"])


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_token
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"]  # (T, E) f32

    if os.environ.get("REPRO_ABLATE_MOE") == "1":
        # profiling bisection knob: router only, zero expert compute
        return torch.zeros_like(x), 1e-9 * logits.sum()

    # group-local dispatch: REPRO_MOE_GROUPS groups of tokens, each with its
    # own slots (the reference's launcher sets it to the data-parallel size;
    # 1 where it does not divide the tokens)
    groups = int(os.environ.get("REPRO_MOE_GROUPS", "1"))
    if t % groups != 0:
        groups = 1
    r = moe_route(cfg, torch.softmax(logits, dim=-1), groups)
    cap, keep = r["capacity"], r["keep"].reshape(-1)
    n = groups * cap
    # slot of each choice in the (E, G*C) buffer; dropped choices go to the
    # spare slot n, which the experts never read
    slot = (torch.arange(groups, device=x.device)[:, None] * cap + r["pos"]).reshape(-1)
    slot = torch.where(keep, slot, n)
    flat_e = r["experts"].reshape(-1)
    token = torch.arange(t * k, device=x.device) // k  # the row of xt each choice carries
    buf = torch.zeros((e, n + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, slot), xt[token])
    out_buf = _experts(p, cfg, buf[:, :n])
    del buf

    gathered = out_buf[flat_e, torch.where(keep, slot, 0)]  # (T*k, D)
    del out_buf
    gathered = torch.where(keep[:, None], gathered, 0)
    out = (
        (gathered.float() * r["gates"].reshape(-1)[:, None])
        .reshape(t, k, d)
        .sum(dim=1)
        .to(x.dtype)
    )
    if cfg.num_shared_experts:
        out = out + ffn(p["shared"], cfg, xt)
    return out.reshape(b, s, d), r["aux"]
