"""Carry parameters made by the JAX package into the port.

``params_from_jax(tree, cfg, device)`` takes the JAX params pytree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's params dict: the same nested keys and layouts, with the leading
L axis of ``tree["layers"]`` (the encoder-decoder's ``enc_layers`` and
``dec_layers``, of ``cfg.encoder_layers`` and ``cfg.num_layers``) un-stacked
into a list of per-layer dicts.
Every leaf keeps its dtype, so a MoE layer's ``moe`` dict arrives with its
f32 router, its experts stacked on E and its ``shared`` FFN, an MLA layer's
``attn`` with its latent projections and ``kv_norm``, and an SSM layer's
``mamba`` dict with its f32 ``a_log``, ``d_skip`` and ``dt_bias``.  Every
other top-level entry — the hybrid's weight-shared block ``shared_attn``
among them — is not stacked and carries across as it is.
``train_state_from_jax(tree, cfg, device)`` does the same for a training
state ``{"params", "opt": {"m", "v", "step"}}``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch, bfloat16 included.  ``np.asarray`` of a JAX bf16 array
    has the ``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` does
    not take; its bits go across as uint16 and are viewed as bf16."""
    a = np.array(a, copy=True)  # writable and contiguous, as torch wants
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict, cfg: ModelConfig, device) -> Dict:
    stacked = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers,
               "dec_layers": cfg.num_layers}
    out = {}
    for k, v in tree.items():
        if k in stacked:
            out[k] = [_map(v, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device))
                      for i in range(stacked[k])]
        else:
            out[k] = _map(v, lambda a: tensor_from_numpy(a, device))
    return out


def train_state_from_jax(tree: Dict, cfg: ModelConfig, device) -> Dict:
    """The JAX package's train state (leaves as numpy arrays) as the port's:
    params and both moments un-stacked, ``step`` a 0-d int32 tensor."""
    opt = tree["opt"]
    return {
        "params": params_from_jax(tree["params"], cfg, device),
        "opt": {
            "m": params_from_jax(opt["m"], cfg, device),
            "v": params_from_jax(opt["v"], cfg, device),
            "step": tensor_from_numpy(np.asarray(opt["step"], np.int32), device),
        },
    }
