"""Batched decode serving.

PyTorch counterpart of the JAX package's ``serve/engine.py``.
``make_serve_step`` is the step a server runs: ONE new token per sequence
against a cache of ``cache_len`` positions (a ring buffer of the window
length for sliding-window archs).  ``greedy_generate`` prefills by stepping
the prompt token by token, exactly as the reference does, then decodes
greedily; the argmax stays on the device.  A step runs whatever layers the
model has (GQA or MLA attention, a dense or MoE feed-forward, Mamba-2
layers with their recurrent state, the hybrid's shared block with one
full-context GQA cache per application, the encoder-decoder's decoder
with its cross-attention): a MoE step
routes its B tokens with a capacity of ``capacity_of(cfg, B)``, as the
reference's decode step does, so stepped logits equal a full forward's
only where no expert overflows in either.  Like the reference's,
``greedy_generate`` never calls the encoder-decoder's ``prefill_cross``:
its steps attend to the zero cross K/V of ``init_cache``, which is the
forward on zero audio frames (ROADMAP D15).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int
    #: logical context length the service promises
    context_len: int

    def cache_len(self, cfg: ModelConfig) -> int:
        """Physical cache length: full context, or the attention window for
        sliding-window archs (the sub-quadratic long_500k path)."""
        if cfg.arch_type in ("ssm",):
            return 1  # recurrent state only; no positional cache
        if cfg.attention_window and cfg.attention_window < self.context_len:
            return cfg.attention_window
        return self.context_len


def init_serving_cache(cfg: ModelConfig, serve_cfg: ServeConfig, device):
    model = get_model(cfg)
    return model.init_cache(cfg, serve_cfg.batch_size, serve_cfg.cache_len(cfg), device)


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, tokens (B,1), cache, pos) -> (logits, cache); the
    cache is updated in place."""
    model = get_model(cfg)

    def serve_step(params, tokens, cache, pos):
        return model.decode_step(params, cfg, {"tokens": tokens}, cache, pos)

    return serve_step


def greedy_generate(
    params,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # (B, P) int, on the params' device
    num_tokens: int,
    serve_cfg: ServeConfig,
    return_logits: bool = False,
):
    """Prefill by stepping the prompt, then greedy-decode ``num_tokens``.

    Returns the tokens (B, P + num_tokens) in the prompt's dtype; with
    ``return_logits`` also every step's logits (B, P + num_tokens - 1, V),
    step i's logits being the prediction for position i + 1."""
    step = make_serve_step(cfg)
    cache = init_serving_cache(cfg, serve_cfg, prompt.device)
    p = prompt.shape[1]
    tok = prompt[:, :1]
    out = [prompt]
    logits_all = []
    for i in range(p + num_tokens - 1):
        if i < p:
            tok = prompt[:, i : i + 1]
        logits, cache = step(params, tok, cache, i)
        if return_logits:
            logits_all.append(logits)
        if i >= p - 1:
            tok = torch.argmax(logits[:, -1:, :], dim=-1).to(prompt.dtype)
            out.append(tok)
    tokens = torch.cat(out, dim=1)
    if return_logits:
        return tokens, torch.cat(logits_all, dim=1)
    return tokens
