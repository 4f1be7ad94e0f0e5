"""Deterministic synthetic data pipeline.

The JAX package's ``train/data.py``, kept as the port's own copy (the port
imports nothing of the JAX package): numpy only, so a batch is the same
bytes in both packages.  Token streams come from a seeded numpy generator,
so runs are reproducible, shardable (each data shard derives its slice
from the global batch index), and free of filesystem dependencies.  A
light Markov-ish structure (token t+1 correlates with token t) makes the
LM loss actually decrease during training runs instead of plateauing at
log(V) immediately.  :func:`to_device` puts a batch on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    #: mixing weight of the structured (learnable) component
    structure: float = 0.75


class SyntheticTokens:
    """Iterator of {"tokens", "targets"} numpy batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table: next-token distribution per token (top-8)
        self._succ = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, 8), dtype=np.int32
        )
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self._step))
        self._step += 1
        b, s = cfg.batch_size, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        structured = rng.random((b, s)) < cfg.structure
        picks = rng.integers(0, 8, size=(b, s))
        randoms = rng.integers(0, cfg.vocab_size, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], picks[:, t]]
            toks[:, t + 1] = np.where(structured[:, t], nxt, randoms[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def batch_for(
    cfg_vocab: int,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    step: int = 0,
    frontend: Optional[str] = None,
    frontend_len: int = 0,
    d_model: int = 0,
) -> Dict[str, np.ndarray]:
    """One batch including frontend stubs (vision patches / audio frames)."""
    it = SyntheticTokens(DataConfig(cfg_vocab, batch_size, seq_len, seed))
    it._step = step
    batch = dict(next(it))
    rng = np.random.default_rng((seed, step, 7))
    if frontend == "vision":
        batch["image_embeds"] = rng.normal(
            size=(batch_size, frontend_len, d_model)
        ).astype(np.float32) * 0.02
    elif frontend == "audio":
        batch["audio_frames"] = rng.normal(
            size=(batch_size, frontend_len, d_model)
        ).astype(np.float32) * 0.02
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``: integer arrays (tokens, targets,
    positions) as int64, the indices torch's gathers take; float arrays
    (frontend stubs) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out
