"""The remat (activation checkpointing) policy of the layer stack.

PyTorch counterpart of the JAX package's ``models/scan_util.py``.  There the
layer body is ``lax.scan``-ed under ``jax.checkpoint`` with the policy of
``remat_policy()``; here the layers are a Python loop and each layer runs
through :func:`remat` while autograd records:

    REPRO_REMAT_POLICY = "nothing" (the default: keep each layer's input and
    recompute the rest in the backward) | "dots" (also keep the outputs of
    the dense products with no batch dims, the weight matmuls — a cheaper
    backward at higher live memory)

The reference's unroll knobs (``REPRO_UNROLL_LAYERS``, ``REPRO_UNROLL_MB``)
only feed XLA's cost analysis for the dry-run, which counts a ``while`` body
once.  The port's dry-run (``launch/dryrun.py``) counts the eager loops
whole, every layer and every microbatch, so they have no counterpart here
(ROADMAP D9, closed).
"""

from __future__ import annotations

import functools
import os

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

#: the products ``"dots"`` saves: the 2-D weight matmuls (``x @ W`` lowers
#: to these), not the batched attention einsums (``bmm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy() -> str:
    """``"dots"`` or ``"nothing"``, from ``REPRO_REMAT_POLICY`` (read at
    every call, as the reference reads it at trace time)."""
    return "dots" if os.environ.get("REPRO_REMAT_POLICY", "nothing") == "dots" else "nothing"


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args):
    """``fn(*args)`` under the remat policy: non-reentrant checkpointing of
    the whole call (``"nothing"``), or selective checkpointing that keeps
    the weight matmuls' outputs (``"dots"``)."""
    if remat_policy() == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
    return checkpoint(fn, *args, use_reentrant=False)
