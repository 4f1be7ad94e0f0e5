"""Checkpointing: flat-npz save/restore for params + optimizer state.

PyTorch counterpart of the JAX package's ``train/checkpoint.py``, in the
JAX package's file format, so a file written by either package restores in
the other.  The migration overheads Tesserae minimises (Fig. 3) are
checkpoint-save + checkpoint-load + warmup; this module is the port's
implementation of that path.

Format: one ``.npz`` with ``/``-joined key paths (``params/layers/attn/wq``,
``opt/m/embed``, ``opt/step``), plus a JSON sidecar ``<path>.meta.json``
for the step and metadata.  The port keeps the layers as a list of
per-layer dicts; in the file each of their leaves is one array with the
layer axis first, as the JAX package stacks it.  bf16 leaves are stored as
f32 under ``<key>::bf16``.

Two differences of form.  :func:`save_checkpoint` writes the archive one
leaf at a time (what ``np.savez`` writes, without holding every array on
the host at once), and :func:`restore_checkpoint` copies the file into the
template's tensors instead of allocating a second state.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """(key, leaf) pairs of ``tree``; for a list of per-layer dicts the leaf
    is the list of that key's per-layer tensors, in layer order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        per_layer = [list(_flatten(t, prefix)) for t in tree]
        for items in zip(*per_layer):
            yield items[0][0], [leaf for _, leaf in items]
    else:
        yield prefix[:-1], tree


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: Any, step: int, metadata: Dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(_npz(path), mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _flatten(state):
            t = torch.stack(leaf) if isinstance(leaf, list) else leaf
            if t.dtype == torch.bfloat16:
                key, t = key + "::bf16", t.float()
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, t.cpu().numpy(), allow_pickle=False)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)


def restore_checkpoint(path: str, state_template: Any) -> Tuple[Any, int]:
    """Restore into ``state_template``'s tensors, in place, and return it
    with the step.  Every leaf must have the template's shape (a stacked
    leaf: the number of layers first); a mismatch raises ``ValueError``,
    possibly after earlier leaves were written.  A ``::bf16`` leaf takes the
    template's dtype, which is bf16 wherever the file came from a state of
    the same configuration."""
    with np.load(_npz(path)) as data:
        for key, leaf in _flatten(state_template):
            arr = data[key + "::bf16"] if key + "::bf16" in data else data[key]
            want = (len(leaf), *leaf[0].shape) if isinstance(leaf, list) else tuple(leaf.shape)
            if arr.shape != want:
                raise ValueError(f"checkpoint leaf {key}: {arr.shape} != {want}")
            src = torch.from_numpy(arr)
            with torch.no_grad():
                if isinstance(leaf, list):
                    for dst, s in zip(leaf, src):
                        dst.copy_(s)
                else:
                    leaf.copy_(src)
    meta_path = path + ".meta.json"  # same rule as save_checkpoint
    step = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step", 0)
    return state_template, step
