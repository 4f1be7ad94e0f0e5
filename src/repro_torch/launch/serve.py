"""Serving launcher: batched greedy decoding on a reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 16 --gen 32 [--device cpu]

Every decoder family runs: dense GQA, MoE (``--arch dbrx-132b``), MLA + MoE
(``--arch deepseek-v2-236b``), the Mamba-2 SSM (``--arch mamba2-780m``,
whose cache is the recurrent state), the SSM + shared-attention hybrid
(``--arch zamba2-2.7b``) and the encoder-decoder (``--arch
seamless-m4t-medium``, which decodes against zero cross K/V, as the JAX
package's ``greedy_generate`` does: ROADMAP D15).  Runs on CUDA unless
``--device cpu`` is given; the weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` on the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve.engine import ServeConfig, greedy_generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), cfg)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    ).to(device)
    sc = ServeConfig(batch_size=args.batch, context_len=args.context)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, args.gen, sc)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.gen
    print(f"arch={cfg.name} generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, {device.type} reduced config)")
    print("sample:", out[0, : args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
