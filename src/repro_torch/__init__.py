"""PyTorch/CUDA port of the Tesserae reproduction (``repro``).

The port mirrors the JAX package module for module and never imports it.
It carries the Tesserae round: ``core.simulator.Simulator`` ->
``core.scheduler.TesseraeScheduler.decide`` -> policy sort, placement,
packing (Algorithm 4) and migration planning (Algorithms 2+3) through the
batched matching engine, with the auction's bid top-2 and the Algorithm-3
cost matrix on hand-written CUDA kernels (``kernels/``), and the fused
migrate stage.  The workload substrate's serving path is here too: the
dense GQA transformer (``models/``, ``configs/``), ``serve/`` and
``launch/serve.py``, with the flash attention and flash decoding kernels.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
