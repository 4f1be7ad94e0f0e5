"""The paper's evaluation harness on the port.

The port's own copies of the JAX repo's ``benchmarks/`` scripts, run as
modules of this package so that they import ``repro_torch`` and never the
JAX package:

* :mod:`repro_torch.benchmarks.common` — the named scheduler
  configurations of §6.1 (``build_scheduler``), ``simulate``, ``timed``;
* :mod:`repro_torch.benchmarks.evaluate` — the end-to-end policy sweep
  ({policy x scenario}), whose document has ``BENCH_endtoend.json``'s
  schema: ``python -m repro_torch.benchmarks.evaluate [--device cpu]
  [--smoke | --chaos]``;
* :mod:`repro_torch.benchmarks.scalability` — Fig. 2 / 14(a), decision
  time against active jobs and the "< 1.6 s at 2048 jobs" claim, plus the
  cluster-scale sweep per matching backend: ``python -m
  repro_torch.benchmarks.scalability``.

Each takes a ``device`` (``--device``): the card unless the caller asks
for the CPU.
"""
