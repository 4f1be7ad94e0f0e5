"""The port on the card: CUDA kernels against their plain versions, and the
Tesserae round on CUDA against the same round on the CPU.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time).  This file imports neither JAX nor the JAX
package, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CPU side of each comparison is held against the JAX package by the
other ``test_torch_*`` files, so equality here closes the chain
card == CPU port == JAX reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.policies import TiresiasPolicy
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.scheduler import TesseraeScheduler
from repro_torch.core.traces import synthetic_active_jobs
from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_top2_plain
from repro_torch.kernels.migration_cost import migration_cost, migration_cost_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _bid_inputs(seed, shape, ints=True):
    g = torch.Generator().manual_seed(seed)
    if ints:
        a = torch.randint(-20, 20, shape, generator=g).float()
    else:
        a = torch.randn(shape, generator=g)
    return a, torch.randint(0, 4, (shape[0], shape[2]), generator=g).float()


@pytest.mark.parametrize(
    "shape,ints",
    [((4096, 4, 4), True), ((1, 512, 512), True), ((3, 5, 7), False),
     ((2, 6, 700), True), ((5, 3, 1), True), ((2, 9, 33), False)],
)
def test_lap_bid_kernel_matches_plain(cuda, shape, ints):
    a, p = _bid_inputs(sum(shape), shape, ints)
    a[0, 0, : min(3, shape[2])] = 99.0  # a tie at the row's start
    before = lap_bid_batched.launches
    got = lap_bid_batched(a.to(cuda), p.to(cuda))
    torch.cuda.synchronize()
    assert lap_bid_batched.launches == before + 1
    for w, g in zip(lap_bid_top2_plain(a, p), got):
        assert torch.equal(w, g.cpu())


def test_lap_bid_kernel_ties_across_warp_stride(cuda):
    a = torch.full((1, 4, 700), -5.0)
    a[0, 0, [31, 32]] = 7.0
    a[0, 1, [5, 37, 69]] = 7.0
    a[0, 2, [100, 600]] = 7.0
    a[0, 3, :] = 1.0
    p = torch.zeros(1, 700)
    best_v, best_j, second = lap_bid_batched(a.to(cuda), p.to(cuda))
    assert best_j.cpu().tolist() == [[31, 5, 100, 0]]
    assert torch.equal(second.cpu(), best_v.cpu())


@pytest.mark.parametrize("u,v", [(2048, 2048), (300, 257), (1, 5)])
def test_migration_cost_kernel_bit_identical(cuda, u, v):
    g = torch.Generator().manual_seed(u + v)
    su = torch.randint(-1, 40, (u, 2), generator=g, dtype=torch.int32)
    sv = torch.randint(-1, 40, (v, 2), generator=g, dtype=torch.int32)
    w = torch.tensor([0.5, 0.25, 0.125, 0.0625], dtype=torch.float64)
    wu = torch.where(su < 0, 0.0, w[su.clamp_min(0) % 4])
    wv = torch.where(sv < 0, 0.0, w[sv.clamp_min(0) % 4])
    before = migration_cost.launches
    got = migration_cost(su.to(cuda), sv.to(cuda), wu.to(cuda), wv.to(cuda)).cpu()
    assert migration_cost.launches == before + 1
    want = migration_cost_plain(su, sv, wu, wv)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def _decide_rounds(device, backend):
    prof = ThroughputProfile()
    sched = TesseraeScheduler(
        ClusterSpec(8, 4), TiresiasPolicy(prof), prof, lap_backend=backend, device=device
    )
    jobs = synthetic_active_jobs(40, seed=2, profile=prof)
    d1 = sched.decide(jobs, now=0.0)
    d2 = sched.decide(jobs[::2] + jobs[1::4], now=360.0, prev_plan=d1.plan)
    d3 = sched.decide(jobs[1::2], now=720.0, prev_plan=d2.plan)
    return [d1, d2, d3]


@pytest.mark.parametrize("backend", ["auction_kernel", "auction"])
def test_decide_on_card_equals_cpu(cuda, backend):
    before = (lap_bid_batched.launches, migration_cost.launches)
    on_card = _decide_rounds(cuda, backend)
    if backend == "auction_kernel":
        assert lap_bid_batched.launches > before[0]
    assert migration_cost.launches > before[1]
    on_cpu = _decide_rounds("cpu", backend)
    for dg, dc in zip(on_card, on_cpu):
        np.testing.assert_array_equal(dg.plan.slots, dc.plan.slots)
        assert dg.packing.matches == dc.packing.matches
        assert dg.match_stats == dc.match_stats
        if dc.migration is not None:
            assert dg.migration.matching_cost == dc.migration.matching_cost
