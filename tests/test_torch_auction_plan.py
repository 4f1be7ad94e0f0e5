"""The whole-auction kernel's launch plan, wrapper checks and plain loop, on
the CPU.

Everything ``lap_auction`` decides in Python before a launch — the regime
(one lane group per instance, or a thread-block cluster per instance), the
cluster size, the band of rows per CTA, the shared memory per CTA and
whether the rows sit in it or are read from L2 — is held here on a host
without a card, and against the constants of ``csrc/lap_auction.cu``
(whose C entry checks the plan again at launch).  The plain loop is held
against the step-by-step oracle ``ref.lap_auction``; the kernel itself is
held against the plain loop in ``test_torch_cuda.py``, and the plain loop
against JAX in ``test_torch_auction.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import lap_auction as la
from repro_torch.kernels import ops, ref
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(la.__file__).resolve().parent / "csrc" / "lap_auction.cu"
LIMIT = 232_448  # shared memory one block may use on an H100


# --------------------------------------------------------------------------- #
# the launch plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "shape,regime,group,cluster,rows,smem_rows",
    [
        ((262144, 4, 4), "warp", 4, 0, 0, False),
        ((4096, 8, 8), "warp", 8, 0, 0, False),
        ((3, 1, 1), "warp", 1, 0, 0, False),
        ((2, 31, 31), "warp", 32, 0, 0, False),
        ((2, 32, 32), "warp", 32, 0, 0, False),
        ((2, 33, 33), "cluster", 0, 2, 17, True),
        ((1, 8, 600), "cluster", 0, 1, 8, True),
        ((1, 512, 512), "cluster", 0, 16, 32, True),
        ((1, 640, 1320), "cluster", 0, 16, 40, False),
    ],
)
def test_plan_regime_cluster_and_rows(shape, regime, group, cluster, rows, smem_rows):
    plan = la.launch_plan(*shape)
    assert (plan.regime, plan.group, plan.cluster, plan.rows_per_cta, plan.smem_rows) == (
        regime, group, cluster, rows, smem_rows)
    b, n, m = shape
    if regime == "warp":
        assert plan.threads == la.WARP_THREADS and plan.smem == 0
        assert plan.grid * plan.threads >= b * group > (plan.grid - 1) * plan.threads
    else:
        assert plan.threads == la.CLUSTER_THREADS and plan.grid == b * cluster
        assert plan.rows_per_cta * cluster >= n > plan.rows_per_cta * (cluster - 1)
        assert plan.smem == la.cluster_smem(m, rows, smem_rows)


def test_plan_shared_memory_of_the_main_path_shapes():
    """512x512: the 32-row band (64 KiB) beside the replicated state; the
    640x1320 packing rectangle's band (206 KiB) does not fit and is read
    from L2."""
    node = la.launch_plan(1, 512, 512)
    assert node.smem == 40 * 512 + 8 * 32 + 4 * 32 * 512 == 86272
    pack = la.launch_plan(1, 640, 1320)
    assert la.cluster_smem(1320, 40, True) > la.SMEM_BUDGET
    assert pack.smem == 40 * 1320 + 8 * 40 == 53120


@pytest.mark.parametrize("n", [33, 64, 100, 255, 256, 512, 700, 1000, 2048])
@pytest.mark.parametrize("extra", [0, 1, 700])
def test_plan_shared_memory_within_a_block(n, extra):
    plan = la.launch_plan(1, n, n + extra)
    assert plan.regime == "cluster" and plan.smem <= la.SMEM_BUDGET < LIMIT
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.rows_per_cta <= max(la.ROWS_PER_CTA, -(-n // la.MAX_CLUSTER))


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n <= m"):
        la.launch_plan(2, 5, 4)
    with pytest.raises(ValueError, match="shared memory"):
        la.launch_plan(1, 8, 6000)
    assert la.launch_plan(1, 8, 5700).regime == "cluster"


def test_plan_constants_match_the_cuda_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert const("kWarpThreads") == la.WARP_THREADS
    assert const("kClusterThreads") == la.CLUSTER_THREADS
    assert const("kMaxCluster") == la.MAX_CLUSTER
    assert "return 40 * m + 8 * rows + (smem_rows ? 4 * rows * m : 0);" in src
    assert re.search(r"kBidFloor = -5e17f", src) and la.BID_FLOOR == -5e17


# --------------------------------------------------------------------------- #
# the wrapper's checks (CPU tensors run the plain loop, so these raise first)
# --------------------------------------------------------------------------- #
def _start(b, n, m, seed=0, lo=-20, hi=20):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(lo, hi, (b, n, m), generator=g).float()
    eps_min = torch.full((b,), 1.0 / (n + 1))
    thr = eps_min * np.float32(1 + 1e-6)
    eps0 = torch.maximum(torch.clamp_min(a.abs().amax(dim=(1, 2)), 1.0) / 4.0, eps_min)
    return a, torch.zeros(b, m), torch.full((b, n), -1), eps0, eps_min, thr


def test_wrapper_rejects_bad_operands():
    a, p, c, e, em, thr = _start(2, 3, 4)
    with pytest.raises(ValueError, match="prices"):
        la.lap_auction(a, p[:, :3], c, e, em, thr, 10)
    with pytest.raises(ValueError, match="col_of"):
        la.lap_auction(a, p, c.float(), e, em, thr, 10)
    with pytest.raises(ValueError, match="thr"):
        la.lap_auction(a, p, c, e, em, thr[:1], 10)
    with pytest.raises(ValueError, match="tb"):
        la.lap_auction(a, p, c, e, em, thr, 10, tb=torch.zeros(3))
    with pytest.raises(ValueError, match="float32"):
        la.lap_auction(a.double(), p, c, e, em, thr, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        la.lap_auction(*(t.to("meta") for t in (a, p, c, e, em, thr)), 10)


def test_cpu_tensors_take_the_plain_loop_and_launch_nothing():
    args = _start(3, 5, 5)
    before = la.lap_auction.launches
    got = la.lap_auction(*args, 20_000)
    want = la.lap_auction_plain(*args, 20_000)
    assert la.lap_auction.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ops_lap_auction_takes_one_instance_or_a_batch():
    a, p, c, e, em, thr = _start(3, 4, 6)
    batched = ops.lap_auction(a, p, c, e, em, float("inf"), 20_000)
    for k in range(3):
        single = ops.lap_auction(a[k], p[k], c[k], e[k], em[k], float("inf"), 20_000)
        for s, b in zip(single, batched):
            assert torch.equal(s, b[k])


# --------------------------------------------------------------------------- #
# the plain loop against the step-by-step oracle
# --------------------------------------------------------------------------- #
def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("neg", [-1e30, -1e18])
@pytest.mark.parametrize("shape", [(4, 5, 5), (3, 1, 1), (3, 4, 9), (2, 8, 8)])
@pytest.mark.parametrize("max_iters", [3, 20_000])
def test_plain_loop_matches_the_oracle(neg, shape, max_iters):
    b, n, m = shape
    a, p, c, e, em, thr = _start(b, n, m, seed=sum(shape), lo=0, hi=4)  # many ties
    if n < m:  # the rectangular auction: one phase at eps_min
        e, thr = em, torch.full((b,), float("inf"))
    got = la.lap_auction_plain(a, p, c, e, em, thr, max_iters, neg=neg)
    want = ref.lap_auction(a, p, c, e, em, thr, max_iters, neg=neg)
    _same(got, want)


def test_plain_loop_warm_and_complete_starts_match_the_oracle():
    a, p, c, e, em, thr = _start(4, 6, 6, seed=3)
    cold = la.lap_auction_plain(a, p, c, e, em, thr, 20_000)
    a2 = a + torch.randint(-2, 3, a.shape, generator=torch.Generator().manual_seed(4)).float()
    warm_eps = torch.where(torch.arange(4) % 2 == 0, em, e)
    for start in (c, cold[0]):  # unassigned, then complete
        got = la.lap_auction_plain(a2, cold[1], start, warm_eps, em, thr, 20_000)
        _same(got, ref.lap_auction(a2, cold[1], start, warm_eps, em, thr, 20_000))
    assert got[2][::2].eq(0).all() and got[2][1::2].gt(0).all()


def test_plain_loop_fused_assembly_is_the_bid_kernels():
    """``tb`` assembles ``(tb * (i+1)^2) * (j+1) - cost`` in the fused bid
    kernel's order (the oracle ``ref.lap_bid_fused_top2``'s)."""
    from repro_torch.kernels.lap_bid import lap_bid_top2_plain

    g = torch.Generator().manual_seed(5)
    cost = torch.randn((3, 4, 4), generator=g) * 3.0
    tb = torch.tensor([0.0, 2.0**-9, 2.0**-7])
    p = torch.randn((3, 4), generator=g)
    _same(lap_bid_top2_plain(la.fused_benefit(cost, tb), p), ref.lap_bid_fused_top2(cost, p, tb))
    _, _, c, e, em, thr = _start(3, 4, 4)
    got = la.lap_auction_plain(cost, p, c, e, em, thr, 20_000, tb=tb)
    _same(got, ref.lap_auction(la.fused_benefit(cost, tb), p, c, e, em, thr, 20_000))
