"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions (and the oracles in ``repro_torch.kernels.ref``)
against the Pallas kernels run in interpret mode and against the numpy host
computation.  The CUDA kernels themselves are held against the plain
versions in ``test_torch_cuda.py``, which needs a card.  Also here: the
guard that the port imports neither JAX nor the JAX package.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fused import _tb_scale as jax_tb_scale
from repro.core.migration import _weight_lookup as jax_weight_lookup
from repro.core.migration import pairwise_migration_cost
from repro.kernels import ref as jax_ref
from repro.kernels.lap_bid import (
    lap_bid_fused_pallas,
    lap_bid_fused_pallas_batched,
    lap_bid_pallas,
    lap_bid_pallas_batched,
)
from repro.kernels.migration_cost import migration_cost_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lap_bid import (
    lap_bid_batched,
    lap_bid_fused_batched,
    lap_bid_fused_top2_plain,
    lap_bid_top2_plain,
)
from repro_torch.kernels.migration_cost import migration_cost
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------- #
# lap_bid
# --------------------------------------------------------------------------- #
def _bid_case(name):
    """(a (B, n, m), prices (B, m)) f32 cases of the bid top-2."""
    rng = np.random.default_rng(BID_CASES.index(name))
    if name == "ragged":
        a = rng.integers(-9, 9, size=(1, 5, 7)).astype(np.float32)
        p = rng.integers(0, 4, size=(1, 7)).astype(np.float32)
    elif name == "batched_small":
        a = rng.normal(size=(6, 4, 4)).astype(np.float32)
        p = rng.normal(size=(6, 4)).astype(np.float32)
    elif name == "ties_tile_and_warp":
        # m > 512: duplicated maxima across the Pallas 512-column tile
        # boundary and across the kernel's 32-lane stride (fact F4)
        a = rng.integers(-50, 0, size=(3, 6, 700)).astype(np.float32)
        p = np.zeros((3, 700), np.float32)
        a[0, 0, [100, 600]] = 9.0  # across the 512 tile boundary
        a[0, 1, [31, 32]] = 9.0  # across a 32-lane stride boundary
        a[1, 2, [5, 37, 69]] = 9.0  # same lane, three strides apart
        a[1, 3, [511, 512]] = 9.0  # the tile edge itself
        a[2, 4, [0, 699]] = 9.0  # first and last column
        a[2, 5, :] = 1.0  # every column tied
    elif name == "rect_wide":
        a = rng.integers(-30, 30, size=(2, 3, 33)).astype(np.float32)
        p = rng.integers(0, 3, size=(2, 33)).astype(np.float32)
    else:
        raise KeyError(name)
    return a, p


BID_CASES = ["ragged", "batched_small", "ties_tile_and_warp", "rect_wide"]


def _assert_top2_equal(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("case", BID_CASES)
def test_lap_bid_plain_matches_pallas_batched(case):
    a, p = _bid_case(case)
    want = lap_bid_pallas_batched(jnp.asarray(a), jnp.asarray(p), interpret=True)
    got = lap_bid_batched(torch.from_numpy(a), torch.from_numpy(p))
    _assert_top2_equal(want, got)
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("case", BID_CASES)
def test_lap_bid_2d_matches_pallas(case):
    a, p = _bid_case(case)
    want = lap_bid_pallas(jnp.asarray(a[0]), jnp.asarray(p[0]), interpret=True)
    got = ops.lap_bid(torch.from_numpy(a[0]), torch.from_numpy(p[0]))
    _assert_top2_equal(want, got)


@pytest.mark.parametrize("case", BID_CASES)
def test_lap_bid_plain_matches_oracle(case):
    a, p = _bid_case(case)
    at, pt = torch.from_numpy(a), torch.from_numpy(p)
    want = ref.lap_bid_top2(at - pt[:, None, :])
    got = lap_bid_top2_plain(at, pt)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_lap_bid_single_column_second_is_neg_inf():
    a = torch.tensor([[[2.0], [-1.0]]])
    best_v, best_j, second = lap_bid_batched(a, torch.zeros(1, 1))
    want = lap_bid_pallas_batched(jnp.asarray(a.numpy()), jnp.zeros((1, 1)), interpret=True)
    _assert_top2_equal(want, (best_v, best_j, second))
    assert second.tolist() == [[np.float32(-1e30)] * 2]


def test_lap_bid_wrapper_rejects_bad_operands():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="float32"):
        lap_bid_batched(a.double(), torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="do not match"):
        lap_bid_batched(a, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        lap_bid_batched(a.to("meta"), torch.zeros(2, 4, device="meta"))


# --------------------------------------------------------------------------- #
# lap_bid_fused (cost in, benefit assembled per element)
# --------------------------------------------------------------------------- #
def _fused_case(name):
    """(cost (B, n, m), prices (B, m), tb (B,)) f32 cases of the fused bid."""
    rng = np.random.default_rng(100 + FUSED_CASES.index(name))
    tb4 = jax_tb_scale(4, 4)
    if name == "tb_zero":
        cost = rng.integers(0, 40, size=(5, 4, 4)).astype(np.float32)
        p = rng.integers(0, 6, size=(5, 4)).astype(np.float32)
        tb = np.zeros(5, np.float32)
    elif name == "tb_scale_mixed":
        # the fan-out's shape with per-instance scales: 0 and _tb_scale(4, 4)
        cost = rng.integers(0, 40, size=(6, 4, 4)).astype(np.float32)
        cost[:, :, 1] = cost[:, :, 0]  # ties that only the ramp breaks
        p = rng.integers(0, 6, size=(6, 4)).astype(np.float32)
        tb = np.where(np.arange(6) % 2 == 0, 0.0, tb4).astype(np.float32)
    elif name == "ragged_tile":
        # m > 512: a ragged Pallas tile, and a row count across its 8-row tile
        cost = rng.integers(0, 90, size=(2, 9, 700)).astype(np.float32)
        p = rng.integers(0, 3, size=(2, 700)).astype(np.float32)
        tb = np.array([0.0, jax_tb_scale(9, 700)], np.float32)
    elif name == "duplicate_maxima":
        cost = np.full((3, 6, 600), 50.0, np.float32)
        p = np.zeros((3, 600), np.float32)
        cost[0, 0, [100, 550]] = 1.0  # across the 512 tile boundary
        cost[0, 1, [31, 32]] = 1.0  # across a 32-lane stride boundary
        cost[1, 2, [5, 37, 69]] = 1.0  # same lane, three strides apart
        cost[1, 3, [511, 512]] = 1.0  # the tile edge itself
        cost[2, 4, [0, 599]] = 1.0  # first and last column
        cost[2, 5, :] = 7.0  # every column tied
        tb = np.zeros(3, np.float32)
    elif name == "single_column":
        cost = rng.integers(0, 9, size=(4, 3, 1)).astype(np.float32)
        p = rng.integers(0, 3, size=(4, 1)).astype(np.float32)
        tb = np.array([0.0, 0.5, 0.0, 0.25], np.float32)
    elif name == "non_integer":
        # outside the exact-integer regime the operation order still decides
        # every bit
        cost = rng.normal(scale=3.0, size=(4, 5, 5)).astype(np.float32)
        p = rng.normal(size=(4, 5)).astype(np.float32)
        tb = np.array([0.0, 0.125, 2.0 ** -9, 0.5], np.float32)
    else:
        raise KeyError(name)
    return cost, p, tb


FUSED_CASES = [
    "tb_zero", "tb_scale_mixed", "ragged_tile", "duplicate_maxima", "single_column",
    "non_integer",
]


def _assert_top2_bitwise(want, got):
    """Equal bit patterns (so -0.0 and +0.0 count as different)."""
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w.view(np.int32), g.view(np.int32))


@pytest.mark.parametrize("case", FUSED_CASES)
def test_lap_bid_fused_plain_matches_pallas_batched(case):
    cost, p, tb = _fused_case(case)
    want = lap_bid_fused_pallas_batched(
        jnp.asarray(cost), jnp.asarray(p), jnp.asarray(tb), interpret=True
    )
    got = lap_bid_fused_batched(torch.from_numpy(cost), torch.from_numpy(p), torch.from_numpy(tb))
    _assert_top2_bitwise(want, got)
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("case", FUSED_CASES)
def test_lap_bid_fused_2d_matches_pallas(case):
    """``ops.lap_bid_fused`` on one instance (K3) and on the batch with a
    per-instance ``tb`` (K4), each against its Pallas kernel."""
    cost, p, tb = _fused_case(case)
    for b in range(cost.shape[0]):
        want = lap_bid_fused_pallas(
            jnp.asarray(cost[b]), jnp.asarray(p[b]), float(tb[b]), interpret=True
        )
        got = ops.lap_bid_fused(torch.from_numpy(cost[b]), torch.from_numpy(p[b]), float(tb[b]))
        _assert_top2_bitwise(want, got)
    got = ops.lap_bid_fused(torch.from_numpy(cost), torch.from_numpy(p), torch.from_numpy(tb))
    want = lap_bid_fused_pallas_batched(
        jnp.asarray(cost), jnp.asarray(p), jnp.asarray(tb), interpret=True
    )
    _assert_top2_bitwise(want, got)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_lap_bid_fused_oracle_matches_jax_oracle(case):
    cost, p, tb = _fused_case(case)
    ct, pt, tbt = torch.from_numpy(cost), torch.from_numpy(p), torch.from_numpy(tb)
    got_plain = lap_bid_fused_top2_plain(ct, pt, tbt)
    for b in range(cost.shape[0]):
        want = jax_ref.lap_bid_fused_top2(jnp.asarray(cost[b]), jnp.asarray(p[b]), float(tb[b]))
        got = ref.lap_bid_fused_top2(ct[b], pt[b], float(tb[b]))
        _assert_top2_bitwise(want, got)
        for w, g in zip(got, got_plain):
            assert torch.equal(w, g[b])
    # the oracle takes a per-instance tb on a batch, too
    for w, g in zip(ref.lap_bid_fused_top2(ct, pt, tbt), got_plain):
        assert torch.equal(w, g)


def test_lap_bid_fused_single_column_second_is_neg_inf():
    cost, p, tb = _fused_case("single_column")
    _, _, second = lap_bid_fused_batched(
        torch.from_numpy(cost), torch.from_numpy(p), torch.from_numpy(tb)
    )
    assert (second == np.float32(-1e30)).all()


def test_lap_bid_fused_wrapper_rejects_bad_operands():
    c = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="float32"):
        lap_bid_fused_batched(c, torch.zeros(2, 4), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="does not match"):
        lap_bid_fused_batched(c, torch.zeros(2, 4), torch.zeros(3))
    with pytest.raises(ValueError, match="do not match"):
        lap_bid_fused_batched(c, torch.zeros(2, 5), torch.zeros(2))
    with pytest.raises(ValueError, match="unsupported device"):
        lap_bid_fused_batched(c.to("meta"), torch.zeros(2, 4, device="meta"),
                              torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="do not match"):
        ops.lap_bid_fused(torch.zeros(3, 4), torch.zeros(1, 4))


# --------------------------------------------------------------------------- #
# migration_cost
# --------------------------------------------------------------------------- #
def _slots(rng, count, max_job, empty_frac=0.3):
    s = rng.integers(0, max_job, size=(count, 2))
    s[rng.random((count, 2)) < empty_frac] = -1
    s[::7, :] = -1  # fully empty GPUs
    return s


@pytest.mark.parametrize("shape", [(5, 9), (130, 67), (16, 16)])
def test_migration_cost_plain_bit_identical_to_numpy(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    su = _slots(rng, shape[0], 12)
    sv = _slots(rng, shape[1], 12)
    gpus = {j: int(rng.choice([1, 2, 4, 8])) for j in range(12)}
    weights = jax_weight_lookup(gpus)
    want = pairwise_migration_cost(su, sv, weights)
    got = ops.migration_cost_matrix(su, sv, weights, "cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(want.view(np.int64), got.numpy().view(np.int64))
    # the oracle agrees, and the f32 Pallas kernel agrees within its precision
    wu = torch.from_numpy(ops.slot_weights(su, weights))
    wv = torch.from_numpy(ops.slot_weights(sv, weights))
    su_t = torch.from_numpy(su.astype(np.int32))
    sv_t = torch.from_numpy(sv.astype(np.int32))
    assert torch.equal(ref.migration_cost(su_t, sv_t, wu, wv), got)
    pallas = migration_cost_pallas(
        jnp.asarray(su, jnp.int32),
        jnp.asarray(sv, jnp.int32),
        jnp.asarray(wu.numpy(), jnp.float32),
        jnp.asarray(wv.numpy(), jnp.float32),
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(pallas, np.float64), got.numpy(), rtol=0, atol=1e-6)


def test_slot_weights_remap_empty_explicitly():
    weights = np.array([0.5, 0.25, 0.125, 0.0])  # job 0..2, then the zero tail
    got = ops.slot_weights(np.array([[-1, 2], [1, -1]]), weights)
    np.testing.assert_array_equal(got, [[0.0, 0.125], [0.25, 0.0]])


def test_migration_cost_wrapper_rejects_bad_operands():
    s = torch.zeros(3, 2, dtype=torch.int32)
    w = torch.zeros(3, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        migration_cost(s.long(), s, w, w)
    with pytest.raises(ValueError, match="float64"):
        migration_cost(s, s, w.float(), w)
    with pytest.raises(ValueError, match="unsupported device"):
        migration_cost(s.to("meta"), s.to("meta"), w.to("meta"), w.to("meta"))


# --------------------------------------------------------------------------- #
# the port stands alone
# --------------------------------------------------------------------------- #
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    assert not bad, "port modules import JAX or the JAX package:\n" + "\n".join(bad)
