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

from repro.core.migration import _weight_lookup as jax_weight_lookup
from repro.core.migration import pairwise_migration_cost
from repro.kernels.lap_bid import lap_bid_pallas, lap_bid_pallas_batched
from repro.kernels.migration_cost import migration_cost_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_top2_plain
from repro_torch.kernels.migration_cost import migration_cost

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
