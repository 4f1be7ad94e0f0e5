"""The port's memoised throughput lookups against the formula and the JAX
package.

``ThroughputProfile.normalized_packed`` keeps its answers per profile,
keyed on the catalog entries and the two strategies, and the SHA-256 unit
behind every per-(model, strategy) and per-pair wiggle is kept per key
string.  The floats served from the memos must be the formula's, bit for
bit, on every GPU type; a wrapper profile (noisy, tabulated, restricted)
and its base must never serve each other's answers; a model re-registered
under its name must be seen; and the simulator's per-placed-job loop must
digest each key at most once.
"""

import collections
import hashlib

import pytest

import repro.core.profiler as jprof
import repro_torch.core.cluster as tcl
import repro_torch.core.policies as tpol
import repro_torch.core.profiler as tprof
import repro_torch.core.scheduler as tsch
import repro_torch.core.simulator as tsim
import repro_torch.core.traces as ttr
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

MODELS = sorted(tprof.MODEL_CATALOG)


def _unit(a, b, salt=""):
    """``_pair_hash_unit`` as the formula states it, with no memo."""
    key = "|".join(sorted((a, b))) + "#" + salt
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little") / 2**64


def _formula(prof, a, b, sa, sb):
    """(isolated of a on 2 GPUs, mem_gb of a, normalized_packed) computed
    from the catalog by the profile's formula, with no memo."""

    def factors(name, s):
        tput_f, mem_f = tprof.STRATEGIES[s]
        return tput_f * (1.0 + prof.strategy_jitter * (2 * _unit(name, s, "strat") - 1)), mem_f

    ma, mb = tprof.MODEL_CATALOG[a], tprof.MODEL_CATALOG[b]
    iso = ma.base_tput * prof.gpu.speed * 2 * factors(a, sa)[0]
    mem_a, mem_b = ma.mem_gb * factors(a, sa)[1], mb.mem_gb * factors(b, sb)[1]
    if mem_a + mem_b > prof.gpu.mem_gb:
        return iso, mem_a, (0.0, 0.0)
    overlap = ma.ci * mb.ci + (1 - ma.ci) * (1 - mb.ci)
    interference = prof.gamma + (1 - prof.gamma) * overlap
    interference *= 0.55 + 0.75 * ((mem_a + mem_b) / prof.gpu.mem_gb)
    n = (1.0 + prof.jitter * (2 * _unit(a, b) - 1)) / (1.0 + interference)
    skew = 0.06 * (ma.ci - mb.ci)
    return iso, mem_a, (
        min(max(n * (1 + skew), 0.05), 1.0),
        min(max(n * (1 - skew), 0.05), 1.0),
    )


def _lookups(prof, a, b, sa, sb):
    return prof.isolated(a, 2, sa), prof.mem_gb(a, sa), prof.normalized_packed(a, b, sa, sb)


def _combos(prof, a):
    return [(b, sa, sb) for b in MODELS for sa in prof.strategies(a) for sb in prof.strategies(b)]


@pytest.mark.parametrize("a", MODELS)
@pytest.mark.parametrize("gpu_type", sorted(tprof.GPU_TYPES))
def test_memoised_lookups_equal_the_formula_and_jax(gpu_type, a):
    """Cold, then from the memo, then through an A100 profile's
    ``for_gpu_type`` variant: every float equals the formula's and the
    JAX package's (``==``)."""
    tp = tprof.ThroughputProfile(gpu_type)
    jp = jprof.ThroughputProfile(gpu_type)
    variant = tprof.ThroughputProfile("a100").for_gpu_type(gpu_type)
    combos = _combos(tp, a)
    cold = [_lookups(tp, a, b, sa, sb) for b, sa, sb in combos]
    assert len(tp._packed_cache) == len(combos)
    for (b, sa, sb), got in zip(combos, cold):
        want = _lookups(jp, a, b, sa, sb)
        assert got == want == _formula(tp, a, b, sa, sb), (b, sa, sb)
        assert _lookups(tp, a, b, sa, sb) == want
        assert _lookups(variant, a, b, sa, sb) == want
    # every model packs with some partner on the A100's 40 GB
    assert gpu_type != "a100" or any(c[2] != (0.0, 0.0) for c in cold)


def test_gpu_type_variants_keep_memos_of_their_own():
    base = tprof.ThroughputProfile("a100")
    for a, b in tprof.all_pairs(MODELS):
        base.normalized_packed(a, b)
    v100, tpu = base.for_gpu_type("v100"), base.for_gpu_type("tpu-v5e")
    assert base.for_gpu_type("a100") is base and base.for_gpu_type("v100") is v100
    caches = [p._packed_cache for p in (base, v100, tpu)]
    assert len({id(c) for c in caches}) == 3
    assert not v100._packed_cache and not tpu._packed_cache
    # V100's 16 GB cuts pairs the A100 packs
    cut = [(a, b) for a, b in tprof.all_pairs(MODELS)
           if base.normalized_packed(a, b) != (0.0, 0.0) == v100.normalized_packed(a, b)]
    assert cut
    jv100 = jprof.ThroughputProfile("v100")
    for a, b in tprof.all_pairs(MODELS):
        assert v100.normalized_packed(a, b) == jv100.normalized_packed(a, b)


def _noisy(prof_mod, base):
    return prof_mod.NoisyProfile(base, noise=0.3, seed=7)


def _tabulated(prof_mod, base):
    return prof_mod.linear_bo_estimate(base, MODELS, strategy_budget=2, seed=3)


def _completed(prof_mod, base):
    return prof_mod.matrix_completion_estimate(base, MODELS, seed=1, iters=20)


def _restricted(prof_mod, base):
    return prof_mod.RestrictedStrategyProfile(base, ("dp", "pp-default"))


@pytest.mark.parametrize("wrap", [_noisy, _tabulated, _completed, _restricted],
                         ids=["noisy", "tabulated", "completed", "restricted"])
def test_wrappers_and_their_base_serve_their_own_values(wrap):
    """A wrapper built on a warmed base answers as the JAX package's
    wrapper does, and the base, asked again after the wrapper is warmed,
    still answers as the JAX base."""
    queries = [(a, b, sa, "dp") for a in MODELS for b in MODELS
               for sa in tprof.ThroughputProfile().strategies(a)]
    base, jbase = tprof.ThroughputProfile(), jprof.ThroughputProfile()
    clean = [base.normalized_packed(*q) for q in queries]
    wrapped, jwrapped = wrap(tprof, base), wrap(jprof, jbase)
    assert wrapped._packed_cache is not base._packed_cache
    assert wrapped._weight_cache is not base._weight_cache
    for _ in range(2):
        got = [wrapped.normalized_packed(*q) for q in queries]
        assert got == [jwrapped.normalized_packed(*q) for q in queries]
    assert [base.normalized_packed(*q) for q in queries] == clean
    assert clean == [jbase.normalized_packed(*q) for q in queries]
    weights = [(wrapped.combined_weight(a, b), base.combined_weight(a, b)) for a, b in
               tprof.all_pairs(MODELS)]
    assert weights == [(jwrapped.combined_weight(a, b), jbase.combined_weight(a, b)) for a, b in
                       tprof.all_pairs(MODELS)]
    if wrap is not _restricted:
        assert got != clean


def test_a_re_registered_model_is_seen(monkeypatch):
    """``register_model`` over a catalog name: the next lookups read the
    new entry, on a profile whose memo already holds the old one.  The
    catalog is restored afterwards."""
    for name in ("dcgan", "gpt3-xl"):
        monkeypatch.setitem(tprof.MODEL_CATALOG, name, tprof.MODEL_CATALOG[name])
    prof = tprof.ThroughputProfile()
    old = [_lookups(prof, "dcgan", b, "dp", "dp") for b in MODELS]
    old_llm = prof.normalized_packed("gpt3-xl", "pointnet", "tp", "dp")
    tprof.register_model("dcgan", ci=0.2, mem_gb=11.0, base_tput=9.0)
    tprof.register_model("gpt3-xl", ci=0.5, mem_gb=21.0, base_tput=0.9, is_llm=True)
    new = [_lookups(prof, "dcgan", b, "dp", "dp") for b in MODELS]
    assert new == [_formula(prof, "dcgan", b, "dp", "dp") for b in MODELS]
    assert all(n != o for n, o in zip(new, old))
    new_llm = prof.normalized_packed("gpt3-xl", "pointnet", "tp", "dp")
    assert new_llm == _formula(prof, "gpt3-xl", "pointnet", "tp", "dp")[2] != old_llm
    # the partner side reads the new entry too
    assert prof.normalized_packed("pointnet", "dcgan") == _formula(
        prof, "pointnet", "dcgan", "dp", "dp")[2]


@pytest.mark.parametrize("node_gpu_types", [None, ("a100", "v100", "a100")],
                         ids=["a100", "a100-v100"])
def test_advance_round_digests_each_key_once(monkeypatch, node_gpu_types):
    """A small packed cell run to its end: no key is digested twice, and
    the per-placed-job loop asks ``normalized_packed`` far more often than
    it computes it."""
    cluster = tcl.ClusterSpec(3, 4, node_gpu_types=node_gpu_types)
    prof = tprof.ThroughputProfile()
    sched = tsch.TesseraeScheduler(cluster, tpol.TiresiasPolicy(prof), prof, device="cpu")
    trace = ttr.shockwave_trace(num_jobs=40, arrival_rate_per_hour=400.0, seed=11, profile=prof)
    tprof._key_unit.cache_clear()
    digested = collections.Counter()
    sha256 = hashlib.sha256

    def counting_sha256(data=b"", **kw):
        digested[bytes(data)] += 1
        return sha256(data, **kw)

    asked = collections.Counter()
    in_round = [False]
    asks, computes = tprof.ThroughputProfile.normalized_packed, tprof.ThroughputProfile._packed

    def ask(self, *a, **k):
        asked["asked"] += in_round[0]
        return asks(self, *a, **k)

    def compute(self, *a, **k):
        asked["computed"] += in_round[0]
        return computes(self, *a, **k)

    advance = tsim.Simulator._advance_round

    def advance_round(self, *a, **k):
        in_round[0] = True
        try:
            return advance(self, *a, **k)
        finally:
            in_round[0] = False

    monkeypatch.setattr(hashlib, "sha256", counting_sha256)
    monkeypatch.setattr(tprof.ThroughputProfile, "normalized_packed", ask)
    monkeypatch.setattr(tprof.ThroughputProfile, "_packed", compute)
    monkeypatch.setattr(tsim.Simulator, "_advance_round", advance_round)
    res = tsim.Simulator(cluster, trace, sched, prof, tsim.SimConfig()).run()
    assert res.num_rounds > 10 and len(res.jobs) == 40
    assert digested and max(digested.values()) == 1, digested.most_common(3)
    assert asked["asked"] > 4 * max(asked["computed"], 1) > 4
