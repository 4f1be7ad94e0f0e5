"""The port's MoE layer, and the MoE and MLA models as a whole, against the
JAX package on the CPU (``dbrx-132b`` and ``deepseek-v2-236b`` at their
reduced sizes).

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried into the port by ``params_from_jax``.  The reference's
``moe_ffn`` does not return its routing, so the routing tests run the
reference's routing lines (``repro/models/mlp.py``, top-k to the keep mask)
in ``jax`` ops beside the port's ``moe_route``; the layer itself is held
against the reference's own ``moe_ffn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import attention as jax_attn
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import mlp as jax_mlp
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import get_model, mlp
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["dbrx-132b", "deepseek-v2-236b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _reduced(arch, dtype="float32"):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype)


def _moe_params(cfg, seed=0):
    jp = jax_mlp.init_moe(jax.random.PRNGKey(seed), cfg, JNP[cfg.dtype])
    return jp, {k: (_t(v) if not isinstance(v, dict) else {kk: _t(vv) for kk, vv in v.items()})
                for k, v in jp.items()}


def _jax_route(cfg, probs, groups):
    """The reference's routing (``repro/models/mlp.py``, ``moe_ffn``: top-k,
    the gates' renormalisation, the Switch aux loss and the group-local
    one-hot cumsum) in ``jax`` ops."""
    e, k = cfg.num_experts, cfg.num_experts_per_token
    t = probs.shape[0]
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    token_frac = jnp.zeros((e,), jnp.float32).at[expert_idx.reshape(-1)].add(1.0) / (t * k)
    aux = cfg.router_aux_coef * e * jnp.sum(token_frac * probs.mean(axis=0))
    tg = t // groups
    capg = jax_mlp.capacity_of(cfg, tg)
    flat_e = expert_idx.reshape(groups, tg * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1, flat_e[..., None], axis=2)[..., 0]
    return dict(gates=gate_vals, experts=expert_idx, pos=pos, keep=pos < capg, capacity=capg,
                aux=aux)


def _margin(probs, k):
    """Per token: the gap between its k-th and (k+1)-th probability."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return s[:, k - 1] - s[:, k]


def _skewed_tokens(cfg, router, b, s, seed, skew=3.0):
    """(B, S, D) hidden states pushed towards expert 0, so it overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    r0 = np.asarray(router, np.float32)[:, 0]
    return (x + skew * np.sqrt(cfg.d_model) * r0 / np.linalg.norm(r0)).astype(np.float32)


# --------------------------------------------------------------------------- #
# capacity and routing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_capacity_of_equals_jax(arch, full):
    cfg_t = (get_config if full else get_reduced)(arch)
    cfg_j = (jax_get_config if full else jax_get_reduced)(arch)
    for n in [1, 2, 7, 8, 9, 31, 64, 100, 128, 255, 1000, 2048, 8192, 65536]:
        assert mlp.capacity_of(cfg_t, n) == jax_mlp.capacity_of(cfg_j, n), n


@pytest.mark.parametrize("probs,k", [
    ([0.1, 0.3, 0.3, 0.3, 0.0, 0.3], 3),  # torch.topk gives [3, 5, 2] on the CPU
    ([0.25, 0.25, 0.25, 0.25], 2),
    ([0.0, 0.5, 0.0, 0.5, 0.0], 4),
    ([0.2, 0.1, 0.2, 0.3, 0.2], 3),
])
def test_top_k_orders_ties_lowest_index_first_as_jax(probs, k):
    p = np.asarray(probs, np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    tv, ti = mlp.top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _routing_cases(cfg, case, t, seed):
    rng = np.random.default_rng(seed)
    e = cfg.num_experts
    if case == "ties":  # every probability equal: every token picks experts 0..k-1
        return np.full((t, e), 1.0 / e, np.float32)
    if case == "near_ties":  # pairs of equal probabilities, drawn from few values
        vals = rng.integers(1, 4, size=(t, e)).astype(np.float32)
        return vals / vals.sum(-1, keepdims=True)
    logits = (rng.standard_normal((t, e)) * 2).astype(np.float32)
    logits[:, 0] += 2.0  # most tokens want expert 0: it overflows
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", ["random", "ties", "near_ties"])
def test_routing_equals_jax_given_the_same_probabilities(arch, groups, case):
    """Experts, gates, slots and the keep mask bitwise equal; the aux loss
    within 1e-6."""
    cfg = _reduced(arch)
    probs = _routing_cases(cfg, case, 96, seed=3)
    want = _jax_route(cfg, jnp.asarray(probs), groups)
    got = mlp.moe_route(get_reduced(arch), torch.from_numpy(probs), groups)
    for key in ("experts", "gates", "pos", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["capacity"] == want["capacity"]
    assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6 * abs(float(want["aux"]))
    if case == "random":
        assert not bool(got["keep"].all())  # the case overflows an expert
    if case == "ties":
        assert (got["experts"].numpy() == np.arange(cfg.num_experts_per_token)).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
def test_routing_equals_jax_given_the_same_logits(arch, groups):
    """From the same f32 router logits: experts, slots and keep bitwise
    equal; the gates within 1e-6 (the two softmaxes differ in the last
    bits on the CPU)."""
    cfg = _reduced(arch)
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((128, cfg.num_experts)) * 2).astype(np.float32)
    logits[:, 1] += 1.5
    want = _jax_route(cfg, jax.nn.softmax(jnp.asarray(logits), axis=-1), groups)
    got = mlp.moe_route(get_reduced(arch), torch.softmax(torch.from_numpy(logits), -1), groups)
    for key in ("experts", "pos", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["gates"].numpy(), np.asarray(want["gates"]), rtol=1e-6)
    assert not bool(got["keep"].all())


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", ["1", "2"])
def test_moe_ffn_equals_jax_past_capacity(monkeypatch, arch, dtype, groups):
    """The layer's output (1e-5 in f32, 3e-2 in bf16) and its aux loss
    (1e-6 in f32) on tokens that overflow an expert's capacity, at
    ``REPRO_MOE_GROUPS`` 1 and 2 in both packages."""
    monkeypatch.setenv("REPRO_MOE_GROUPS", groups)
    cfg = _reduced(arch, dtype)
    jp, tp = _moe_params(cfg)
    x = _skewed_tokens(cfg, jp["router"], 2, 40, seed=4)
    xj = jnp.asarray(x, JNP[dtype])
    want, waux = jax_mlp.moe_ffn(jp, cfg, xj)
    routes = []
    real_route = mlp.moe_route
    monkeypatch.setattr(mlp, "moe_route", lambda *a: routes.append(real_route(*a)) or routes[-1])
    got, gaux = mlp.moe_ffn(tp, get_reduced(arch) if dtype == "bfloat16" else cfg, _t(xj))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert not bool(routes[0]["keep"].all()), "the input should overflow an expert"
    assert routes[0]["pos"].shape[0] == int(groups)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    if dtype == "float32":
        assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_ablation_equals_jax(monkeypatch, arch):
    """``REPRO_ABLATE_MOE=1``: zeros and the router-only aux, in both."""
    monkeypatch.setenv("REPRO_ABLATE_MOE", "1")
    cfg = _reduced(arch)
    jp, tp = _moe_params(cfg)
    x = np.random.default_rng(6).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want, waux = jax_mlp.moe_ffn(jp, cfg, jnp.asarray(x))
    got, gaux = mlp.moe_ffn(tp, get_reduced(arch), torch.from_numpy(x))
    assert not np.asarray(want).any() and not got.numpy().any()
    assert got.shape == x.shape
    # 1e-9 times a sum of logits that cancels: held to the rounding of its terms
    assert abs(float(gaux) - float(waux)) <= 1e-13


def test_moe_dispatch_drops_exactly_the_choices_past_capacity():
    """Every kept choice carries its token into its own slot; a dropped
    choice contributes nothing (the layer equals a loop over the kept
    choices)."""
    cfg = _reduced("dbrx-132b")
    jp, tp = _moe_params(cfg)
    x = torch.from_numpy(_skewed_tokens(cfg, jp["router"], 1, 48, seed=7))
    got, _ = mlp.moe_ffn(tp, cfg, x)
    xt = x.reshape(-1, cfg.d_model)
    r = mlp.moe_route(cfg, torch.softmax(xt @ tp["router"], -1), 1)
    keep = r["keep"].reshape(-1, cfg.num_experts_per_token)
    want = torch.zeros_like(xt)
    for i in range(xt.shape[0]):
        for j in range(cfg.num_experts_per_token):
            if keep[i, j]:
                e = int(r["experts"][i, j])
                w = {n: tp[n][e] for n in ("w_gate", "w_up", "w_down")}
                want[i] += r["gates"][i, j] * mlp.ffn(w, cfg, xt[i:i + 1])[0]
    assert (~keep).sum() > 0
    # f32, summed in another order, on outputs of order 10
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
def _jax_model(arch, seed=1):
    cfg = _reduced(arch)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _jax_layer_routes(cfg, jp, tokens):
    """The reference's routing of every layer of a forward: its layers run
    one at a time with its own functions, each MoE's input routed."""
    x = jp["embed"][tokens]
    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))
    attend = jax_attn.mla_forward if cfg.use_mla else jax_attn.gqa_forward
    routes = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a, i=i: a[i], jp["layers"])
        y = x + attend(p["attn"], cfg, jax_layers.rms_norm(x, p["norm1"], cfg.norm_eps), positions)
        h = jax_layers.rms_norm(y, p["norm2"], cfg.norm_eps)
        logits = h.reshape(b * s, -1).astype(jnp.float32) @ p["moe"]["router"]
        probs = jax.nn.softmax(logits, axis=-1)
        routes.append(dict(_jax_route(cfg, probs, 1), probs=probs))
        f, _ = jax_mlp.moe_ffn(p["moe"], cfg, h)
        x = y + f
    return routes


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_aux_and_routing_equal_jax(monkeypatch, arch):
    """In f32: the logits within 1e-4, the aux loss summed over the layers
    within 1e-6, and every layer's experts, slots and keep mask equal to
    the reference's (a flip is reported with its margin)."""
    cfg, jp, tp = _jax_model(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, waux = jax_get_model(cfg).forward(jp, cfg, {"tokens": jnp.asarray(tokens)})
    routes, real_route = [], mlp.moe_route
    monkeypatch.setattr(mlp, "moe_route", lambda *a: routes.append(real_route(*a)) or routes[-1])
    got, gaux = get_model(cfg).forward(tp, cfg, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))
    assert float(waux) > 0
    jroutes = _jax_layer_routes(cfg, jp, jnp.asarray(tokens))
    assert len(routes) == len(jroutes) == cfg.num_layers
    k = cfg.num_experts_per_token
    for i, (g, w) in enumerate(zip(routes, jroutes)):
        flips = np.nonzero((g["experts"].numpy() != np.asarray(w["experts"])).any(-1))[0]
        margins = _margin(w["probs"], k)[flips]
        assert flips.size == 0, f"layer {i}: tokens {flips} flipped, margins {margins}"
        for key in ("pos", "keep"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]), err_msg=f"{key} {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_jax(arch):
    """In f32, batch 2: every step's logits within 1e-4 of the reference's
    and the caches equal at 1e-5, over more steps than the cache holds."""
    cfg, jp, tp = _jax_model(arch, seed=2)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    cache_len, steps = 8, 12
    jc, tc = jm.init_cache(cfg, 2, cache_len), tm.init_cache(cfg, 2, cache_len, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, steps)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(steps):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(i))
        tl, tc = tm.decode_step(tp, cfg, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
                                tc, torch.tensor(i))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for key in jc["layers"]:
        for layer in range(cfg.num_layers):
            np.testing.assert_allclose(_np(tc["layers"][layer][key]),
                                       np.asarray(jc["layers"][key][layer]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_stepped_decode_equals_the_forward_where_no_expert_overflows(arch):
    """The port alone, f32: stepping 8 tokens (batch 1) through the cache
    gives the full forward's logits within 1e-4.  At 8 tokens
    ``capacity_of`` is 8, so neither path drops a choice."""
    cfg, _, tp = _jax_model(arch, seed=3)
    assert mlp.capacity_of(cfg, 8) == 8 >= 8 * cfg.num_experts_per_token // cfg.num_experts
    tm = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, 8))).long()
    full, _ = tm.forward(tp, cfg, {"tokens": toks})
    cache = tm.init_cache(cfg, 1, 8, "cpu")
    for i in range(8):
        step, cache = tm.decode_step(tp, cfg, {"tokens": toks[:, i:i + 1]}, cache, i)
        torch.testing.assert_close(step[:, 0], full[:, i], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_moe_and_mla_leaves(arch):
    """Every leaf of the reference's params, MoE and MLA included, arrives
    bitwise, un-stacked per layer; the router stays f32 in a bf16 model."""
    cfg = jax_get_reduced(arch)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    layer = tp["layers"][1]
    assert set(layer["moe"]) == set(jp["layers"]["moe"])
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["moe"]["w_gate"].dtype == torch.bfloat16
    assert layer["moe"]["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    if cfg.use_mla:
        assert set(layer["attn"]) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
        assert set(layer["moe"]["shared"]) == set(jp["layers"]["moe"]["shared"])
    flat = jax.tree_util.tree_flatten_with_path(jp["layers"])[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = layer
        for key in keys:
            t = t[key]
        want = np.asarray(leaf)[1]
        assert t.shape == want.shape, keys
        np.testing.assert_array_equal(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(),
                                      want.view(np.int16) if want.dtype.name == "bfloat16" else want)
    fresh = get_model(get_reduced(arch)).init(torch.Generator().manual_seed(0), get_reduced(arch))
    assert jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, fresh["layers"][0])) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, layer))
