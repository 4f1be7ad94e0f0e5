"""The port's Mamba-2 block and the SSM and hybrid models (``mamba2-780m``,
``zamba2-2.7b`` at their reduced sizes) against the JAX package, on the CPU,
and the attention kernels' plain versions at zamba2's head dim 80.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried into the port by ``params_from_jax``.  On the CPU the
port's kernel wrappers take their plain versions, so K6 and K7 at D = 80
are held here against the Pallas kernels in interpret mode and the
oracles; the CUDA instances are held to the plain versions in
``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import get_model as jax_get_model
from repro.models import ssm as jax_ssm
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, ssm
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.serve import ServeConfig, greedy_generate
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["mamba2-780m", "zamba2-2.7b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _cfg(arch="mamba2-780m", dtype="float32", **kw):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **kw)


def _block(cfg, seed=0):
    """One Mamba-2 block's params: JAX's, and the same carried to the port."""
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(seed), cfg, JNP[cfg.dtype])
    return jp, {k: _t(v) for k, v in jp.items()}


def _hidden(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, JNP[cfg.dtype])


def _jax_model(arch, dtype="float32", seed=1, **kw):
    cfg = _cfg(arch, dtype, **kw)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


# --------------------------------------------------------------------------- #
# the Mamba-2 block
# --------------------------------------------------------------------------- #
def test_init_mamba2_has_the_reference_layouts_and_constants():
    cfg = _cfg(dtype="bfloat16")
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape and str(tp[k].dtype).split(".")[1] == v.dtype.name, k
    for k in ("a_log", "d_skip", "dt_bias", "conv_b", "norm"):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert abs(float(tp["conv_w"].float().std()) - 0.1) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_equals_jax(dtype):
    cfg = _cfg(dtype=dtype)
    jp, tp = _block(cfg)
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    xbc = np.random.default_rng(3).standard_normal((2, 37, ch)).astype(np.float32)
    xj = jnp.asarray(xbc, JNP[dtype])
    want = jax_ssm._conv(jp, xj)
    got = ssm._conv(tp, _t(xj))
    assert got.dtype == _t(want).dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_mamba2_forward_equals_jax(dtype, chunks):
    """The chunked SSD at S = 1, 2 and 3 chunks (the inter-chunk recurrence
    empty, one step, two), B 2: 1e-5 in f32, 3e-2 in bf16."""
    cfg = _cfg(dtype=dtype)
    jp, tp = _block(cfg, seed=chunks)
    u = _hidden(cfg, 2, chunks * cfg.ssm_chunk, seed=chunks)
    want = jax_ssm.mamba2_forward(jp, cfg, u)
    got = ssm.mamba2_forward(tp, cfg, _t(u))
    assert got.dtype == _t(want).dtype and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_mamba2_forward_raises_off_a_chunk_multiple():
    cfg = _cfg()
    _, tp = _block(cfg)
    u = torch.zeros((1, cfg.ssm_chunk + 1, cfg.d_model))
    with pytest.raises(ValueError, match="not a multiple of ssm_chunk"):
        ssm.mamba2_forward(tp, cfg, u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_equal_jax(dtype):
    """Ten recurrent steps at B 2: each output and the cache's ``state``
    and ``conv`` after it, 1e-5 in f32, 3e-2 in bf16; the cache is written
    in place."""
    cfg = _cfg(dtype=dtype)
    jp, tp = _block(cfg)
    jc = jax_ssm.init_mamba2_cache(cfg, 2, JNP[dtype])
    tc = ssm.init_mamba2_cache(cfg, 2, _t(jc["conv"]).dtype, "cpu")
    assert tc["state"].dtype == torch.float32 and tuple(tc["state"].shape) == jc["state"].shape
    state0 = tc["state"]
    u = _hidden(cfg, 2, 10, seed=5)
    tol = TOL[dtype]
    for i in range(10):
        want, jc = jax_ssm.mamba2_decode_step(jp, cfg, u[:, i:i + 1], jc, jnp.asarray(i))
        got, tc = ssm.mamba2_decode_step(tp, cfg, _t(u[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=f"step {i}")
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=tol, atol=tol,
                                       err_msg=f"{key} {i}")
    assert tc["state"] is state0


def test_mamba2_decode_equals_the_chunked_forward():
    """The recurrence stepped over two chunks gives the chunked SSD's
    output (f32, 1e-5): the dual form and the recurrence agree."""
    cfg = _cfg()
    _, tp = _block(cfg, seed=4)
    u = _t(_hidden(cfg, 2, 2 * cfg.ssm_chunk, seed=6))
    full = ssm.mamba2_forward(tp, cfg, u)
    cache = ssm.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    steps = [ssm.mamba2_decode_step(tp, cfg, u[:, i:i + 1], cache, i)[0] for i in range(u.shape[1])]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt_bias,nan_heads", [(-3.0, 0), (0.5, 7)])
def test_ssd_gradient_past_the_f32_exp_range_is_nan_at_the_same_entries_in_both_packages(
        dt_bias, nan_heads):
    """ROADMAP D19.  Both packages form ``exp(cum_i - cum_j)`` for every
    (i, j) of a chunk and only then zero i < j with ``where``.  Above the
    diagonal the exponent is the decay summed between the two positions;
    where it passes log(f32 max) (88.7) the exp is inf, the forward stays
    finite, and the backward multiplies the ``where``'s zero by inf.  One
    chunk of 32 tokens, every head's ``dt`` raised by ``dt_bias``: at -3.0
    no head's summed decay reaches 88.7 and both gradients are finite and
    agree; at 0.5 seven of eight heads pass it, and both packages give NaN
    at exactly the same entries (those heads' ``a_log``, ``dt_bias`` and
    ``in_proj`` columns, and every input), agreeing elsewhere at 1e-4."""
    cfg = _cfg()
    jp, _ = _block(cfg)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], dt_bias))
    u = _hidden(cfg, 1, cfg.ssm_chunk, seed=0)

    want_p, want_u = jax.grad(lambda p, x: jnp.sum(jax_ssm.mamba2_forward(p, cfg, x)),
                              argnums=(0, 1))(jp, u)
    tp = {k: _t(v).requires_grad_() for k, v in jp.items()}
    tu = _t(u).requires_grad_()
    out = ssm.mamba2_forward(tp, cfg, tu)
    assert bool(torch.isfinite(out).all())
    out.sum().backward()

    # the largest exponent above the diagonal, per head: cum_0 - cum_{Q-1}
    zx = np.asarray(u, np.float64)[0] @ np.asarray(jp["in_proj"], np.float64)
    dt = np.logaddexp(0.0, zx[:, -cfg.ssm_heads:] + dt_bias)
    span = (dt * np.exp(np.asarray(jp["a_log"], np.float64)))[1:].sum(0)
    overflows = span > np.log(np.finfo(np.float32).max)
    assert overflows.sum() == nan_heads
    for k, g in want_p.items():
        want, got = np.asarray(g), tp[k].grad.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=k)
        np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(np.isnan(tp["dt_bias"].grad.numpy()), overflows)
    np.testing.assert_array_equal(np.isnan(tu.grad.numpy()), np.isnan(np.asarray(want_u)))
    assert np.isnan(np.asarray(want_u)).all() == bool(nan_heads)


# --------------------------------------------------------------------------- #
# the whole models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_jax(arch):
    cfg, jp, tp = _jax_model(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 3 * cfg.ssm_chunk)).astype(np.int32)
    want, _ = jax_get_model(cfg).forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = get_model(cfg).forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_both_cache_parts_equal_jax(arch):
    """f32, B 2, 12 steps: every step's logits within 1e-4; after them each
    layer's recurrent state and conv ring and (zamba2) each group's shared
    GQA cache within 1e-5."""
    cfg, jp, tp = _jax_model(arch, seed=2)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    jc, tc = jm.init_cache(cfg, 2, 16), tm.init_cache(cfg, 2, 16, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(12):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(i))
        tl, tc = tm.decode_step(tp, cfg, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
                                tc, torch.tensor(i))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    assert set(tc) == set(jc) == ({"layers", "shared"} if arch == "zamba2-2.7b" else {"layers"})
    for part in tc:
        for key in jc[part]:
            assert len(tc[part]) == jc[part][key].shape[0]
            for i, c in enumerate(tc[part]):
                np.testing.assert_allclose(_np(c[key]), _np(jc[part][key][i]), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{part} {key} {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_stepped_decode_equals_the_forward(arch, dtype, tol):
    """The reference's decode-parity contract (``TestDecodeParity``, 0.05
    in bf16) on the port alone, and at 1e-4 in f32."""
    cfg, _, tp = _jax_model(arch, dtype, seed=3)
    tm = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, cfg.ssm_chunk)))
    full, _ = tm.forward(tp, cfg, {"tokens": toks})
    cache = tm.init_cache(cfg, 2, cfg.ssm_chunk, "cpu")
    steps = [tm.decode_step(tp, cfg, {"tokens": toks[:, i:i + 1]}, cache, i)[0]
             for i in range(cfg.ssm_chunk)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal_jax(arch):
    cfg, jp, tp = _jax_model(arch)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = jax_engine.greedy_generate(jp, cfg, jnp.asarray(prompt), 10, jax_engine.ServeConfig(3, 64))
    got = greedy_generate(tp, cfg, torch.from_numpy(prompt), 10, ServeConfig(3, 64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hybrid_with_a_tail_runs_it_in_the_forward_and_in_decode():
    """num_layers 3 with the shared block after every 2: the forward (one
    group, the block, one tail layer) equals the reference's at 1e-4.  The
    port's stepped decode runs the tail too and equals its forward; the
    reference's decode step skips the tail and returns a cache of 2 layers
    (ROADMAP D14), so it is held to nothing here."""
    cfg, jp, tp = _jax_model("zamba2-2.7b", num_layers=3, hybrid_attn_every=2)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, cfg.ssm_chunk)).astype(np.int32)
    want, _ = jax_get_model(cfg).forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tm = get_model(cfg)
    got, _ = tm.forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    cache = tm.init_cache(cfg, 2, 8, "cpu")
    assert len(cache["layers"]) == 3 and len(cache["shared"]) == 1
    for i in range(8):
        step, cache = tm.decode_step(tp, cfg, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
                                     cache, i)
        np.testing.assert_allclose(_np(step[:, 0]), _np(want[:, i]), rtol=1e-4, atol=1e-4)
    assert cache["layers"][2]["state"].abs().sum() > 0  # the tail layer stepped
    jm = jax_get_model(cfg)
    _, jc = jm.decode_step(jp, cfg, {"tokens": jnp.asarray(toks[:, :1])}, jm.init_cache(cfg, 2, 8),
                           jnp.asarray(0))
    assert jc["layers"]["state"].shape[0] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_at_head_dim_80_takes_the_einsum_path_on_the_cpu(monkeypatch, dtype):
    """zamba2's shared block at its real head dim 80: unset, the CPU's sdpa
    is the einsum path (no kernel launch) and the forward equals the
    reference's (1e-4 in f32, 0.05 in bf16)."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg, jp, tp = _jax_model("zamba2-2.7b", dtype, head_dim=80)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk)).astype(np.int32)
    want, _ = jax_get_model(cfg).forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    before = flash_attention.launches
    got, _ = get_model(cfg).forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert flash_attention.launches == before
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_mamba_and_shared_attn(arch):
    """Every leaf bitwise, the ``mamba`` leaves un-stacked per layer and
    ``shared_attn`` as it is; ``a_log``, ``d_skip`` and ``dt_bias`` stay f32
    in a bf16 model; the structure is the port's own init's."""
    cfg = jax_get_reduced(arch)
    assert cfg.dtype == "bfloat16"
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mamba = tp["layers"][1]["mamba"]
    for k in ("a_log", "d_skip", "dt_bias"):
        assert mamba[k].dtype == torch.float32, k
    assert mamba["in_proj"].dtype == torch.bfloat16
    assert ("shared_attn" in tp) == (arch == "zamba2-2.7b")

    def bits(x):
        x = np.asarray(x)
        return x.view(np.int16) if x.dtype.name == "bfloat16" else x

    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        t, want = tp, np.asarray(leaf)
        for key in keys:
            t = t[key]
            if key == "layers":
                t, want = t[1], want[1]
        np.testing.assert_array_equal(bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                           else t.numpy()), bits(want), err_msg=str(keys))
    fresh = get_model(get_reduced(arch)).init(torch.Generator().manual_seed(0), get_reduced(arch))
    shape = lambda tree: jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, tree))  # noqa: E731
    assert shape(fresh["layers"][0]) == shape(tp["layers"][0])
    assert shape({k: v for k, v in fresh.items() if k != "layers"}) == \
        shape({k: v for k, v in tp.items() if k != "layers"})


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family_on_the_cpu(capsys, arch):
    launch_serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "4", "--gen", "3",
                       "--context", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "cpu reduced config" in out


# --------------------------------------------------------------------------- #
# K6 / K7 plain versions at head dim 80 against the Pallas kernels (interpret)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal", [(64, True), (200, True), (300, False)])
def test_flash_attention_plain_at_d80_matches_pallas(dtype, s, causal):
    tol = {"float32": 2e-5, "bfloat16": 3e-2}[dtype]
    rng = np.random.default_rng(s + 80)
    q, k, v = (jnp.asarray(rng.normal(size=(2, s, 80)), JNP[dtype]) for _ in range(3))
    pallas = flash_attention_pallas(q, k, v, causal=causal, interpret=True)
    oracle = jax_ref.flash_attention(q, k, v, causal=causal)
    tq, tk, tv = _t(q), _t(k), _t(v)
    plain = flash_attention_plain(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal)[:, :, 0]
    for got in (plain, flash_attention(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal)[:, :, 0],
                ref.flash_attention(tq, tk, tv, causal)):
        assert got.dtype == tq.dtype
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,valid", [(2, 8, 8, 300, 300), (1, 8, 2, 700, 513), (2, 4, 4, 128, 1),
                                            (1, 4, 2, 96, 0)])
def test_flash_decode_plain_at_d80_matches_pallas(dtype, b, h, kv, s, valid):
    """Ragged cache lengths, one valid slot, and valid_len 0, where the
    Pallas kernel and the plain version give zeros (the oracle the mean of
    V, ROADMAP F6)."""
    tol = {"float32": 2e-5, "bfloat16": 3e-2}[dtype]
    rng = np.random.default_rng(b * 100 + s + valid)
    q = jnp.asarray(rng.normal(size=(b, h, 80)), JNP[dtype])
    k = jnp.asarray(rng.normal(size=(b, s, kv, 80)), JNP[dtype])
    v = jnp.asarray(rng.normal(size=(b, s, kv, 80)), JNP[dtype])
    pallas = flash_decode_pallas(q, k, v, jnp.asarray(valid), interpret=True)
    tq, tk, tv = _t(q), _t(k), _t(v)
    wants = [pallas] if valid == 0 else [pallas, jax_ref.flash_decode(q, k, v, valid)]
    gots = [flash_decode_plain(tq, tk, tv, valid), flash_decode(tq, tk, tv, torch.tensor(valid))]
    if valid:
        gots.append(ref.flash_decode(tq, tk, tv, valid))
    else:
        assert not np.asarray(pallas).any()
    for got in gots:
        assert got.dtype == tq.dtype
        for want in wants:
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
