"""The port's encoder-decoder (``seamless-m4t-medium`` at its reduced size)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried into the port by ``params_from_jax``.  Held in f32 at
1e-4: the encoder, the cross-attention, the forward, every decode step
(against zero cross K/V, as ``greedy_generate`` serves in both packages,
ROADMAP D15, and against the cross K/V ``prefill_cross`` computes), and the
greedy tokens exactly.  On the CPU every attention takes the einsum path;
the decoder's causal self-attention reaches K6 on the card
(``test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import encdec as jax_encdec
from repro.models import get_model as jax_get_model
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, greedy_generate
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype, **kw)


def _models(dtype="float32", seed=1, **kw):
    cfg = _cfg(dtype, **kw)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _frames(cfg, b, seed, scale=0.02):
    return (np.random.default_rng(seed).standard_normal((b, cfg.frontend_len, cfg.d_model))
            .astype(np.float32) * scale)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batch(frames, tokens):
    """The same batch for both packages: (JAX's, the port's)."""
    return ({"audio_frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"audio_frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens).long()})


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=msg)


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_the_reference_layouts(dtype):
    """Every leaf of the port's init has the reference's shape and dtype,
    the stacked layers as lists of ``encoder_layers`` / ``num_layers``
    per-layer dicts; the norms start at zero."""
    cfg = _cfg(dtype, encoder_layers=3)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tp = encdec.init(torch.Generator().manual_seed(0), cfg)
    assert set(tp) == set(jp)
    assert len(tp["enc_layers"]) == 3 and len(tp["dec_layers"]) == cfg.num_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        t, shape = tp, tuple(leaf.shape)
        for key in keys:
            t = t[key]
            if key in ("enc_layers", "dec_layers"):
                t, shape = t[1], shape[1:]
        assert tuple(t.shape) == shape and str(t.dtype).split(".")[1] == str(leaf.dtype), keys
        if "norm" in keys[-1]:
            assert not t.any(), keys


def test_params_from_jax_unstacks_both_stacks():
    """Every leaf bitwise; ``enc_layers`` by ``encoder_layers``,
    ``dec_layers`` by ``num_layers``; the structure is the port's own
    init's."""
    cfg = _cfg("bfloat16", encoder_layers=3)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert len(tp["enc_layers"]) == 3 and len(tp["dec_layers"]) == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        t, want = tp, np.asarray(leaf)
        for key in keys:
            t = t[key]
            if key in ("enc_layers", "dec_layers"):
                t, want = t[-1], want[-1]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16),
                                      err_msg=str(keys))
    fresh = encdec.init(torch.Generator().manual_seed(0), cfg)
    shape = lambda tree: jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, tree))  # noqa: E731
    assert shape(fresh) == shape(tp)


# --------------------------------------------------------------------------- #
# the encoder and the cross-attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_equals_jax(dtype):
    cfg, jp, tp = _models(dtype)
    frames = _frames(cfg, 2, seed=3, scale=1.0)
    want = jax_encdec.encode(jp, cfg, jnp.asarray(frames))
    got = encdec.encode(tp, cfg, torch.from_numpy(frames))
    assert got.shape == (2, cfg.frontend_len, cfg.d_model) and got.dtype == tp["embed"].dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("s", [1, 5, 40])
def test_cross_attention_equals_jax(s):
    """Queries from the decoder (S positions), K/V from F = 32 encoder
    frames, non-causal, on layer 1's weights."""
    cfg, jp, tp = _models()
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jcross = jax.tree.map(lambda a: a[1], jp["dec_layers"]["cross_attn"])
    want = jax_encdec._cross_attention(jcross, cfg, jnp.asarray(h), jnp.asarray(enc_out))
    got = encdec._cross_attention(tp["dec_layers"][1]["cross_attn"], cfg, torch.from_numpy(h),
                                  torch.from_numpy(enc_out))
    _close(got, want, 1e-4)


def test_encode_of_zero_frames_is_exactly_zero():
    """Every encoder sub-layer is linear with no bias on a zero input,
    gelu(0) = 0 and rms_norm(0) = 0, so ``encode`` of zeros is exact zeros,
    and ``prefill_cross`` over it gives the zero cross K/V ``init_cache``
    makes (D15) — in both packages, at full depth of the reduced config."""
    cfg, jp, tp = _models("bfloat16")
    zeros = np.zeros((2, cfg.frontend_len, cfg.d_model), np.float32)
    got = encdec.encode(tp, cfg, torch.from_numpy(zeros))
    assert not got.any()
    assert not np.asarray(jax_encdec.encode(jp, cfg, jnp.asarray(zeros)), np.float32).any()
    ks, vs = encdec.prefill_cross(tp, cfg, got)
    cache = encdec.init_cache(cfg, 2, 8, "cpu")
    assert torch.equal(ks, cache["cross_k"]) and torch.equal(vs, cache["cross_v"])


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_equal_jax(dtype):
    cfg, jp, tp = _models(dtype)
    jb, tb = _batch(_frames(cfg, 2, seed=4), _tokens(cfg, 2, 24, seed=5))
    want, jaux = jax_get_model(cfg).forward(jp, cfg, jb)
    got, aux = get_model(cfg).forward(tp, cfg, tb)
    assert got.shape == (2, 24, cfg.vocab_size) and float(aux) == 0.0 == float(jaux)
    _close(got, want, TOL[dtype])


def test_prefill_cross_equals_jax():
    cfg, jp, tp = _models()
    enc = _frames(cfg, 2, seed=6, scale=1.0)
    jk, jv = jax_encdec.prefill_cross(jp, cfg, jnp.asarray(enc))
    tk, tv = encdec.prefill_cross(tp, cfg, torch.from_numpy(enc))
    assert tk.shape == (cfg.num_layers, 2, cfg.frontend_len, cfg.num_kv_heads, cfg.head_dim)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


def _cache_pair(cfg, jp, tp, b, cache_len, frames=None):
    """Both packages' serving caches; with ``frames``, the cross K/V filled
    by ``prefill_cross`` over their encoding."""
    jc = jax_encdec.init_cache(cfg, b, cache_len)
    tc = encdec.init_cache(cfg, b, cache_len, "cpu")
    if frames is not None:
        jk, jv = jax_encdec.prefill_cross(jp, cfg, jax_encdec.encode(jp, cfg, jnp.asarray(frames)))
        jc = dict(jc, cross_k=jk, cross_v=jv)
        tc["cross_k"], tc["cross_v"] = encdec.prefill_cross(
            tp, cfg, encdec.encode(tp, cfg, torch.from_numpy(frames)))
    return jc, tc


@pytest.mark.parametrize("cross", ["zero", "prefilled"])
def test_decode_steps_and_caches_equal_jax(cross):
    """f32, B 2, 12 steps through a 16-slot cache: every step's logits
    within 1e-4 of JAX's, with the cross K/V zero (as served) or filled by
    ``prefill_cross``; after them every layer's self-attention K/V within
    1e-5, written in place."""
    cfg, jp, tp = _models(seed=2)
    frames = None if cross == "zero" else _frames(cfg, 2, seed=7)
    jc, tc = _cache_pair(cfg, jp, tp, 2, 16, frames)
    toks = _tokens(cfg, 2, 12, seed=8)
    jm = jax_get_model(cfg)
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(12):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(i))
        tl, tc2 = encdec.decode_step(tp, cfg, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
                                     tc, torch.tensor(i))
        assert tc2 is tc
        _close(tl, jl, 1e-4, f"step {i}")
    assert set(tc) == set(jc) == {"layers", "cross_k", "cross_v"}
    for key in ("k", "v"):
        for i, c in enumerate(tc["layers"]):
            _close(c[key], jc["layers"][key][i], 1e-5, f"{key} {i}")


def test_greedy_generate_equals_jax_step_by_step():
    """``greedy_generate`` (zero cross K/V in both packages, D15): the tokens
    exactly, and every step's logits within 1e-4 of the reference's decode
    step on the same tokens."""
    cfg, jp, tp = _models()
    prompt = _tokens(cfg, 3, 6, seed=9)
    sc = jax_engine.ServeConfig(3, 64)
    want = np.asarray(jax_engine.greedy_generate(jp, cfg, jnp.asarray(prompt), 10, sc))
    got, logits = greedy_generate(tp, cfg, torch.from_numpy(prompt), 10, ServeConfig(3, 64),
                                  return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    jm = jax_get_model(cfg)
    jc = jax_engine.init_serving_cache(cfg, sc)
    for i in range(want.shape[1] - 1):
        jl, jc = jm.decode_step(jp, cfg, {"tokens": jnp.asarray(want[:, i:i + 1])}, jc, jnp.asarray(i))
        _close(logits[:, i], jl[:, 0], 1e-4, f"step {i}")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_served_decode_equals_the_forward_on_zero_frames(dtype, tol):
    """D15: the function ``greedy_generate`` steps is ``forward`` with zero
    audio frames (the reference's decode-parity contract, 0.05 in bf16)."""
    cfg, _, tp = _models(dtype, seed=3)
    prompt = torch.from_numpy(_tokens(cfg, 2, 4, seed=10)).long()
    seq, steps = greedy_generate(tp, cfg, prompt, 12, ServeConfig(2, 32), return_logits=True)
    zeros = torch.zeros((2, cfg.frontend_len, cfg.d_model))
    full, _ = encdec.forward(tp, cfg, {"audio_frames": zeros, "tokens": seq})
    _close(steps, full[:, :-1], tol)


@pytest.mark.parametrize("frames_seed", [11, 12])
def test_prefill_cross_then_decode_equals_the_forward(frames_seed):
    """``prefill_cross`` over ``encode(frames)`` into the cache, then one
    ``decode_step`` a token: every step within 1e-4 of ``forward`` on the
    same frames, in the port and against the reference's forward."""
    cfg, jp, tp = _models(seed=4)
    frames, toks = _frames(cfg, 2, seed=frames_seed), _tokens(cfg, 2, 10, seed=frames_seed)
    jb, tb = _batch(frames, toks)
    want, _ = jax_get_model(cfg).forward(jp, cfg, jb)
    full, _ = encdec.forward(tp, cfg, tb)
    _, cache = _cache_pair(cfg, jp, tp, 2, 16, frames)
    steps = [encdec.decode_step(tp, cfg, {"tokens": tb["tokens"][:, i:i + 1]}, cache, i)[0]
             for i in range(toks.shape[1])]
    steps = torch.cat(steps, dim=1)
    _close(steps, full, 1e-4)
    _close(steps, want, 1e-4)
    # the frames matter: against zero cross K/V the steps part from the forward
    assert (steps - encdec.forward(tp, cfg, dict(tb, audio_frames=torch.zeros_like(
        tb["audio_frames"])))[0]).abs().max() > 1e-3


def test_serving_cache_layout():
    cfg = get_reduced(ARCH)
    cache = encdec.init_cache(cfg, 3, 16, "cpu")
    assert len(cache["layers"]) == cfg.num_layers
    assert cache["layers"][0]["k"].shape == (3, 16, cfg.num_kv_heads, cfg.head_dim)
    for key in ("cross_k", "cross_v"):
        assert cache[key].shape == (cfg.num_layers, 3, cfg.frontend_len, cfg.num_kv_heads,
                                    cfg.head_dim)
        assert cache[key].dtype == torch.bfloat16 and not cache[key].any()


def test_launcher_serves_the_encoder_decoder_on_the_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4", "--gen", "3",
                       "--context", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=seamless-smoke generated 6 tokens" in out and "cpu reduced config" in out

