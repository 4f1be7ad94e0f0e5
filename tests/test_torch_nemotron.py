"""The attention kernels' plain versions at head dim 192 and the dense
model at that head dim (``nemotron-4-340b``'s) against the JAX package, on
the CPU.

The reduced nemotron config keeps head dim 64, so these tests widen it to
the full config's 192 in both packages (``dataclasses.replace(reduced(),
head_dim=192)``: 2 layers, d_model 256, 4 / 2 heads, squared ReLU).  Inputs
are made with numpy from a seed and handed to both packages; JAX params are
carried into the port by ``params_from_jax``.  On the CPU the port's kernel
wrappers take their plain versions, so K6 and K7 at D = 192 are held here
against the Pallas kernels in interpret mode and the oracles, and the flash
branch (``REPRO_USE_FLASH=1`` in both packages) is the plain version against
Pallas; the CUDA instances are held to the plain versions in
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
from repro.models import attention as jax_attn
from repro.models import get_model as jax_get_model
from repro.serve import engine as jax_engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.models import attention, get_model
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.serve import ServeConfig, greedy_generate
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ARCH = "nemotron-4-340b"
D = 192
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _jax_model(dtype="float32", seed=1):
    cfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype, head_dim=D)
    jp = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --------------------------------------------------------------------------- #
# K6 / K7 plain versions at head dim 192 against the Pallas kernels (interpret)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal", [(64, True), (200, True), (200, False), (300, False)])
def test_flash_attention_plain_at_d192_matches_pallas(dtype, s, causal):
    """f32 within 2e-5, bf16 within 3e-2, causal and full, S ragged (200,
    300) and whole (64); the wrapper on CPU tensors and the oracle too."""
    tol = TOL[dtype]
    rng = np.random.default_rng(s + D + causal)
    q, k, v = (jnp.asarray(rng.normal(size=(2, s, D)), JNP[dtype]) for _ in range(3))
    pallas = flash_attention_pallas(q, k, v, causal=causal, interpret=True)
    oracle = jax_ref.flash_attention(q, k, v, causal=causal)
    tq, tk, tv = _t(q), _t(k), _t(v)
    plain = flash_attention_plain(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal)[:, :, 0]
    for got in (plain, flash_attention(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal)[:, :, 0],
                ops.flash_attention(tq, tk, tv, causal), ref.flash_attention(tq, tk, tv, causal)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kv,s,valid",
    [(2, 24, 2, 300, 300), (1, 12, 1, 700, 513), (2, 4, 4, 128, 1), (1, 12, 1, 96, 0),
     (2, 3, 3, 200, 77)],
)
def test_flash_decode_plain_at_d192_matches_pallas(dtype, b, h, kv, s, valid):
    """Group 12 (nemotron-4's 96 / 8) and group 1; the whole cache, a
    ragged valid_len, one valid slot, and valid_len 0, where the Pallas
    kernel and the plain version give zeros (the oracle the mean of V,
    ROADMAP F6)."""
    tol = TOL[dtype]
    rng = np.random.default_rng(b * 100 + s + valid + h)
    q = jnp.asarray(rng.normal(size=(b, h, D)), JNP[dtype])
    k = jnp.asarray(rng.normal(size=(b, s, kv, D)), JNP[dtype])
    v = jnp.asarray(rng.normal(size=(b, s, kv, D)), JNP[dtype])
    pallas = flash_decode_pallas(q, k, v, jnp.asarray(valid), interpret=True)
    tq, tk, tv = _t(q), _t(k), _t(v)
    wants = [pallas] if valid == 0 else [pallas, jax_ref.flash_decode(q, k, v, valid)]
    gots = [flash_decode_plain(tq, tk, tv, valid), flash_decode(tq, tk, tv, torch.tensor(valid)),
            ops.flash_decode(tq, tk, tv, valid)]
    if valid:
        gots.append(ref.flash_decode(tq, tk, tv, valid))
    else:
        assert not np.asarray(pallas).any()
    for got in gots:
        assert got.dtype == tq.dtype and got.shape == tq.shape
        for want in wants:
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 130, 200])
def test_flash_branch_at_d192_with_gqa_matches_jax(monkeypatch, s):
    """``REPRO_USE_FLASH=1``, q (B, S, 12, 192) on one KV head: the port's
    flash branch (the plain version, GQA routed) against the reference's
    (the KV head repeated 12 times, Pallas in interpret mode), f32 2e-5."""
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    rng = np.random.default_rng(s + 12)
    q = rng.normal(size=(1, s, 12, D)).astype(np.float32)
    k, v = (rng.normal(size=(1, s, 1, D)).astype(np.float32) for _ in range(2))
    want = jax_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    before = flash_attention.launches
    got = attention.sdpa(_t(q), _t(k), _t(v), causal=True)
    assert flash_attention.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# the dense model at head dim 192 (nemotron-4's squared-ReLU GQA)
# --------------------------------------------------------------------------- #
def test_the_full_config_has_head_dim_192_and_an_instance_for_it():
    cfg = get_config(ARCH)
    assert cfg.head_dim == D and cfg.num_heads // cfg.num_kv_heads == 12
    assert cfg.mlp_type == "squared_relu"
    assert get_reduced(ARCH).head_dim == 64  # why these tests widen it
    assert D in HEAD_DIMS
    assert attention.use_flash(torch.device("cuda"), D, D) is True


def test_params_from_jax_carries_the_192_wide_heads():
    cfg, jp, tp = _jax_model()
    layer = tp["layers"][0]
    assert tuple(layer["attn"]["wq"].shape) == (cfg.d_model, cfg.num_heads, D)
    assert tuple(layer["attn"]["wk"].shape) == (cfg.d_model, cfg.num_kv_heads, D)
    assert tuple(layer["attn"]["wo"].shape) == (cfg.num_heads * D, cfg.d_model)
    np.testing.assert_array_equal(layer["attn"]["wv"].numpy(), np.asarray(jp["layers"]["attn"]["wv"][0]))
    assert len(tp["layers"]) == cfg.num_layers == 2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("flash", ["0", "1"])
def test_forward_logits_at_d192_equal_jax(monkeypatch, dtype, tol, flash):
    """The whole model at B 2 x S 200: the einsum path (``=0``) and the
    flash branch (``=1``: the plain version here, Pallas in interpret mode
    in the reference), 1e-4 in f32 and 0.05 in bf16."""
    monkeypatch.setenv("REPRO_USE_FLASH", flash)
    cfg, jp, tp = _jax_model(dtype)
    toks = _tokens(cfg, 2, 200, seed=2)
    want, _ = jax_get_model(cfg).forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = get_model(cfg).forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) == 0.0 and tuple(got.shape) == (2, 200, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_decode_steps_and_caches_at_d192_equal_jax():
    """f32, B 2, 12 steps into a 16-slot cache: every step's logits within
    1e-4, then every layer's K and V cache within 1e-5."""
    cfg, jp, tp = _jax_model(seed=2)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    toks = _tokens(cfg, 2, 12, seed=5)
    jcache, tcache = jm.init_cache(cfg, 2, 16), tm.init_cache(cfg, 2, 16, "cpu")
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(12):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.asarray(i))
        tl, tcache = tm.decode_step(tp, cfg, {"tokens": _t(toks[:, i:i + 1]).long()}, tcache, i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for li in range(cfg.num_layers):
        for key in ("k", "v"):
            assert tcache["layers"][li][key].shape[-1] == D
            np.testing.assert_allclose(_np(tcache["layers"][li][key]),
                                       np.asarray(jcache["layers"][key][li]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flash", ["0", "1"])
def test_stepped_decode_at_d192_equals_the_forward(monkeypatch, flash):
    """The decode-parity contract on the port alone in f32 at 1e-4: 16
    stepped tokens against one forward, on either prefill path."""
    monkeypatch.setenv("REPRO_USE_FLASH", flash)
    cfg, _, tp = _jax_model(seed=3)
    tm = get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=6)).long()
    full, _ = tm.forward(tp, cfg, {"tokens": toks})
    cache = tm.init_cache(cfg, 2, 16, "cpu")
    steps = [tm.decode_step(tp, cfg, {"tokens": toks[:, i:i + 1]}, cache, i)[0] for i in range(16)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("context", [64, 12])
def test_greedy_generate_at_d192_tokens_equal_jax(context):
    """f32, batch 3, a 6-token prompt and 10 new tokens; context 12 runs
    the ring buffer past its end.  The tokens equal the reference's
    exactly."""
    cfg, jp, tp = _jax_model()
    prompt = _tokens(cfg, 3, 6, seed=7)
    want = jax_engine.greedy_generate(jp, cfg, jnp.asarray(prompt), 10,
                                      jax_engine.ServeConfig(3, context))
    got = greedy_generate(tp, cfg, torch.from_numpy(prompt), 10, ServeConfig(3, context))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
