"""The port's multi-head latent attention (DeepSeek-V2's MLA) against the
JAX package on the CPU, on ``deepseek-v2-236b``'s reduced config.

Inputs are made with numpy from a seed and handed to both packages; the
JAX params are carried into the port.  MLA's q/k head dim (192 at full
size, 48 reduced) differs from v's (128, 32 reduced); K6 has an instance at
192 but takes q, k and v of one head dim, so ``sdpa`` routes by v's head
dim too and takes the einsum path with v's own head dim, and forcing the
flash branch raises, as it fails in the reference (ROADMAP F7).  The whole-model MoE + MLA checks are in
``test_torch_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import attention
from repro_torch.models.convert import tensor_from_numpy
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _mla(dtype="float32", seed=0):
    cfg = dataclasses.replace(jax_get_reduced("deepseek-v2-236b"), dtype=dtype)
    jp = jax_attn.init_mla(jax.random.PRNGKey(seed), cfg, JNP[dtype])
    return cfg, jp, {k: _t(v) for k, v in jp.items()}


def _hidden(cfg, b, s, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, JNP[dtype])


def test_init_mla_has_the_reference_layouts():
    cfg = get_reduced("deepseek-v2-236b")
    _, jp, _ = _mla()
    tp = attention.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert not tp["kv_norm"].any()
    d = cfg.d_model
    assert abs(float(tp["wq"].std()) * d**0.5 - 0.88) < 0.05  # truncated normal at +-2


def test_the_full_config_routes_mla_to_the_einsum_path(monkeypatch):
    """K6 has an instance at MLA's q/k head dim 192 (nemotron-4's), so the
    route turns on v's head dim: 128 sends MLA to the einsum path on a CUDA
    device, while GQA at 192 (v 192) takes the kernel."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = get_config("deepseek-v2-236b")
    qk, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert qk == 192 and vd == 128
    assert qk in HEAD_DIMS
    cuda = torch.device("cuda")
    assert attention.use_flash(cuda, qk, vd) is False
    assert attention.use_flash(cuda, qk, qk) is True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_equals_jax(dtype, causal):
    cfg, jp, tp = _mla(dtype)
    x = _hidden(cfg, 2, 24, seed=1, dtype=dtype)
    positions = np.broadcast_to(np.arange(24)[None], (2, 24)).astype(np.int32)
    want = jax_attn.mla_forward(jp, cfg, x, jnp.asarray(positions), causal=causal)
    got = attention.mla_forward(tp, cfg, _t(x), torch.from_numpy(positions.copy()).long(),
                                causal=causal)
    assert got.dtype == tp["wq"].dtype and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("cache_len", [16, 6])
def test_mla_decode_steps_and_the_latent_cache_equal_jax(cache_len):
    """f32, batch 2, 10 steps: each step's output within 1e-5 and the
    latent cache (ckv, k_rope) within 1e-6; a 6-slot cache is a ring
    buffer past its length."""
    cfg, jp, tp = _mla()
    x = np.asarray(_hidden(cfg, 2, 10, seed=2, dtype="float32"))
    jc = jax_attn.init_mla_cache(cfg, 2, cache_len, jnp.float32)
    tc = attention.init_mla_cache(cfg, 2, cache_len, torch.float32, "cpu")
    assert {k: v.shape for k, v in jc.items()} == {k: tuple(v.shape) for k, v in tc.items()}
    step = jax.jit(lambda p, x, c, pos: jax_attn.mla_decode_step(p, cfg, x, c, pos))
    for i in range(10):
        want, jc = step(jp, jnp.asarray(x[:, i:i + 1]), jc, jnp.asarray(i))
        got, tc = attention.mla_decode_step(tp, cfg, torch.from_numpy(x[:, i:i + 1].copy()), tc,
                                            torch.tensor(i))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5, err_msg=f"step {i}")
    for k in ("ckv", "k_rope"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_absorbed_decode_equals_the_forward():
    """The port alone, f32: stepping 12 tokens through the latent cache
    gives ``mla_forward``'s causal output row by row within 1e-5."""
    cfg, _, tp = _mla()
    x = torch.from_numpy(np.array(_hidden(cfg, 1, 12, seed=3, dtype="float32")))
    full = attention.mla_forward(tp, cfg, x, torch.arange(12)[None])
    cache = attention.init_mla_cache(cfg, 1, 12, torch.float32, "cpu")
    for i in range(12):
        out, cache = attention.mla_decode_step(tp, cfg, x[:, i:i + 1], cache, i)
        torch.testing.assert_close(out[:, 0], full[:, i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_einsum_sdpa_takes_the_value_head_dim(causal):
    """q/k at head dim 192, v at 128 (MLA's full widths), 4 heads: the
    port's ``sdpa`` equals the reference's within 1e-5."""
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((1, 20, 4, 192)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 20, 4, 128)).astype(np.float32)
    want = jax_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == (1, 20, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_forced_on_mla_raises_as_in_the_reference(monkeypatch):
    """``REPRO_USE_FLASH=1``: the flash branch cannot take q/k and v of
    different head dims, in the port as in the reference (F7)."""
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    cfg, jp, tp = _mla()
    x = _hidden(cfg, 1, 8, seed=5, dtype="float32")
    positions = np.arange(8, dtype=np.int32)[None]
    with pytest.raises(Exception):
        jax_attn.mla_forward(jp, cfg, x, jnp.asarray(positions))
    with pytest.raises(ValueError, match="k/v shapes differ"):
        attention.mla_forward(tp, cfg, _t(x), torch.from_numpy(positions).long())
