"""The port's dense transformer and its attention kernels against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried into the port by ``params_from_jax``.  On the CPU the
port's kernel wrappers take their plain versions, so the flash tests hold
those against the Pallas kernels in interpret mode (``REPRO_USE_FLASH=1``
in both packages) and against the oracles.  The CUDA kernels are held
against the plain versions in ``test_torch_cuda.py``, which needs a card.
Also here: the guard that no module of the port, nor ``chip_smoke.py``,
imports JAX or the JAX package.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import attention as jax_attn
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import mlp as jax_mlp
from repro_torch.configs import ARCH_IDS, get_config, get_reduced, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.models import attention, get_model, layers, mlp
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _reduced(arch, dtype):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype)


def _jax_model(arch, dtype, seed=1):
    cfg = _reduced(arch, dtype)
    params = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")


@pytest.fixture
def flash_env(monkeypatch):
    """Set ``REPRO_USE_FLASH`` for both packages for one test."""

    def set_to(value):
        monkeypatch.setenv("REPRO_USE_FLASH", value)

    return set_to


# --------------------------------------------------------------------------- #
# the rule that the port stands alone
# --------------------------------------------------------------------------- #
def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "for m in ('workloads.' + w for w in ('schema', 'generators', 'failures', 'loaders',\n"
        "                                     'scenarios')):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "for m in ('common', 'evaluate', 'scalability'):\n"
        "    assert 'repro_torch.benchmarks.' + m in sys.modules, m\n"
        "for m in ('train.optimizer', 'train.data', 'train.step', 'train.checkpoint',\n"
        "          'models.scan_util', 'models.encdec', 'launch.train', 'launch.mesh',\n"
        "          'launch.pspec', 'launch.specs', 'roofline'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "assert 'benchmarks' not in sys.modules\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 40  # every module of the port was imported


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_configs_equal_the_reference(arch):
    for get_t, get_j in ((get_config, jax_get_config), (get_reduced, jax_get_reduced)):
        c_t, c_j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    assert ARCH_IDS == JAX_ARCH_IDS


def test_llama3_8b_is_eight_billion_parameters():
    cfg = get_config("llama3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        32, 4096, 32, 8, 128)
    assert 8.0e9 < cfg.param_count() < 8.1e9


# --------------------------------------------------------------------------- #
# primitive layers, f32 at 1e-6
# --------------------------------------------------------------------------- #
def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 4, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 37))
    mpos = rng.integers(0, 300, (3, 2, 37))
    pairs = [
        (jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
         layers.rms_norm(_t(x), _t(scale), 1e-5)),
        (jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5),
         layers.apply_rope(_t(x), _t(pos), 5e5)),
        (jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), 1e6),
         layers.apply_mrope(_t(x), _t(mpos), 1e6)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert layers.mrope_sections(128) == jax_layers.mrope_sections(128) == (22, 21, 21)
    np.testing.assert_array_equal(layers.rope_frequencies(128, 5e5),
                                  jax_layers.rope_frequencies(128, 5e5))


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_ffn_matches_jax(mlp_type):
    cfg = dataclasses.replace(_reduced("llama3-8b", "float32"), mlp_type=mlp_type)
    p = jax_mlp.init_ffn(jax.random.PRNGKey(0), cfg, cfg.d_ff, jnp.float32)
    h = np.random.default_rng(1).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    want = jax_mlp.ffn(p, cfg, jnp.asarray(h))
    got = mlp.ffn({k: _t(v) for k, v in p.items()}, cfg, _t(h))
    # 1e-6 of the output's scale: the two f32 GEMMs (XLA's, torch's) sum
    # the 512-long hidden contraction in different orders, and squared-ReLU's
    # hidden values reach ~10, so absolute differences reach ~2e-6 there
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6 * scale)


def test_port_init_has_the_reference_layouts_and_scale():
    cfg = _reduced("qwen3-14b", "float32")
    jp = jax.tree.map(np.asarray, jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg))
    tp = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    assert set(tp) == set(jp)
    assert len(tp["layers"]) == cfg.num_layers
    for key, arr in jax.tree_util.tree_flatten_with_path(jp["layers"])[0]:
        names = [k.key for k in key]
        t = tp["layers"][0]
        for n in names:
            t = t[n]
        assert tuple(t.shape) == arr.shape[1:], names
        assert abs(float(t.float().std()) - float(arr[0].std())) < 0.1 * float(arr[0].std()) + 1e-6
    wq = tp["layers"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6  # truncated at 2 sigma


def test_params_from_jax_carries_bf16_bits():
    cfg, jparams, tparams = _jax_model("llama3-8b", "bfloat16")
    want = np.asarray(jparams["layers"]["attn"]["wq"][1]).view(np.uint16)
    got = tparams["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


# --------------------------------------------------------------------------- #
# sdpa: the einsum path and the flash branch
# --------------------------------------------------------------------------- #
def _qkv(seed, b, s, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case", ["causal", "non_causal", "valid_len", "q_offset", "decode"]
)
def test_einsum_sdpa_matches_jax(flash_env, dtype, case):
    flash_env("0")
    s, t = {"decode": (1, 24), "q_offset": (5, 24)}.get(case, (17, 17))
    q, k, v = _qkv(3, 2, s, t, 4, 2, 32)
    kw = {
        "causal": dict(causal=True),
        "non_causal": dict(causal=False),
        "valid_len": dict(causal=False, kv_valid_len=11),
        "q_offset": dict(causal=True, q_offset=19),
        "decode": dict(causal=False, kv_valid_len=9),
    }[case]
    jkw = {k2: (jnp.asarray(v2) if k2 != "causal" else v2) for k2, v2 in kw.items()}
    want = jax_attn.sdpa(*(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)), **jkw)
    got = attention.sdpa(*(_t(a).to(layers.dtype_of(dtype)) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("s", [1, 127, 128, 200, 640])
def test_flash_branch_matches_jax_flash_branch(flash_env, s):
    """``REPRO_USE_FLASH=1`` in both packages: JAX runs the Pallas kernel in
    interpret mode on repeated KV heads, the port the kernel's plain
    version with GQA routing; both against JAX's einsum path too."""
    q, k, v = _qkv(s, 1, s, s, 4, 2, 64)
    flash_env("1")
    want = jax_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    before = flash_attention.launches
    got = attention.sdpa(_t(q), _t(k), _t(v), causal=True)
    assert flash_attention.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    flash_env("0")
    einsum = jax_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(_np(got), _np(einsum), rtol=2e-5, atol=2e-5)


def test_flash_default_follows_the_device(monkeypatch):
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    assert attention.use_flash(torch.device("cuda"), 128, 128) is True
    assert attention.use_flash(torch.device("cpu"), 128, 128) is False
    monkeypatch.setenv("REPRO_USE_FLASH", "0")
    assert attention.use_flash(torch.device("cuda"), 128, 128) is False
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    assert attention.use_flash(torch.device("cpu"), 128, 128) is True


@pytest.mark.parametrize("d,kernel", [(64, True), (128, True), (80, True), (192, True), (96, False)])
def test_flash_branch_routes_by_head_dim(monkeypatch, d, kernel):
    """Unset, CUDA tensors take the kernel only at a head dim it has an
    instance for; every other head dim takes the einsum path, as the
    reference's default does.  ``REPRO_USE_FLASH=1`` asks for the kernel at
    any head dim (on the card an unsupported one raises there), and the CPU
    never takes the kernel unasked."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    assert attention.use_flash(torch.device("cuda"), d, d) is kernel
    assert attention.use_flash(torch.device("cpu"), d, d) is False
    assert (d in HEAD_DIMS) is kernel
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    assert attention.use_flash(torch.device("cuda"), d, d) is True
    monkeypatch.setenv("REPRO_USE_FLASH", "0")
    assert attention.use_flash(torch.device("cuda"), d, d) is False


@pytest.mark.parametrize("d", [80, 96, 192])
def test_sdpa_at_a_head_dim_without_a_kernel_is_the_reference_einsum(monkeypatch, d):
    """96, which K6 has no instance for, and zamba2's 80 and nemotron-4's
    192, which it has (the card launches them): unset, the CPU's sdpa at
    each is the reference's default einsum path (2e-5, f32), with no
    launch."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    q, k, v = _qkv(d, 1, 48, 48, 4, 2, d)
    want = jax_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    before = flash_attention.launches
    got = attention.sdpa(_t(q), _t(k), _t(v), causal=True)
    assert flash_attention.launches == before
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# K6 / K7 plain versions against the Pallas kernels (interpret) and oracles
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal", [(64, True), (200, True), (300, False), (700, True)])
def test_flash_attention_plain_matches_pallas(dtype, s, causal):
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(3, s, 64)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True)
    oracle = jax_ref.flash_attention(jq, jk, jv, causal=causal)
    tq, tk, tv = (_t(np.asarray(a)) for a in (jq, jk, jv))
    plain = flash_attention_plain(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal)[:, :, 0]
    via_ops = ops.flash_attention(tq, tk, tv, causal)
    port_oracle = ref.flash_attention(tq, tk, tv, causal)
    for got in (plain, via_ops, port_oracle):
        assert got.dtype == tq.dtype
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_attention_gqa_routing_equals_ops_on_repeated_kv():
    q, k, v = _qkv(5, 2, 130, 130, 6, 2, 64)
    gqa = flash_attention(_t(q), _t(k), _t(v))
    kr, vr = (np.repeat(a, 3, axis=2) for a in (k, v))
    bhsd = ops.flash_attention(*(_t(a).transpose(1, 2) for a in (q, kr, vr)))
    assert tuple(bhsd.shape) == (2, 6, 130, 64)
    np.testing.assert_allclose(_np(gqa), _np(bhsd.transpose(1, 2)), rtol=1e-6, atol=1e-6)
    want = jax_ref.flash_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3).reshape(12, 130, 64)
                                     for a in (q, kr, vr)))
    np.testing.assert_allclose(_np(bhsd.reshape(12, 130, 64)), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kv,s,d,valid",
    [(1, 4, 4, 128, 64, 128), (2, 8, 2, 512, 64, 7), (2, 8, 2, 512, 64, 511),
     (1, 12, 2, 1024, 128, 600), (2, 8, 8, 300, 64, 300), (1, 4, 2, 700, 64, 513)],
)
def test_flash_decode_plain_matches_pallas(dtype, b, h, kv, s, d, valid):
    rng = np.random.default_rng(b * 100 + s + valid)
    q = jnp.asarray(rng.normal(size=(b, h, d)), JNP[dtype])
    k = jnp.asarray(rng.normal(size=(b, s, kv, d)), JNP[dtype])
    v = jnp.asarray(rng.normal(size=(b, s, kv, d)), JNP[dtype])
    pallas = flash_decode_pallas(q, k, v, jnp.asarray(valid), interpret=True)
    oracle = jax_ref.flash_decode(q, k, v, valid)
    tq, tk, tv = _t(q), _t(k), _t(v)
    for got in (flash_decode_plain(tq, tk, tv, valid), ops.flash_decode(tq, tk, tv, valid),
                flash_decode(tq, tk, tv, torch.tensor(valid)), ref.flash_decode(tq, tk, tv, valid)):
        assert got.dtype == tq.dtype
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_at_zero_valid_len_gives_zeros_and_the_oracle_the_mean():
    """F6: the Pallas kernel skips every tile and returns zeros; the oracle's
    softmax over all -1e30 logits is flat, so it returns the mean of V.  The
    port's kernel and plain version follow the kernel, its oracle the oracle."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=sh), jnp.float32)
               for sh in ((1, 4, 64), (1, 96, 2, 64), (1, 96, 2, 64)))
    pallas = np.asarray(flash_decode_pallas(q, k, v, jnp.asarray(0), interpret=True))
    oracle = np.asarray(jax_ref.flash_decode(q, k, v, 0))
    assert not pallas.any()
    mean = np.repeat(np.asarray(v).mean(axis=1), 2, axis=1)  # (1, H, D): group mean per head
    np.testing.assert_allclose(oracle, mean, rtol=1e-5, atol=1e-5)
    assert np.abs(oracle).max() > 0.05
    tq, tk, tv = _t(q), _t(k), _t(v)
    np.testing.assert_array_equal(flash_decode_plain(tq, tk, tv, 0).numpy(), pallas)
    np.testing.assert_array_equal(ops.flash_decode(tq, tk, tv, 0).numpy(), pallas)
    np.testing.assert_allclose(ref.flash_decode(tq, tk, tv, 0).numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_flash_contract_raises():
    q = torch.zeros(2, 8, 64)
    kv = torch.zeros(2, 16, 3, 64)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_decode(q, kv, kv, 4)
    with pytest.raises(ValueError, match="scalar"):
        ops.flash_decode(q, torch.zeros(2, 16, 2, 64), torch.zeros(2, 16, 2, 64), torch.tensor([4, 4]))
    with pytest.raises(ValueError, match="cache shapes differ"):
        ops.flash_decode(q, torch.zeros(2, 16, 2, 64), torch.zeros(2, 15, 2, 64), 4)
    with pytest.raises(ValueError, match="batch or head dim"):
        ops.flash_decode(q, torch.zeros(3, 16, 2, 64), torch.zeros(3, 16, 2, 64), 4)
    with pytest.raises(ValueError, match=r"want q \(B,H,D\)"):
        ops.flash_decode(q[0], kv, kv, 4)
    x = torch.zeros(2, 4, 16, 64)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.flash_attention(x, x, torch.zeros(2, 4, 16, 32))
    with pytest.raises(ValueError, match=r"\(B,H,S,D\) or \(BH,S,D\)"):
        ops.flash_attention(x[0, 0], x[0, 0], x[0, 0])
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(torch.zeros(1, 16, 4, 64), torch.zeros(1, 16, 3, 64),
                        torch.zeros(1, 16, 3, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))


# --------------------------------------------------------------------------- #
# the dense transformer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-14b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", ["0", "1"])
def test_forward_logits_match_jax(flash_env, arch, dtype, flash):
    flash_env(flash)
    cfg, jparams, tparams = _jax_model(arch, dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 200)).astype(np.int32)
    want, _ = jax_get_model(cfg).forward(jparams, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = get_model(cfg).forward(tparams, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == layers.dtype_of(dtype) and float(aux) == 0.0
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_vlm_forward_with_mrope_matches_jax(flash_env):
    flash_env("0")
    cfg, jparams, tparams = _jax_model("qwen2-vl-2b", "float32")
    assert cfg.mrope and cfg.frontend == "vision"
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    img = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    mpos = rng.integers(0, 30, (3, 1, 30)).astype(np.int32)
    batch = dict(tokens=toks, image_embeds=img, mrope_positions=mpos)
    want, _ = jax_get_model(cfg).forward(jparams, cfg, {k: jnp.asarray(a) for k, a in batch.items()})
    got, _ = get_model(cfg).forward(tparams, cfg, {k: _t(a) for k, a in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_decode_steps_and_caches_match_jax():
    cfg, jparams, tparams = _jax_model("llama3-8b", "float32")
    jm, tm = jax_get_model(cfg), get_model(cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jcache, tcache = jm.init_cache(cfg, 2, 16), tm.init_cache(cfg, 2, 16, "cpu")
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(12):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.asarray(i))
        tl, tcache = tm.decode_step(tparams, cfg, {"tokens": _t(toks[:, i:i + 1]).long()},
                                    tcache, i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for li in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tcache["layers"][li][key]),
                                       np.asarray(jcache["layers"][key][li]), rtol=1e-5, atol=1e-5)


def test_decode_matches_forward(flash_env):
    """The reference's decode-parity contract on the port alone (bf16, the
    flash branch in the forward)."""
    flash_env("1")
    cfg, _, tparams = _jax_model("llama3-8b", "bfloat16")
    tm = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)))
    full, _ = tm.forward(tparams, cfg, {"tokens": toks})
    cache = tm.init_cache(cfg, 2, 16, "cpu")
    steps = [tm.decode_step(tparams, cfg, {"tokens": toks[:, i:i + 1]}, cache, i)[0]
             for i in range(16)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full), rtol=0.05, atol=0.05)


def test_ring_buffer_past_the_window_matches_jax():
    """Decode 20 tokens through an 8-slot cache (test_arch_smoke.py's ring
    buffer): every step's logits and the final ring equal JAX's."""
    cfg, jparams, tparams = _jax_model("llama3-8b", "float32", seed=2)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    window = 8
    jcache, tcache = jm.init_cache(cfg, 1, window), tm.init_cache(cfg, 1, window, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 20)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, {"tokens": t}, c, pos))
    for i in range(20):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.asarray(i))
        tl, tcache = tm.decode_step(tparams, cfg, {"tokens": _t(toks[:, i:i + 1]).long()},
                                    tcache, torch.tensor(i))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    assert np.isfinite(_np(tl)).all()
    np.testing.assert_allclose(_np(tcache["layers"][1]["k"]), np.asarray(jcache["layers"]["k"][1]),
                               rtol=1e-5, atol=1e-5)


def test_get_model_returns_the_encoder_decoder():
    from repro_torch.models import encdec

    for cfg in (get_config("seamless-m4t-medium"), get_reduced("seamless-m4t-medium")):
        assert cfg.is_encoder_decoder and get_model(cfg) is encdec
