"""The port's training path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's params and train state are carried into the port by
``params_from_jax`` / ``train_state_from_jax``.  Covered: the data
pipeline (byte for byte), AdamW, the loss and one train step (microbatches
1 and 2, the five dense archs' reduced configs, f32 and bf16, and in f32 the
MoE and MLA archs, whose loss carries the routers' aux, the SSM and
hybrid archs, and the encoder-decoder), the remat
policies, checkpoint files in both directions (the encoder-decoder's
two stacks too), ``train_loop``, the routing
rule that keeps the flash kernel off the autograd path (ROADMAP D8), the
two knobs of the einsum ``sdpa``, and the launcher.  The training path
launches no kernel: attention takes the einsum path under autograd.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.train import train_loop as jax_train_loop
from repro.models import attention as jax_attn
from repro.train import checkpoint as jax_ckpt
from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, scan_util, transformer
from repro_torch.models.convert import params_from_jax, tensor_from_numpy, train_state_from_jax
from repro_torch.models.layers import dtype_of
from repro_torch.train import checkpoint, data, optimizer, step
from repro_torch.train.optimizer import tree_leaves
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

DENSE = ["llama3-8b", "deepseek-67b", "qwen3-14b", "nemotron-4-340b", "qwen2-vl-2b"]
#: MoE (dbrx) and MLA + MoE (deepseek-v2): their loss carries the routers' aux
MOE = ["dbrx-132b", "deepseek-v2-236b"]
#: the SSM (mamba2) and the hybrid (zamba2): trained on the CPU only so far
SSM = ["mamba2-780m", "zamba2-2.7b"]
#: the encoder-decoder (seamless-m4t): its batch carries the audio frames
ENCDEC = ["seamless-m4t-medium"]
F32_TOL = 1e-5  # relative L2, every leaf and metric, in f32
BF16_TOL = 2e-2  # relative, the loss and grad norm in each arch's default bf16
BATCH, SEQ = 2, 32


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    scale = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (scale if scale > 0 else 1.0))


def _paths(tree, prefix=""):
    """(path, tensor) pairs in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _reduced(arch, dtype=None):
    cfg = jax_get_reduced(arch)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _batch(cfg, batch=BATCH, seq=SEQ, seed=0, step_=0):
    return jax_data.batch_for(cfg.vocab_size, batch, seq, seed=seed, step=step_,
                              frontend=cfg.frontend, frontend_len=cfg.frontend_len,
                              d_model=cfg.d_model)


def _jax_state(cfg, tc, seed=0):
    return jax_step.train_state_init(jax.random.PRNGKey(seed), cfg, tc)


def _to_port(jstate, cfg):
    return train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")


def _port_tc(tc):
    """The port's TrainConfig with the same numbers as the JAX one."""
    return step.TrainConfig(optimizer=optimizer.AdamWConfig(**dataclasses.asdict(tc.optimizer)),
                            microbatches=tc.microbatches, grad_clip=tc.grad_clip, z_loss=tc.z_loss)


def _assert_trees_close(got, want, tol):
    for (path, g), (_, w) in zip(_paths(got), _paths(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        err = _rel(g, w)
        assert err <= tol, f"{path}: relative L2 error {err} > {tol}"


def _assert_params_close(got, want, want_m, tc):
    """The params after one step from zero moments, leaf by leaf: within
    1e-5 relative L2 over the elements where Adam's step is well
    conditioned, and within a quarter of the step elsewhere.  The step moves
    a parameter by ``lr * g / (|g| + eps)``; a relative error ``d`` in ``g``
    moves that ratio by up to ``d / 4`` (at ``|g| = eps``), and by under
    ``d / 100`` once ``|g| >= 100 eps``.  A gradient that cancels to within
    100 eps of zero carries f32 rounding of up to its own size (``d`` up
    to 1: one norm-scale element has ``g`` 3e-8, 1.7 % apart between the
    packages while its leaf's moments are 1.4e-6 apart), so there the bound
    is ``lr / 4`` beyond 1e-5 of the value (about 8 % of the elements, most
    of them embedding rows no token of the batch reads, whose ``g`` is 0 in
    both).  ``g`` is read from the reference's first moment,
    ``m = (1 - beta1) g``."""
    opt = tc.optimizer
    lr = opt.learning_rate * min(1.0 / max(opt.warmup_steps, 1), 1.0)
    for (path, g), (_, w), (_, m) in zip(_paths(got), _paths(want), _paths(want_m), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        ill = m.float().abs() / (1 - opt.beta1) < 100 * opt.eps
        err = _rel(g[~ill], w[~ill])
        assert err <= F32_TOL, f"{path}: relative L2 error {err} > {F32_TOL}"
        off = (g[ill].float() - w[ill].float()).abs() - F32_TOL * w[ill].float().abs()
        assert not ill.any() or off.max() <= lr / 4, f"{path}: {off.max()} off, step {lr}"


def _assert_trees_equal(got, want):
    for (path, g), (_, w) in zip(_paths(got), _paths(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), path


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,b,s,seed,structure", [(100, 4, 16, 3, 0.75), (512, 2, 33, 0, 0.75),
                                                      (64, 16, 64, 1, 0.3)])
def test_synthetic_tokens_equal_jax_byte_for_byte(vocab, b, s, seed, structure):
    jit = iter(jax_data.SyntheticTokens(jax_data.DataConfig(vocab, b, s, seed, structure)))
    tit = iter(data.SyntheticTokens(data.DataConfig(vocab, b, s, seed, structure)))
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
def test_batch_for_equals_jax_byte_for_byte(frontend):
    kw = dict(seed=5, step=7, frontend=frontend, frontend_len=6, d_model=24)
    want = jax_data.batch_for(300, 3, 20, **kw)
    got = data.batch_for(300, 3, 20, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    dev = data.to_device(got, "cpu")
    assert dev["tokens"].dtype == torch.int64 and torch.equal(dev["tokens"],
                                                              torch.from_numpy(want["tokens"]).long())
    if frontend:
        key = "image_embeds" if frontend == "vision" else "audio_frames"
        assert dev[key].dtype == torch.float32


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def _random_tree(seed, scale=1.0):
    """A params-like JAX tree, leaves of both dtypes, the layers stacked on a
    leading axis of 2 (the reduced configs' depth)."""
    rng = np.random.default_rng(seed)

    def leaf(shape, dtype):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale, dtype)

    return {
        "embed": leaf((64, 16), jnp.bfloat16),
        "final_norm": leaf((16,), jnp.float32),
        "layers": {"attn": {"wq": leaf((2, 16, 2, 8), jnp.float32)},
                   "ffn": {"w_up": leaf((2, 16, 32), jnp.bfloat16)},
                   "norm1": leaf((2, 16), jnp.float32)},
    }


_TREE_CFG = _reduced("llama3-8b")  # params_from_jax reads its depth, 2


def _port_tree(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), _TREE_CFG, "cpu")


def _assert_leaves_close(got, want, f32_tol):
    """f32 leaves within ``f32_tol`` relative L2; a bf16 leaf within one
    bf16 rounding (2^-8) of it, since an f32 difference in the last place
    can round to the other neighbour."""
    for (path, g), (_, w) in zip(_paths(got), _paths(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        tol = 2.0**-8 if g.dtype == torch.bfloat16 else f32_tol
        assert _rel(g, w) <= tol, (path, _rel(g, w))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(moment_dtype):
    """Three AdamW steps (the warmup and past it) over a random tree of f32
    and bf16 leaves with random grads: params, m, v and step, within 1e-6
    relative L2 in f32."""
    jcfg = jax_opt.AdamWConfig(learning_rate=1e-2, warmup_steps=2, moment_dtype=moment_dtype)
    tcfg = optimizer.AdamWConfig(**dataclasses.asdict(jcfg))
    jparams = _random_tree(0, 0.05)
    jopt = jax_opt.adamw_init(jcfg, jparams)
    tparams = _port_tree(jparams)
    topt = optimizer.adamw_init(tcfg, tparams)
    for i in range(3):
        jgrads = _random_tree(i + 1)
        jparams, jopt = jax.jit(jax_opt.adamw_update, static_argnums=0)(jcfg, jgrads, jparams, jopt)
        out = optimizer.adamw_update(tcfg, _port_tree(jgrads), tparams, topt)
        assert out[0] is tparams and out[1] is topt  # in place
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == int(jopt["step"]) == 3
    _assert_leaves_close(tparams, _port_tree(jparams), 1e-6)
    for k in ("m", "v"):
        assert all(t.dtype == dtype_of(moment_dtype) for t in tree_leaves(topt[k]))
        _assert_leaves_close(topt[k], _port_tree(jopt[k]), 1e-6)


@pytest.mark.parametrize("warmup", [1, 4, 100])
def test_schedule_equals_jax(warmup):
    jcfg = jax_opt.AdamWConfig(learning_rate=3e-4, warmup_steps=warmup)
    tcfg = optimizer.AdamWConfig(**dataclasses.asdict(jcfg))
    for s in (0, 1, 3, 4, 5, 250):
        want = np.asarray(jax_opt.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = optimizer.schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and np.float32(got.item()) == want


@pytest.mark.parametrize("max_norm", [1e-2, 1.0, 1e3])
def test_clip_by_global_norm_equals_jax(max_norm):
    jgrads = _random_tree(7)
    jclipped, jnorm = jax.jit(jax_opt.clip_by_global_norm, static_argnums=1)(jgrads, max_norm)
    tgrads = _port_tree(jgrads)
    tclipped, tnorm = optimizer.clip_by_global_norm(tgrads, max_norm)
    assert _rel(tnorm, jnorm) <= 1e-6
    assert _rel(optimizer.global_norm(tgrads), jax_opt.global_norm(jgrads)) <= 1e-6
    _assert_leaves_close(tclipped, _port_tree(jclipped), 1e-6)


# --------------------------------------------------------------------------- #
# the loss and one train step, against JAX
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_step(arch, dtype, microbatches):
    """The JAX package's state before and after one step on ``_batch``
    (JAX arrays are immutable, so the tests share them).  The step is
    compiled at XLA's backend optimization level 0: the same program, in
    half the compile time on one core."""
    cfg = _reduced(arch, dtype)
    tc = jax_step.TrainConfig(microbatches=microbatches)
    before = _jax_state(cfg, tc)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    compiled = jax.jit(jax_step.make_train_step(cfg, tc)).lower(before, batch).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    after, metrics = compiled(before, batch)
    return cfg, tc, before, after, metrics


def _one_step_both(arch, dtype, microbatches):
    cfg, tc, jstate, jstate_after, jm = _jax_step(arch, dtype, microbatches)
    tstate = _to_port(jstate, cfg)
    tbatch = data.to_device(_batch(cfg), "cpu")
    loss, tmetrics0 = step.loss_fn(tstate["params"], cfg, tbatch, _port_tc(tc))
    tstate, tm = step.make_train_step(cfg, _port_tc(tc))(tstate, tbatch)
    return cfg, jstate_after, jm, tstate, tm, loss, tmetrics0


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", DENSE + MOE + SSM + ENCDEC)
def test_train_step_equals_jax_in_f32(arch, microbatches):
    """In f32: ``loss_fn`` on the initial params, and the step's loss, nll,
    z-loss and grad norm, every updated parameter and both moments within
    1e-5 relative L2 of the JAX package's (the SSM layers under remat as
    the attention layers are, the hybrid's shared block outside it, as in
    the reference)."""
    cfg, jstate, jm, tstate, tm, loss, tm0 = _one_step_both(arch, "float32", microbatches)
    if microbatches == 1:  # the step's metrics are loss_fn's on the whole batch
        assert _rel(loss, jm["loss"]) <= F32_TOL
        for k in ("nll", "z_loss", "aux"):
            assert abs(float(tm0[k]) - float(jm[k])) <= F32_TOL * max(abs(float(jm[k])), 1e-30), k
    for k in ("loss", "nll", "z_loss", "grad_norm", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= F32_TOL * max(abs(float(jm[k])), 1e-30), k
    assert int(tstate["opt"]["step"]) == 1
    want = _to_port(jstate, cfg)
    _assert_trees_close(tstate["opt"], want["opt"], F32_TOL)
    _assert_params_close(tstate["params"], want["params"], want["opt"]["m"], jax_step.TrainConfig())


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_equals_jax_in_bf16(arch):
    """In each arch's default dtype (bf16): the loss and grad norm within
    2e-2 of the JAX package's, and the state keeps its dtypes.  (The
    microbatch split is held in f32 above, where it is exact enough to
    see.)"""
    cfg, jstate, jm, tstate, tm, _, _ = _one_step_both(arch, None, 1)
    assert cfg.dtype == "bfloat16"
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= BF16_TOL * abs(float(jm[k])), k
    for (path, g), (_, w) in zip(_paths(tstate), _paths(_to_port(jstate, cfg)), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, path


def test_train_step_gives_every_parameter_a_gradient():
    """After one step from zero moments, ``m = (1 - beta1) * clipped grad``:
    every leaf's is nonzero, each layer's wq/wk/wv included, and every
    parameter moved."""
    cfg = get_reduced("llama3-8b")
    tc = step.TrainConfig(optimizer=optimizer.AdamWConfig(learning_rate=1e-2, warmup_steps=1))
    state = step.train_state_init(torch.Generator().manual_seed(0), cfg, tc)
    before = [p.clone() for p in tree_leaves(state["params"])]
    state, _ = step.make_train_step(cfg, tc)(state, data.to_device(_batch(cfg), "cpu"))
    for path, m in _paths(state["opt"]["m"]):
        assert m.abs().max() > 0, path
    assert {k for k in state["opt"]["m"]["layers"][1]["attn"]} >= {"wq", "wk", "wv"}
    for b, p in zip(before, tree_leaves(state["params"])):
        assert not torch.equal(b, p)


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #
def _grads(cfg, params, batch):
    live = optimizer.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = step.loss_fn(live, cfg, batch, step.TrainConfig())
    return torch.autograd.grad(loss, tree_leaves(live))


def test_remat_policies_give_the_same_gradients(monkeypatch):
    """``REPRO_REMAT_POLICY`` "nothing" and "dots", and the layers run with
    no remat at all, give the same gradients on the CPU (the recompute is
    the same arithmetic).  Under "dots" the policy keeps every weight matmul
    (``aten.mm``) of the forward and recomputes the batched attention
    products; under "nothing" it is never asked."""
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    params = step.train_state_init(torch.Generator().manual_seed(3), cfg, step.TrainConfig())["params"]
    batch = data.to_device(_batch(cfg), "cpu")
    asked = []
    policy = scan_util._save_dots
    monkeypatch.setattr(scan_util, "_save_dots",
                        lambda ctx, op, *a, **k: asked.append((str(op), ctx.is_recompute,
                                                               policy(ctx, op, *a, **k))) or asked[-1][2])
    grads = {}
    for name in ("nothing", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", name)
        asked.clear()
        grads[name] = _grads(cfg, params, batch)
        seen = {(op, rec, str(pol)) for op, rec, pol in asked}
        if name == "nothing":
            assert not seen
        else:
            assert ("aten.mm.default", False, "CheckpointPolicy.MUST_SAVE") in seen
            assert ("aten.bmm.default", False, "CheckpointPolicy.PREFER_RECOMPUTE") in seen
            assert not {s for s in seen if s[0] == "aten.mm.default" and s[1]}  # no mm recomputed
    monkeypatch.setattr(transformer, "remat", lambda fn, *args: fn(*args))
    grads["none"] = _grads(cfg, params, batch)
    for name in ("nothing", "dots"):
        for g, w in zip(grads[name], grads["none"], strict=True):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_serving_forward_runs_no_remat(monkeypatch):
    """Without autograd recording (no grad mode, or no tensor requiring
    grad) the layers run as they are."""
    calls = []
    real = transformer.remat
    monkeypatch.setattr(transformer, "remat", lambda fn, *a: calls.append(1) or real(fn, *a))
    cfg = get_reduced("llama3-8b")
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    transformer.forward(params, cfg, {"tokens": tokens})
    with torch.no_grad():
        transformer.forward(params, cfg, {"tokens": tokens})
    assert not calls
    params["layers"][0]["attn"]["wq"].requires_grad_()
    transformer.forward(params, cfg, {"tokens": tokens})
    assert len(calls) == cfg.num_layers


# --------------------------------------------------------------------------- #
# checkpoints: the JAX package's file format, both ways
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", None])  # None: the arch's bf16
def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, dtype):
    cfg, tc, _, jstate, _ = _jax_step("qwen3-14b", dtype, 1)  # nonzero moments, step 1
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, jstate, step=1, metadata={"by": "jax"})
    template = step.train_state_init(torch.Generator().manual_seed(5), cfg, _port_tc(tc))
    restored, at = checkpoint.restore_checkpoint(path, template)
    assert at == 1 and restored is template
    _assert_trees_equal(restored, _to_port(jstate, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, dtype):
    cfg = _reduced("llama3-8b", dtype)
    tc = step.TrainConfig()
    tstate = step.train_state_init(torch.Generator().manual_seed(6), cfg, tc)
    tstate, _ = step.make_train_step(cfg, tc)(tstate, data.to_device(_batch(cfg), "cpu"))
    path = str(tmp_path / "port")  # no suffix: the archive gets ".npz", the sidecar does not
    checkpoint.save_checkpoint(path, tstate, step=1)
    assert (tmp_path / "port.npz").exists() and (tmp_path / "port.meta.json").exists()
    template = _jax_state(cfg, jax_step.TrainConfig(), seed=1)
    restored, at = jax_ckpt.restore_checkpoint(path, template)
    assert at == 1
    _assert_trees_equal(_to_port(restored, cfg), tstate)


def test_encoder_decoder_checkpoint_in_both_packages(tmp_path):
    """The encoder-decoder's state after one step: the port's file holds
    ``enc_layers/...`` and ``dec_layers/...`` with the layer axis first, as
    the JAX package's does; it restores bitwise in the JAX package, and
    the JAX package's restores bitwise in the port."""
    cfg, tc, _, jstate, _ = _jax_step("seamless-m4t-medium", "float32", 1)
    tstate = _to_port(jstate, cfg)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, tstate, step=1)
    with np.load(path) as f:
        for name in ("params/enc_layers/attn/wq", "opt/m/dec_layers/cross_attn/wk"):
            assert f[name].shape[0] == (cfg.encoder_layers if "enc_" in name else cfg.num_layers)
    restored, at = jax_ckpt.restore_checkpoint(path, _jax_state(cfg, jax_step.TrainConfig(), seed=1))
    assert at == 1
    _assert_trees_equal(_to_port(restored, cfg), tstate)
    jpath = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jpath, jstate, step=1)
    template = step.train_state_init(torch.Generator().manual_seed(5), cfg, _port_tc(tc))
    _assert_trees_equal(checkpoint.restore_checkpoint(jpath, template)[0], tstate)


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_reduced("llama3-8b")
    tc = step.TrainConfig()
    state = step.train_state_init(torch.Generator().manual_seed(0), cfg, tc)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, state, step=7)
    fresh = step.train_state_init(torch.Generator().manual_seed(1), cfg, tc)
    restored, at = checkpoint.restore_checkpoint(path, fresh)
    assert at == 7
    _assert_trees_equal(restored, state)


def test_restore_rejects_another_shape(tmp_path):
    cfg = get_reduced("llama3-8b")
    tc = step.TrainConfig()
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, step.train_state_init(torch.Generator(), cfg, tc), step=0)
    other = dataclasses.replace(cfg, num_layers=3)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        checkpoint.restore_checkpoint(path, step.train_state_init(torch.Generator(), other, tc))


def test_resume_continues(tmp_path):
    cfg = dataclasses.replace(get_reduced("llama3-8b"), vocab_size=128)
    path = str(tmp_path / "c.npz")
    launch_train.train_loop(cfg, steps=4, batch_size=2, seq_len=16, ckpt_path=path,
                            ckpt_every=4, log_every=100, device="cpu")
    _, losses = launch_train.train_loop(cfg, steps=6, batch_size=2, seq_len=16, ckpt_path=path,
                                        resume=True, log_every=100, device="cpu")
    assert len(losses) == 2  # resumed at step 4, ran 4..5


# --------------------------------------------------------------------------- #
# train_loop
# --------------------------------------------------------------------------- #
def test_train_loop_losses_equal_jax(monkeypatch):
    """Five f32 steps of ``train_loop`` from the same initial state (the JAX
    package's, carried across): the losses within 1e-5."""
    cfg = _reduced("llama3-8b", "float32")
    kw = dict(steps=5, batch_size=2, seq_len=16, log_every=100)
    _, jlosses = jax_train_loop(cfg, **kw)
    init = _jax_state(cfg, jax_step.TrainConfig())  # train_loop's own init, seed 0
    monkeypatch.setattr(launch_train, "train_state_init", lambda gen, c, tc: _to_port(init, cfg))
    _, tlosses = launch_train.train_loop(cfg, **kw, device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=F32_TOL)


def test_loss_decreases():
    cfg = dataclasses.replace(get_reduced("llama3-8b"), vocab_size=256, num_layers=2)
    _, losses = launch_train.train_loop(cfg, steps=25, batch_size=4, seq_len=32, lr=3e-3,
                                        log_every=100, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_loop_draws_its_initial_state_on_the_host():
    """The initial state is drawn on the host from the seed, so a run on
    another device starts where the CPU's does (the chip smoke holds the
    card's run to the host's)."""
    cfg = get_reduced("llama3-8b")
    tc = step.TrainConfig()
    a = step.train_state_init(torch.Generator().manual_seed(0), cfg, tc)
    state, _ = launch_train.train_loop(cfg, steps=0, batch_size=1, seq_len=4, device="cpu")
    _assert_trees_equal(state, a)


# --------------------------------------------------------------------------- #
# R1: the flash branch under autograd; the einsum path's knobs
# --------------------------------------------------------------------------- #
def test_flash_is_off_under_grad_when_unset(monkeypatch):
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cuda = torch.device("cuda")
    assert attention.use_flash(cuda, 128, 128) is True
    assert attention.use_flash(cuda, 128, 128, grad=True) is False
    assert attention.use_flash(torch.device("cpu"), 128, 128, grad=True) is False


def _qkv(seed, b=2, s=17, h=4, kv=2, d=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32))


def test_sdpa_with_flash_forced_raises_under_grad(monkeypatch):
    """``REPRO_USE_FLASH=1`` under autograd raises on the CPU (the kernel's
    plain version would run, but the kernel has no backward); without
    autograd the flash branch runs; and a train step under it raises."""
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    q, k, v = (tensor_from_numpy(a, "cpu") for a in _qkv(0))
    before = flash_attention.launches
    attention.sdpa(q, k, v, causal=True)  # nothing records: the flash branch, plain version
    with pytest.raises(RuntimeError, match="no backward"):
        attention.sdpa(q.requires_grad_(), k, v, causal=True)
    with torch.no_grad():
        attention.sdpa(q, k, v, causal=True)
    assert flash_attention.launches == before
    cfg = get_reduced("llama3-8b")
    state = step.train_state_init(torch.Generator().manual_seed(0), cfg, step.TrainConfig())
    with pytest.raises(RuntimeError, match="no backward"):
        step.make_train_step(cfg, step.TrainConfig())(state, data.to_device(_batch(cfg), "cpu"))


def test_jax_grad_through_the_flash_branch_fails(monkeypatch):
    """The reference: ``jax.grad`` through its Pallas kernel fails (in the
    kernel's transpose), which is why the port refuses it too."""
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    q, k, v = (jnp.asarray(a) for a in _qkv(1, b=1, s=16, d=64))
    with pytest.raises(AssertionError):
        jax.grad(lambda q_: jax_attn.sdpa(q_, k, v, causal=True).sum())(q)


@pytest.mark.parametrize("causal", [True, False])
def test_einsum_sdpa_gradients_equal_jax(monkeypatch, causal):
    """The einsum path's in-place scaling and masking under autograd: the
    gradients to q, k and v equal ``jax.grad``'s (f32, 1e-5)."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    q, k, v = _qkv(2)
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda q_, k_, v_: (jax_attn.sdpa(q_, k_, v_, causal=causal) * w).sum(),
                          argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (tensor_from_numpy(a, "cpu").requires_grad_() for a in (q, k, v))
    (attention.sdpa(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("knob,value", [("REPRO_ABLATE_ATTN", "1"), ("REPRO_ATTN_DTYPE", "bf16")])
def test_einsum_knobs_equal_jax(monkeypatch, knob, value, dtype):
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    monkeypatch.setenv(knob, value)
    q, k, v = _qkv(4)
    want = jax_attn.sdpa(*(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)), causal=True)
    got = attention.sdpa(*(tensor_from_numpy(a, "cpu").to(dtype_of(dtype)) for a in (q, k, v)),
                         causal=True)
    assert got.dtype == dtype_of(dtype) and tuple(got.shape) == want.shape
    tol = 2e-5 if dtype == "float32" and knob == "REPRO_ABLATE_ATTN" else 3e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_train_launcher_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", "llama3-8b", "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "training llama3-smoke: ~1.4M params" in out
    assert "step     0  loss" in out and "step     2  loss" in out
    assert "loss: first10=" in out


def test_train_launcher_trains_the_encoder_decoder_on_the_cpu(capsys):
    launch_train.main(["--arch", "seamless-m4t-medium", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "training seamless-smoke" in out and "step     1  loss" in out


def test_train_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3-8b"])
