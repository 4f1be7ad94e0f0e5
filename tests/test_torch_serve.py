"""The port's serving path against the JAX package's, on the CPU:
``greedy_generate`` tokens, the cache-length policy, the serve step and the
launcher.  JAX params are carried into the port by ``params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import get_model as jax_get_model
from repro.serve import engine as jax_engine
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig, greedy_generate, init_serving_cache, make_serve_step
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)


def _models(arch, dtype="float32", seed=1):
    cfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype)
    params = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")


@pytest.mark.parametrize("arch,context", [("llama3-8b", 64), ("qwen3-14b", 64), ("llama3-8b", 12),
                                          ("mamba2-780m", 64), ("zamba2-2.7b", 12)])
def test_greedy_generate_tokens_equal_jax(arch, context):
    """f32, batch 3, a 6-token prompt and 10 new tokens; context 12 runs the
    ring buffer past its end (cache_len 12 < 16 positions), for zamba2 its
    shared block's cache; mamba2's cache is its recurrent state."""
    cfg, jparams, tparams = _models(arch)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = jax_engine.greedy_generate(jparams, cfg, jnp.asarray(prompt), 10,
                                      jax_engine.ServeConfig(3, context))
    sc = ServeConfig(batch_size=3, context_len=context)
    got = greedy_generate(tparams, cfg, torch.from_numpy(prompt), 10, sc)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_logits_are_the_forward_logits():
    """The stepped logits the server returns agree with one forward pass
    over the generated sequence (the decode-parity contract)."""
    cfg, _, tparams = _models("llama3-8b")
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 5)))
    tokens, logits = greedy_generate(tparams, cfg, prompt, 7, ServeConfig(2, 32),
                                     return_logits=True)
    assert tuple(logits.shape) == (2, 11, cfg.vocab_size)
    full, _ = get_model(cfg).forward(tparams, cfg, {"tokens": tokens})
    torch.testing.assert_close(logits, full[:, :-1], rtol=1e-4, atol=1e-4)
    assert torch.equal(tokens[:, 5:], logits[:, 4:].argmax(-1))


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("context", [256, 16384, 32768, 524288])
def test_cache_len_policy_equals_jax(arch, context):
    want = jax_engine.ServeConfig(8, context).cache_len(jax_get_config(arch))
    assert ServeConfig(8, context).cache_len(get_config(arch)) == want


def test_serving_cache_and_step_update_in_place():
    cfg, _, tparams = _models("llama3-8b")
    sc = ServeConfig(batch_size=2, context_len=8)
    cache = init_serving_cache(cfg, sc, "cpu")
    assert len(cache["layers"]) == cfg.num_layers
    k0 = cache["layers"][0]["k"]
    assert tuple(k0.shape) == (2, 8, cfg.num_kv_heads, cfg.head_dim)
    step = make_serve_step(cfg)
    logits, out = step(tparams, torch.tensor([[3], [4]]), cache, 9)
    assert out is cache and out["layers"][0]["k"] is k0  # written in place
    assert k0[:, 1].abs().sum() > 0 and k0[:, 0].abs().sum() == 0  # slot 9 % 8
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)


def test_launcher_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "llama3-8b", "--batch", "2", "--prompt-len", "4", "--gen", "3",
                       "--context", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "cpu reduced config" in out


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "llama3-8b"])
