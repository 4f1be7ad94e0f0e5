"""The chip smoke's serving rows sized on the CPU: each row's prefill and
decode-step bounds come from its own family's reckoning, and the einsum and
f32 checks are cut to the card's memory by :func:`chip_smoke.check_cuts`.

The smoke holds every prefill to its bound ("no prefill may beat it"), so a
bound taken from another family's formula would let a row skip work or fail
a sound run; these are pure arithmetic on the full configs, but for one case
that takes the encoder-decoder's step bytes from the leaves its decode step
reads, at the reduced config on the CPU.
"""

import dataclasses

import pytest

import chip_smoke
from repro_torch.configs import get_config

#: every serving row of the smoke at the card's scale, by arch
ROWS = {r["arch"]: r for r in [chip_smoke.FULL["serve"], *chip_smoke.FULL["serve_moe"],
                               *chip_smoke.FULL["serve_ssm"], *chip_smoke.FULL["serve_encdec"],
                               *chip_smoke.FULL["serve_dense"]]}

#: the family whose reckoning bounds each row
FAMILY = {
    "llama3-8b": "dense", "dbrx-132b": "moe", "deepseek-v2-236b": "moe", "mamba2-780m": "ssm",
    "zamba2-2.7b": "ssm", "nemotron-4-340b": "dense", "qwen3-14b": "dense", "qwen2-vl-2b": "dense",
    "seamless-m4t-medium": "encdec",
}

#: an H100 80GB's ``total_memory`` (bytes, rounded down)
H100_MEMORY = 85.0e9


def _row_cfg(arch):
    base = get_config(arch)
    return dataclasses.replace(base, num_layers=ROWS[arch].get("layers") or base.num_layers)


def _family_bounds(arch):
    cfg, r = _row_cfg(arch), ROWS[arch]
    if FAMILY[arch] == "moe":
        return chip_smoke.moe_row_bounds(cfg, r["prefill_s"], r["batch"], r["context"])
    if FAMILY[arch] == "ssm":
        return chip_smoke.ssm_row_bounds(cfg, r["prefill_s"], r["batch"], r["context"])
    if FAMILY[arch] == "encdec":
        return chip_smoke.encdec_row_bounds(cfg, r["prefill_s"], r["batch"], r["prompt"] + r["gen"] - 1)
    n_img = cfg.frontend_len if cfg.frontend == "vision" else 0
    return chip_smoke.dense_row_bounds(cfg, n_img + r["prefill_s"], r["batch"],
                                       r["prompt"] + r["gen"] - 1)


def test_every_serving_row_has_a_family():
    assert set(ROWS) == set(FAMILY)


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_row_bounds_are_the_rows_own_familys(arch):
    assert chip_smoke.row_bounds(_row_cfg(arch), ROWS[arch]) == _family_bounds(arch)


def test_the_hybrid_keeps_its_ssm_bound():
    """zamba2 has attention (6 shared-block applications) and no experts,
    yet its bound is the SSM reckoning: 54 Mamba-2 layers and 6 shared
    applications, the recurrent state in a step, not 54 dense layers."""
    cfg, r = _row_cfg("zamba2-2.7b"), ROWS["zamba2-2.7b"]
    got = chip_smoke.row_bounds(cfg, r)
    dense = chip_smoke.dense_row_bounds(cfg, r["prefill_s"], r["batch"], r["prompt"] + r["gen"] - 1)
    assert got["prefill_bound_ms"] == pytest.approx(49.39, abs=0.01)
    assert got["step_bound_ms"] == pytest.approx(2.377, abs=0.001)
    assert got["state_bytes"] > 0
    assert dense["prefill_bound_ms"] > 1.5 * got["prefill_bound_ms"]


def test_the_encoder_decoder_bounds():
    """(e6) at full width and depth: the prefill's 9.23e12 operations (the
    encoder 0.17e12 over 512 frames, the head 4.30e12, the decoder's
    self-attention, cross-attention and FFN the rest) at 989 TFLOP/s; a
    decode step at B 8, valid 63, reads 1.103 GB (the 12 decoder layers
    without their cross k and v projections, the head, the self-attention
    K/V's 63 slots and the 512-frame cross K/V) at 3.35 TB/s: no encoder
    weight, which a step never reads.  The dense formula would ignore the
    encoder, the cross-attention and the cross K/V."""
    cfg, r = _row_cfg("seamless-m4t-medium"), ROWS["seamless-m4t-medium"]
    got = chip_smoke.row_bounds(cfg, r)
    assert got["prefill_bound_by"] == "operations"
    assert got["prefill_ops"] == pytest.approx(9.23e12, rel=1e-3)
    assert got["encoder_ops"] == pytest.approx(0.1675e12, rel=1e-3)
    assert got["head_ops"] == pytest.approx(4.298e12, rel=1e-3)
    assert got["prefill_bound_ms"] == pytest.approx(9.34, abs=0.01)
    assert got["step_bytes"] == pytest.approx(1.1032e9, rel=1e-4)
    assert got["step_bound_ms"] == pytest.approx(0.3293, abs=0.0001)
    encoder = 2 * cfg.encoder_layers * (4 * cfg.d_model ** 2 + cfg._ffn_params(cfg.d_ff))
    assert got["step_bytes"] < got["weight_bytes"] - encoder  # 0.302 GB of encoder unread
    dense = chip_smoke.dense_row_bounds(cfg, r["prefill_s"], r["batch"], r["prompt"] + r["gen"] - 1)
    assert dense["prefill_ops"] < got["prefill_ops"] - got["encoder_ops"]


def test_the_encoder_decoder_step_bytes_are_the_leaves_its_step_reads():
    """The reduced encoder-decoder's decode step runs with its encoder, the
    encoder's norm and every cross k and v projection taken out of its
    params, so it reads none of them; what is left but the embedding table,
    with the self-attention K/V's ``valid`` slots and the cross K/V, is the
    bound's ``step_bytes`` to the byte."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import encdec

    cfg, batch, valid = get_reduced("seamless-m4t-medium"), 2, 5
    params = encdec.init(torch.Generator().manual_seed(0), cfg)
    del params["enc_layers"], params["enc_norm"]
    for layer in params["dec_layers"]:
        del layer["cross_attn"]["wk"], layer["cross_attn"]["wv"]
    cache = encdec.init_cache(cfg, batch, 8, "cpu")
    tokens = torch.zeros((batch, 1), dtype=torch.int64)
    logits, cache = encdec.decode_step(params, cfg, {"tokens": tokens}, cache, valid - 1)
    assert logits.shape == (batch, 1, cfg.vocab_size)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.nbytes

    read = nbytes({k: v for k, v in params.items() if k != "embed"})
    read += sum(c["k"][:, :valid].nbytes + c["v"][:, :valid].nbytes for c in cache["layers"])
    read += cache["cross_k"].nbytes + cache["cross_v"].nbytes
    got = chip_smoke.encdec_row_bounds(cfg, 16, batch, valid)
    assert got["step_bytes"] == read


@pytest.mark.parametrize("arch, prefill_ms, ops, step_ms", [
    ("nemotron-4-340b", 317.05, 3.14e14, 11.07),  # 4 of 96 layers
    ("llama3-8b", 142.11, 1.41e14, 4.500),
    ("qwen2-vl-2b", 31.41, 3.11e13, 0.926),  # 256 image positions + 7936 tokens
])
def test_dense_bounds(arch, prefill_ms, ops, step_ms):
    b = chip_smoke.row_bounds(_row_cfg(arch), ROWS[arch])
    assert b["prefill_bound_by"] == "operations"
    assert b["prefill_bound_ms"] == pytest.approx(prefill_ms, abs=0.01)
    assert b["prefill_ops"] == pytest.approx(ops, rel=0.01)
    assert b["step_bound_ms"] == pytest.approx(step_ms, rel=1e-3)


@pytest.mark.parametrize("arch, cut", [
    ("llama3-8b", (32, 8192)),
    ("mamba2-780m", (48, 8192)),
    ("zamba2-2.7b", (54, 8192)),
    ("nemotron-4-340b", (1, 2048)),
    ("qwen3-14b", (19, 8192)),
    ("qwen2-vl-2b", (28, 7936)),
    ("seamless-m4t-medium", (12, 8192)),
])
def test_check_cuts_on_the_h100(arch, cut):
    cfg = _row_cfg(arch)
    assert chip_smoke.check_cuts(cfg, ROWS[arch]["prefill_s"],
                                 H100_MEMORY - chip_smoke.CHECK_HEADROOM) == cut


@pytest.mark.parametrize("arch", ["llama3-8b", "nemotron-4-340b", "qwen3-14b", "qwen2-vl-2b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("memory", [20e9, 40e9, 69e9, 120e9])
def test_check_cuts_take_the_most_that_fits(arch, memory):
    """The cut fits: the bf16 model with its einsum forward and the f32
    model at the chosen depth with its; a cut at twice the tokens does not
    (unless it is the whole prefill), nor one more layer (unless it is the
    whole model)."""
    cfg, s = _row_cfg(arch), ROWS[arch]["prefill_s"]
    n_img = cfg.frontend_len if cfg.frontend == "vision" else 0
    f = cfg.frontend_len if cfg.is_encoder_decoder else 0  # the encoder's and cross scores

    def need(layers, width, cs):
        t = n_img + cs
        return (width * dataclasses.replace(cfg, num_layers=layers).param_count()
                + 8 * cfg.num_heads * (t * t + f * f + t * f) + 12 * t * cfg.vocab_size)

    nl, cs = chip_smoke.check_cuts(cfg, s, memory)
    assert 1 <= nl <= cfg.num_layers and 1 <= cs <= s and s % cs == 0
    if need(cfg.num_layers, 2, cs) > memory or need(1, 4, cs) > memory:
        assert cs == 1  # no length fits: the least there is
    assert nl == 1 or need(nl, 4, cs) <= memory
    assert cs == s or max(need(cfg.num_layers, 2, 2 * cs), need(1, 4, 2 * cs)) > memory
    assert nl == cfg.num_layers or need(nl + 1, 4, cs) > memory


def test_check_cuts_without_a_budget_cut_nothing():
    cfg = _row_cfg("nemotron-4-340b")
    assert chip_smoke.check_cuts(cfg, 8192, None) == (cfg.num_layers, 8192)
