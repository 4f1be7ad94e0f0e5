"""Workload substrate of the port in PyTorch: the decoder with GQA or MLA
attention and dense or MoE feed-forwards, the Mamba-2 SSM, the SSM +
shared-attention hybrid and the encoder-decoder.

``get_model(cfg)`` returns a functional model namespace with

* ``init(gen, cfg)``                           -> params dict (on ``gen``'s device)
* ``forward(params, cfg, batch)``              -> (logits, aux)
* ``init_cache(cfg, batch, cache_len, device)`` -> decode cache dict
* ``decode_step(params, cfg, batch, cache, pos)`` -> (logits, cache)

as the JAX package's ``models`` does.  Parameters made by the JAX package
carry across with :func:`repro_torch.models.convert.params_from_jax`.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def get_model(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return encdec
    return transformer
