"""Serving substrate of the port: KV-cache decode steps and batched greedy
serving."""

from repro_torch.serve.engine import (
    ServeConfig,
    greedy_generate,
    init_serving_cache,
    make_serve_step,
)

__all__ = ["ServeConfig", "make_serve_step", "init_serving_cache", "greedy_generate"]
