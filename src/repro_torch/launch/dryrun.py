"""Multi-pod dry-run: count every (arch x shape x mesh) on abstract tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]

PyTorch counterpart of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles each combination for 512 placeholder host
devices and reads XLA's cost and memory analyses.  The port has no SPMD
partitioner and one card has no pod, so here each combination runs once,
as the global program, on tensors with shapes and dtypes and no storage,
under :class:`StepCounter`, and fills the same
:class:`repro_torch.roofline.RooflineReport` at the H100's rates.  The
state is made under ``FakeTensorMode`` (the counterpart of
``jax.eval_shape``) and the step runs on ``meta`` tensors of the same
shapes (:func:`count_step` says why).  Nothing is placed on any device:
the dry-run needs no card and allocates no weight, so nemotron-4-340b's
terabytes of train state cost nothing.  Off CUDA ``attention.sdpa`` takes
its einsum path (ROADMAP D6), as the reference's CPU dry-run lowers its
einsum path.

What a report holds, and where it differs from the reference's (ROADMAP
D17):

* ``hlo_flops_per_device``: the FLOPs of the products and convolutions,
  by ``torch.utils.flop_counter``'s formulas (einsums reach them as
  ``bmm``), split evenly over the mesh's chips.  XLA counts every op.
* ``hlo_bytes_per_device``: every op's tensor operands and results,
  unfused (a view moves nothing and is not counted; XLA counts its fused
  program's).  A tensor in the state the step reads (a parameter, an
  AdamW moment, a cache; a view of one too) is charged at its share of
  one device, from its leaf's sharding (:func:`rules_for`,
  ``specs.sharding_tree``), so a decode step's weight and cache reads are
  not divided away; every other tensor is split evenly over the chips,
  where the reference's partitioned program has its own shapes.
* ``collective_bytes_per_device`` 0 and ``collective_counts`` ``{}``: with
  no partitioner there is no collective to count.
* ``peak_memory_per_device`` ``None``, and ``memory_analysis`` in the
  reference's ``<memory_analysis unavailable: ...>`` form.

``state_bytes_per_device`` is the reference's arithmetic on the same
leaves, exactly.  On a 1x1 mesh (``make_smoke_mesh``) the even split and
the shard sizes are exact and there is no collective.

The reference's trip-count correction is not needed: it compiles
partially unrolled variants (``REPRO_UNROLL_LAYERS`` / ``REPRO_UNROLL_MB``)
because XLA's cost analysis counts a ``while`` body once.  The port's
layers and microbatches are Python loops, so the counter sees every layer
and every microbatch; ``correct_loops`` / ``--no-correct`` are accepted
and change nothing (ROADMAP D9).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from collections import Counter
from typing import Dict, Optional

import torch
from torch._C import DispatchKey
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, dp_axes_of, make_production_mesh
from repro_torch.launch.pspec import ShardingRules
from repro_torch.launch.specs import (
    INPUT_SHAPES,
    InputShape,
    bytes_per_device,
    cache_logical_axes,
    input_specs,
    logical_axes_for,
    shard_count,
    sharding_tree,
    tree_paths_and_tensors,
)
from repro_torch.models import get_model
from repro_torch.roofline import RooflineReport, model_flops
from repro_torch.serve.engine import ServeConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig, make_train_step, train_state_init


def dryrun_train_config(cfg: ModelConfig) -> TrainConfig:
    """Microbatching + moment-dtype policy by model scale (DESIGN.md §3)."""
    n = cfg.param_count()
    if os.environ.get("REPRO_MICROBATCHES"):
        mb = int(os.environ["REPRO_MICROBATCHES"])
        return TrainConfig(
            optimizer=AdamWConfig(
                moment_dtype="bfloat16" if n > 30e9 else "float32"
            ),
            microbatches=mb,
        )
    if n > 100e9:
        return TrainConfig(
            optimizer=AdamWConfig(moment_dtype="bfloat16"), microbatches=16
        )
    if n > 30e9:
        return TrainConfig(
            optimizer=AdamWConfig(moment_dtype="bfloat16"), microbatches=16
        )
    if n > 5e9:
        return TrainConfig(microbatches=8)
    return TrainConfig(microbatches=1)


def rules_for(cfg: ModelConfig, shape: InputShape, mesh: Mesh) -> ShardingRules:
    overrides: Dict[str, object] = {}
    if shape.kind == "train" and cfg.param_count() > 30e9:
        # Megatron-style sequence parallelism on the residual stream: scan
        # carries shrink by the model-axis factor (needed to fit 340B remat
        # boundaries in 16 GB HBM).
        overrides["seq"] = "model"
    if shape.kind == "decode" and shape.global_batch < 16:
        # long_500k: batch of 1 cannot use the data axis -> context-parallel
        # cache (sequence axis sharded over data).
        overrides["cache_seq"] = "data"
    if os.environ.get("REPRO_OPT_DECODE_CACHE") == "1" and shape.kind == "decode":
        # Beyond-paper optimisation (EXPERIMENTS.md §Perf): GQA kv_heads
        # (2-8) often don't divide the 16-way model axis, so baseline decode
        # caches replicate over "model" and blow past HBM.  Shard the cache
        # SEQUENCE axis over the model axis instead (flash-decoding style).
        # Archs whose kv_heads already shard (seamless kv=16, zamba2 kv=32)
        # keep head sharding.
        kv_shardable = (
            cfg.num_kv_heads > 0
            and not cfg.use_mla
            and cfg.num_kv_heads % mesh.shape["model"] == 0
        )
        if not kv_shardable:
            if shape.global_batch < 16:
                overrides["cache_seq"] = ("data", "model")
            else:
                overrides["cache_seq"] = "model"
    return ShardingRules(mesh, overrides, dp_axes=dp_axes_of(mesh))


# --------------------------------------------------------------------------- #
# The counter
# --------------------------------------------------------------------------- #
_TO_COPY = torch.ops.aten._to_copy.default


class _NotMeta(Exception):
    """An argument that is a tensor off the ``meta`` device."""


def _meta_key(value):
    """A hashable stand-in for an op's argument: a ``meta`` tensor's shape,
    strides, offset and dtype, a sequence's items, anything else itself."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "meta":
            raise _NotMeta
        return (tuple(value.shape), value.stride(), value.storage_offset(), value.dtype)
    if isinstance(value, (list, tuple)):
        return tuple(_meta_key(v) for v in value)
    if isinstance(value, dict):
        return tuple((k, _meta_key(v)) for k, v in value.items())
    return value


class StepCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op run under it.

    FLOPs follow ``torch.utils.flop_counter.FlopCounterMode`` op for op on
    plain (CPU, CUDA, meta) tensors: the same formulas, and an op with a
    ``CompositeImplicitAutograd`` kernel is decomposed under the counter
    first, as there.  Bytes are
    each non-view op's tensor operands and results, kept by how many ways
    each is split: ``state_shards`` maps a state tensor's storage to its
    leaf's shard count, and every other tensor is split over ``chips``.
    A host tensor copied onto another device is not counted.  On ``meta``
    tensors a repeated functional op is not rerun (:meth:`_run`).
    """

    def __init__(self, chips: int = 1, state_shards: Optional[Dict[int, int]] = None):
        super().__init__()
        self.chips = chips
        self.state_shards = state_shards or {}
        self.flops = 0
        #: shard count -> bytes moved of tensors split that many ways
        self.bytes_by_split: Counter = Counter()
        self._decomposes: Dict[object, bool] = {}
        self._made: Dict[tuple, tuple] = {}

    @property
    def bytes(self) -> int:
        return sum(self.bytes_by_split.values())

    @property
    def bytes_per_device(self) -> float:
        return sum(b / n for n, b in self.bytes_by_split.items())

    def _has_composite(self, func) -> bool:
        known = self._decomposes.get(func)
        if known is None:
            dk = DispatchKey.CompositeImplicitAutograd
            known = dk in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), dk)
            self._decomposes[func] = known
        return known

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on ``meta`` tensors a functional op's
        result is remade from an earlier call's with the same shapes,
        strides, dtypes and other arguments, of which a meta kernel is a
        function: torch runs many meta kernels in Python (~180 us an
        elementwise op), and a step repeats its ops layer after layer."""
        if func.is_view or func._schema.is_mutable:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            made = self._made.get(key)
        except (_NotMeta, TypeError):  # a tensor off meta, or an argument with no hash
            return func(*args, **kwargs)
        if made is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(o is None or (isinstance(o, torch.Tensor) and o.device.type == "meta")
                   for o in outs):
                self._made[key] = (type(out) if isinstance(out, (tuple, list)) else None, [
                    None if o is None else (tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        seq, metas = made
        outs = [None if m is None else torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                for m in metas]
        return seq(outs) if seq else outs[0]

    def _charge(self, values):
        """Charge every tensor in ``values``, lists and tuples of them too."""
        for v in values:
            if isinstance(v, torch.Tensor):
                split = self.state_shards.get(v.untyped_storage()._cdata, self.chips)
                self.bytes_by_split[split] += v.numel() * v.element_size()
            elif isinstance(v, (list, tuple)):
                self._charge(v)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._has_composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, args, kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view or (func is _TO_COPY and args[0].device.type == "cpu"
                            and out.device.type != "cpu"):
            # a view moves nothing; nor, on the device, does a host constant
            # (the rope frequencies, made in numpy) copied onto it: that is
            # the host link's traffic, and a CPU run has no such op
            return out
        self._charge((args, tuple(kwargs.values()), out))
        return out


@dataclasses.dataclass
class StepCount:
    """One step's counts: the global program's ``flops`` and ``bytes``, and
    each split over one device's share."""

    flops: int
    bytes: int
    flops_per_device: float
    bytes_per_device: float
    state_bytes_per_device: int
    chips: int
    seconds: float


def _chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())


def _dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes_of(mesh))


def train_config_for(cfg: ModelConfig, shape: InputShape, mesh: Mesh) -> TrainConfig:
    """:func:`dryrun_train_config`, its microbatches capped to keep at least
    one sample per data shard, as the reference's dry-run does."""
    tc = dryrun_train_config(cfg)
    mb_cap = max(1, shape.global_batch // _dp_size(mesh))
    if tc.microbatches > mb_cap:
        tc = dataclasses.replace(tc, microbatches=mb_cap)
    return tc


def moe_groups(cfg: ModelConfig, shape: InputShape, mesh: Mesh, tc: Optional[TrainConfig]) -> int:
    """``REPRO_MOE_GROUPS`` for one call of the step: the data-parallel size
    where the tokens of a call split into that many groups, else 1."""
    dp = _dp_size(mesh)
    if shape.kind == "train":
        tokens = (shape.global_batch // tc.microbatches) * shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch
    return dp if (cfg.num_experts and tokens % dp == 0) else 1


def state_trees(cfg: ModelConfig, shape: InputShape, tc: Optional[TrainConfig],
                gen: torch.Generator):
    """The state the step reads, as ``{name: (tree, axes_fn)}``: the train
    state, or the params, and for a decode step its serving cache; on
    ``gen``'s device (in a ``FakeTensorMode``, fake tensors)."""
    model = get_model(cfg)
    if shape.kind == "train":
        return {"state": (train_state_init(gen, cfg, tc), logical_axes_for)}
    trees = {"params": (model.init(gen, cfg), logical_axes_for)}
    if shape.kind == "decode":
        sc = ServeConfig(batch_size=shape.global_batch, context_len=shape.seq_len)
        cache = model.init_cache(cfg, sc.batch_size, sc.cache_len(cfg), gen.device)
        trees["cache"] = (cache, cache_logical_axes)
    return trees


def sharded_state(trees, rules: ShardingRules):
    """The bytes per device of the state ``trees`` (:func:`state_trees`)
    under ``rules``, and each of its tensors' shard count keyed by its
    storage (a view of a state tensor shares it)."""
    total, shards = 0, {}
    for tree, axes_fn in trees.values():
        sh = sharding_tree(tree, rules, axes_fn)
        total += bytes_per_device(tree, sh)
        for path, tensors in tree_paths_and_tensors(tree):
            for t in tensors:
                shards[t.untyped_storage()._cdata] = shard_count(sh[path])
    return total, shards


def _inputs(cfg: ModelConfig, shape: InputShape, gen: torch.Generator):
    """The step's inputs at ``specs.input_specs``' shapes and dtypes:
    token ids below the vocabulary, positions below the sequence, f32
    embeddings from a normal."""
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=gen, dtype=spec.dtype) * 0.02
        else:
            high = spec.shape[-1] if name == "mrope_positions" else cfg.vocab_size
            out[name] = torch.randint(0, high, spec.shape, generator=gen, dtype=spec.dtype)
    return out


def _step(cfg: ModelConfig, shape: InputShape, tc, trees, batch):
    """The program the dry-run counts, as a thunk: a train step, a prefill
    forward, or one decode step at the context's last position."""
    model = get_model(cfg)
    if shape.kind == "train":
        step = make_train_step(cfg, tc)
        return lambda: step(trees["state"][0], batch)
    params = trees["params"][0]
    if shape.kind == "prefill":
        return lambda: model.forward(params, cfg, batch)[0]
    cache = trees["cache"][0]
    return lambda: model.decode_step(params, cfg, {"tokens": batch["tokens"]}, cache,
                                     shape.seq_len - 1)


def _to_meta(tree):
    """``tree`` with each tensor replaced by a ``meta`` tensor of its shape,
    strides and dtype."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device="meta")
    return tree


def count_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh, *, fake: bool = True,
               seed: int = 0) -> StepCount:
    """Count one ``(cfg, shape, mesh)``: its state under the sharding rules
    of :func:`rules_for`, and its step under :class:`StepCounter`.

    With ``fake`` (the dry-run) the state and the inputs are made under
    ``FakeTensorMode``, which allocates nothing (the init draws from a CPU
    generator), and the step runs on ``meta`` tensors of the same shapes,
    strides and dtypes.  Their C++ meta kernels give every result the
    strides the eager kernels give; fake tensors' Python decompositions
    give some size-1 dims other strides (``view``), which moves
    ``matmul``'s choice between ``mm`` and ``bmm`` and so the bytes.
    Without ``fake`` the same program runs on real CPU tensors from
    ``seed`` (small configs only).  ``REPRO_MOE_GROUPS`` is set for the
    call as the reference's dry-run sets it, and restored however the
    call ends."""
    t0 = time.perf_counter()
    rules = rules_for(cfg, shape, mesh)
    tc = train_config_for(cfg, shape, mesh) if shape.kind == "train" else None
    saved = os.environ.get("REPRO_MOE_GROUPS")
    os.environ["REPRO_MOE_GROUPS"] = str(moe_groups(cfg, shape, mesh, tc))
    try:
        gen = torch.Generator().manual_seed(seed)
        with FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext():
            trees = state_trees(cfg, shape, tc, gen)
            batch = _inputs(cfg, shape, gen)
        if fake:
            trees = {k: (_to_meta(tree), axes_fn) for k, (tree, axes_fn) in trees.items()}
            batch = _to_meta(batch)
        state_bytes, shards = sharded_state(trees, rules)
        counter = StepCounter(_chips(mesh), shards)
        with counter:
            _step(cfg, shape, tc, trees, batch)()
    finally:
        if saved is None:
            os.environ.pop("REPRO_MOE_GROUPS", None)
        else:
            os.environ["REPRO_MOE_GROUPS"] = saved
    chips = _chips(mesh)
    return StepCount(flops=counter.flops, bytes=counter.bytes,
                     flops_per_device=counter.flops / chips,
                     bytes_per_device=counter.bytes_per_device,
                     state_bytes_per_device=state_bytes, chips=chips,
                     seconds=time.perf_counter() - t0)


@dataclasses.dataclass
class DryrunResult:
    report: RooflineReport
    memory_analysis: Optional[str]
    #: seconds of the count (the reference: of its lower + compile)
    compile_s: float
    state_bytes_per_device: int
    ok: bool
    error: Optional[str] = None
    #: there is no HLO: ``keep_hlo`` stores None here
    hlo: Optional[str] = None


MEMORY_ANALYSIS = ("<memory_analysis unavailable: the dry-run allocates nothing and compiles "
                   "no program (ROADMAP D17)>")


def run_dryrun(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
    keep_hlo: bool = False,
    correct_loops: bool = True,
) -> DryrunResult:
    """Count ``arch`` x ``shape_name`` on the production mesh.  ``keep_hlo``
    keeps ``None`` (there is no HLO) and ``correct_loops`` changes nothing
    (every loop is counted whole; ROADMAP D9): both are the reference's
    arguments."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    count = count_step(cfg, shape, mesh)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    report = RooflineReport(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=count.chips,
        hlo_flops_per_device=count.flops_per_device,
        hlo_bytes_per_device=count.bytes_per_device,
        collective_bytes_per_device=0.0,
        collective_counts={},
        model_flops_total=model_flops(cfg.active_param_count(), tokens, shape.kind),
        peak_memory_per_device=None,
    )
    result = DryrunResult(
        report=report,
        memory_analysis=MEMORY_ANALYSIS,
        compile_s=count.seconds,
        state_bytes_per_device=count.state_bytes_per_device,
        ok=True,
    )
    if verbose:
        print(f"== dryrun {arch} x {shape_name} on mesh {mesh_name} ==")
        print(MEMORY_ANALYSIS)
        print(json.dumps(_record(result)))
    return result


def _record(result: DryrunResult) -> Dict:
    d = result.report.to_dict()
    d["compile_s"] = result.compile_s
    d["state_bytes_per_device"] = result.state_bytes_per_device
    return d


def main() -> None:
    """The reference's command line: one JSON report line per combination,
    exit 1 if any fails.  It places nothing on any device and needs no
    card."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs() + ["all"])
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument(
        "--no-correct",
        action="store_true",
        help="accepted for the reference's command lines; every loop is counted whole",
    )
    ap.add_argument("--json-out", default=None, help="append one JSON line per run")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                res = run_dryrun(arch, shape, multi_pod=args.multi_pod)
                if args.json_out:
                    with open(args.json_out, "a") as f:
                        f.write(json.dumps(_record(res)) + "\n")
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"FAILED {arch} x {shape}: {e!r}", file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
