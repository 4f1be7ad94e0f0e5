"""Roofline terms of one step, and the HLO-text collective parser.

PyTorch counterpart of the JAX package's ``roofline.py``.  Three terms per
(arch x shape x mesh), all in seconds:

    compute_term    = FLOPs_per_device / peak_FLOPs_per_device
    memory_term     = bytes_per_device / HBM_bandwidth
    collective_term = collective_bytes_per_device / link_bandwidth

The reference takes the FLOPs and bytes from its dry-run's compiled
programs (``compiled.cost_analysis()``) and the collective bytes from their
optimized HLO text, through :func:`parse_collectives`, which is ported as
it is.  The port's dry-run (``launch/dryrun.py``) counts the products'
FLOPs and every op's bytes of the global program on abstract tensors, and
has no collective to count (ROADMAP D17).

The constants are the card the port runs on, the NVIDIA H100 80GB HBM3 at
700 W (data sheet): 989 TFLOP/s bf16 dense on the tensor cores, 3.35 TB/s
HBM3, and 450 GB/s a direction of NVLink 4, the link between cards of one
host (ROADMAP D16), with the f32 and f64 rates outside the tensor cores.
The reference's are another chip's; none of them carries over.
``chip_smoke.py`` takes its bounds' peaks from here.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

#: NVIDIA H100 80GB HBM3, 700 W (data sheet)
PEAK_FLOPS = 989e12     # bf16 dense, tensor cores, per card
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_F64_FLOPS = 34e12  # f64 outside the tensor cores
HBM_BW = 3.35e12        # bytes/s
NVLINK_BW = 450e9       # bytes/s, one direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def bytes_of_type(type_str: str) -> int:
    """Bytes of an HLO type string, incl. tuples: sums all dtype[dims]."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^=]*?\)|[\w\[\],{}\/#: ]+?))\s+([\w\-]+)\("
)


@dataclasses.dataclass
class CollectiveStats:
    #: op kind -> (count, operand_bytes)
    by_kind: Dict[str, Tuple[int, int]]

    @property
    def total_bytes(self) -> int:
        return sum(b for _, b in self.by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(c for c, _ in self.by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand sizes of collective ops in optimized HLO text.

    Builds a name -> result-bytes symbol table in a first pass, then sums
    operand bytes for each collective (``-start`` variants counted,
    ``-done`` skipped to avoid double counting).
    """
    sizes: Dict[str, int] = {}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = _INSTR_RE.match(ln)
        if m:
            sizes[m.group(1)] = bytes_of_type(m.group(2))

    by_kind: Dict[str, List[int]] = {}
    for ln in lines:
        m = _INSTR_RE.match(ln)
        if not m:
            continue
        name, _type, op = m.groups()
        base = op
        if base.endswith("-start"):
            base = base[: -len("-start")]
        elif base.endswith("-done"):
            continue
        if base not in _COLLECTIVES:
            continue
        # operand list: text between the op's '(' and its matching ')'
        start = ln.index(op + "(") + len(op) + 1
        depth, end = 1, start
        while end < len(ln) and depth:
            if ln[end] == "(":
                depth += 1
            elif ln[end] == ")":
                depth -= 1
            end += 1
        args = ln[start : end - 1]
        op_bytes = 0
        for ref in re.finditer(r"%?([\w.\-]+)", args):
            nm = ref.group(1)
            if nm in sizes:
                op_bytes += sizes[nm]
        if op_bytes == 0:
            # fallback: result size (exact for all-reduce/collective-permute)
            op_bytes = sizes.get(name, 0)
        cnt, tot = by_kind.get(base, (0, 0))
        by_kind[base] = (cnt + 1, tot + op_bytes)
    return CollectiveStats({k: tuple(v) for k, v in by_kind.items()})


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_counts: Dict[str, Tuple[int, int]]
    model_flops_total: float          # 6*N*D (D = tokens this step, global)
    peak_memory_per_device: Optional[float]

    @property
    def compute_term_s(self) -> float:
        return self.hlo_flops_per_device / PEAK_FLOPS

    @property
    def memory_term_s(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def collective_term_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_term_s,
            "memory": self.memory_term_s,
            "collective": self.collective_term_s,
        }
        return max(terms, key=terms.get)

    @property
    def model_flops_ratio(self) -> float:
        """useful-FLOPs fraction: MODEL_FLOPS / (chips * HLO_FLOPs_per_dev).
        < 1 with remat (recompute) / dispatch overhead; > 1 would mean the
        compiler found algebraic savings (or our 6ND estimate is loose)."""
        denom = self.chips * self.hlo_flops_per_device
        return self.model_flops_total / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_counts": {k: list(v) for k, v in self.collective_counts.items()},
            "model_flops_total": self.model_flops_total,
            "compute_term_s": self.compute_term_s,
            "memory_term_s": self.memory_term_s,
            "collective_term_s": self.collective_term_s,
            "bottleneck": self.bottleneck,
            "model_flops_ratio": self.model_flops_ratio,
            "peak_memory_per_device": self.peak_memory_per_device,
        }


def model_flops(param_count_active: int, tokens: int, kind: str) -> float:
    """6*N*D for a train step (fwd+bwd), 2*N*D for inference steps."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens
