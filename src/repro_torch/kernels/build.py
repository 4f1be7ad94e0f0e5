"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), and
loaded with ``ctypes``.  All sources build in parallel at the first use of
any kernel, into ``build/kernels/`` at the root of the checkout; a library
is named after the hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  ``ptxas`` reports every kernel's
registers, shared memory and spills (``-Xptxas -v``); that report is kept
beside the library (``.log``) and parsed by :func:`ptxas_report`.  Nothing
here runs at import time: the CPU tests import every module on a host
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lap_bid", "lap_auction", "migration_cost", "flash_attention", "flash_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: wall seconds the last :func:`build_all` spent compiling (0 when cached)
last_build_s = 0.0
#: the sources the last :func:`build_all` compiled (the others were cached)
last_built: tuple = ()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "repro_torch kernels: nvcc not found (PATH or /usr/local/cuda/bin); "
            "the CUDA kernels build only on a host with the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (one ``nvcc`` per source, all started
    together), load them all, and return ``{name: CDLL}``."""
    global last_build_s, last_built
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        last_built = tuple(name for name, *_ in procs)
        last_build_s = time.perf_counter() - t0 if procs else 0.0
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all on first use."""
    return build_all()[name]


def ptxas_report(log: str) -> Dict[str, dict]:
    """``{kernel: {registers, spill_stores, spill_loads, stack, smem}}`` from
    an ``nvcc -Xptxas -v`` log (mangled names; ``smem`` is static shared
    memory, dynamic shared memory is the launch's)."""
    report: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(sm.group(1)) if sm else 0
    return report


def compiler_log(name: str) -> str:
    """The ``nvcc`` output kept beside ``csrc/<name>.cu``'s library."""
    return _target(name).with_suffix(".log").read_text()


def aligned_view(x):
    """``x`` as the attention kernels read it: last dim contiguous, a
    16-byte aligned base and strides (a copy only where it is not)."""
    step = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % step == 0 for st in x.stride()[:-1]))
    return x if ok else x.contiguous()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
