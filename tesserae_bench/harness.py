"""One run of one cell: set-up, the measured window, the check.

Everything of a cell is found by name: ``BENCHMARK.json`` names the
cell's configuration file and traffic mix; the configuration file names
its reference (``reference/<name>.py``) and the scheduler it builds from
the port's public classes; the traffic file (``traffic/<name>.json``)
parameterises the one generator (``traffic.py``); each per-layer metric
is read by ``metrics/<name>.py``.

The system under test is ``repro_torch``'s ``Simulator.run``, continued
one round at a time (``stop_after_rounds=1``), with the
``TesseraeScheduler`` the configuration states.  The loop is closed: a
round starts when the previous one returned, and simulated time advances
by the simulator's round length whatever the wall time.  To judge what the
window produced, the harness keeps, per round, a host copy of what the
program's layers returned: the decision (plan, placement, packing), the
logical plan and the previous plan handed to ``plan_migration``, and,
where the program still returns them on the host through the functions
the harness watches, K5's cost matrix and the fan-out's assignments.  A
round without those two is judged by its plan (``check``).
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from tesserae_bench import devtrace, traffic, yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class BenchError(RuntimeError):
    """A run that cannot give a result (no result line is printed)."""


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(manifest: Dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic) of a cell, each file found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, config, mix


def load_module(kind: str, name: str):
    """``tesserae_bench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tesserae_bench.{kind}." + name.replace(".", "_").replace("-", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_system(config: Dict, jobs: List, device, hook, obs):
    """The configuration's scheduler and simulator, from the port's public
    classes, over the benchmark's jobs."""
    from repro_torch.core import policies
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.jobs import JobSpec
    from repro_torch.core.profiler import ThroughputProfile
    from repro_torch.core.scheduler import TesseraeScheduler
    from repro_torch.core.simulator import SimConfig, Simulator

    from tesserae_bench import tput

    cluster = ClusterSpec(**config["cluster"])
    profile = ThroughputProfile()
    sched_kw = dict(config["scheduler"])
    policy = getattr(policies, sched_kw.pop("policy"))(profile)
    sched = TesseraeScheduler(cluster, policy, profile, device=device, **sched_kw)
    specs = [
        JobSpec(
            job_id=j.job_id,
            model=j.model,
            num_gpus=j.num_gpus,
            total_iters=j.total_iters,
            arrival_time=j.arrival_s,
            batch_size=j.batch_size,
            packable=j.packable,
            is_llm=tput.MODELS[j.model][3],
        )
        for j in jobs
    ]
    sim = Simulator(
        cluster, specs, sched, profile, SimConfig(**config.get("sim", {})), round_hook=hook, obs=obs
    )
    return sim, sched


def host_copy(x) -> np.ndarray:
    """A host array that owns its data: what the program returned may be a
    device tensor or a buffer it reuses next round."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.array(x, copy=True)


class Recorder:
    """Keeps, per round, a copy of what the program's layers returned, and
    the shapes of the kernels' launches (for their least bytes).

    ``plan_migration`` (the public entry of ``core.migration``) has to be
    there: without the plans handed to it no round can be judged.  The
    other functions watched are the program's internals; where one is
    gone, its record is missing and ``check`` judges the round by the
    plan instead (``missing`` names it)."""

    #: (module, attribute, what it records); the first is required
    WATCHED = (
        ("repro_torch.core.scheduler", "plan_migration", "prev, logical"),
        ("repro_torch.core.migration", "_gpu_pair_costs", "k5"),
        ("repro_torch.core.migration", "solve_lap_batched", "pairs_col_of"),
        ("repro_torch.core.matching.auction", "lap_auction", "launch shapes"),
    )

    def __init__(self, round_s: float):
        self.round_s = round_s
        self.keep = False
        self.cur: Dict = {}
        self.rounds: List[Dict] = []
        self.last_phys: Optional[np.ndarray] = None
        self.last_now = 0.0
        self.launches: Dict[str, list] = {"lap_auction": [], "migration_cost": []}
        self.missing: List[str] = []
        self._undo: List = []

    def install(self, sched) -> None:
        import importlib

        cur = self.cur
        keep = lambda: self.keep  # noqa: E731
        launches = self.launches

        def plan_migration(orig):
            def f(prev, new_logical, num_gpus_of, *a, **k):
                res = orig(prev, new_logical, num_gpus_of, *a, **k)
                if keep():
                    cur.update(prev=host_copy(prev.slots), logical=host_copy(new_logical.slots),
                               node_assignment=None if res.node_assignment is None
                               else host_copy(res.node_assignment))
                return res

            return f

        def gpu_pair_costs(orig):
            def f(slots_u, slots_v, *a, **k):
                out = orig(slots_u, slots_v, *a, **k)
                if keep():
                    cur["k5"] = host_copy(out)
                    launches["migration_cost"].append((slots_u.shape[0], slots_v.shape[0]))
                return out

            return f

        def solve_lap_batched(orig):
            def f(costs, *a, **k):
                res = orig(costs, *a, **k)
                if keep() and k.get("context_key") == "migration_pairs":
                    cur["pairs_col_of"] = host_copy(res.col_of)
                return res

            return f

        def lap_auction(orig):
            def f(a, *args, **kw):
                launches["lap_auction"].append(tuple(a.shape))
                return orig(a, *args, **kw)

            return f

        wrappers = (plan_migration, gpu_pair_costs, solve_lap_batched, lap_auction)
        for (mod_name, attr, what), wrap in zip(self.WATCHED, wrappers):
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr, None)
            if not callable(orig):
                if wrap is plan_migration:
                    raise BenchError(
                        f"{mod_name}.{attr} is gone: the harness reads the previous and the "
                        "logical plan of every round from its arguments, and cannot judge a round "
                        "without them"
                    )
                self.missing.append(f"{mod_name}.{attr} ({what})")
                continue
            setattr(mod, attr, wrap(orig))
            self._undo.append((mod, attr, orig))

        decide = sched.decide

        def timed_decide(*a, **k):
            t0 = time.perf_counter()
            d = decide(*a, **k)
            cur["decide_s"] = time.perf_counter() - t0
            return d

        sched.decide = timed_decide

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []

    def hook(self, rounds, now, decision, states, health) -> None:
        """The simulator's round hook: file this round's record."""
        cur = self.cur
        self.last_now = now
        phys = host_copy(decision.plan.slots)
        if self.keep:
            if "prev" not in cur:
                raise BenchError(
                    "a round of the window did not pass through "
                    "repro_torch.core.scheduler.plan_migration, so its relabel cannot be judged"
                )
            self.rounds.append(
                dict(
                    now=now - self.round_s,
                    placed=np.fromiter((j.job_id for j in decision.placed), np.int64),
                    pending=np.fromiter((j.job_id for j in decision.pending), np.int64),
                    matches=dict(decision.packing.matches),
                    phys=phys,
                    prev_phys=self.last_phys,
                    node_assignment=cur.get("node_assignment"),
                    timings=dict(decision.timings),
                    match_stats=dict(decision.match_stats),
                    prev=cur["prev"],
                    logical=cur["logical"],
                    k5=cur.get("k5"),
                    pairs_col_of=cur.get("pairs_col_of"),
                    decide_s=cur.get("decide_s", 0.0),
                )
            )
        self.last_phys = phys
        cur.clear()


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    t_start: Optional[float] = None,
    manifest: Optional[Dict] = None,
    cell_data=None,
    keep_rounds: bool = False,
    cache_dir: Path = ROOT / "build" / "tesserae_bench",
) -> Dict:
    """Set up, measure, check.  Returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ...) and the
    numbers compared."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    manifest = manifest if manifest is not None else load_manifest()
    cell, config, mix = cell_data if cell_data is not None else resolve(manifest, workload)
    from repro_torch.core.simulator import SimConfig

    round_s = SimConfig(**config.get("sim", {})).round_duration_s
    num_gpus = config["cluster"]["num_nodes"] * config["cluster"]["gpus_per_node"]
    jobs = traffic.make_trace(mix, num_gpus, seed, round_s)
    horizon = traffic.horizon_s(mix, round_s)

    obs = None
    if trace:
        from repro_torch.obs.metrics import Observability

        obs = Observability()
    rec = Recorder(round_s)
    parts = {"build_s": time.perf_counter() - t_start}
    state = warm_state(workload, config, mix, jobs, dev, parts, cache_dir)
    sim, sched = build_system(config, jobs, dev, rec.hook, obs)
    rec.install(sched)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        sim.load_state(str(state))
        parts["loaded_state_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if sim.run(stop_after_rounds=mix["live_rounds"]) is not None:
            raise BenchError("the trace ended during the warm-up")
        _sync(dev)
        parts["live_rounds_s"] = time.perf_counter() - t0
        gc.collect()
        rec.keep = True
        rec.launches["lap_auction"].clear()
        rec.launches["migration_cost"].clear()
        prof = devtrace.Window(obs) if trace and dev.type == "cuda" else None
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        deadline = t0 + seconds
        failed = 0
        error = None
        while True:
            try:
                done = sim.run(stop_after_rounds=1)
            except BenchError:
                raise
            except Exception as exc:  # noqa: BLE001 - a round that raised fails the run
                failed += 1
                error = f"{type(exc).__name__}: {exc}"
                break
            if done is not None or rec.last_now > horizon:
                raise BenchError(
                    f"the window ran past the trace ({len(rec.rounds)} rounds, "
                    f"simulated {rec.last_now:.0f} s of {horizon:.0f} s)"
                )
            if time.perf_counter() >= deadline:
                break
        _sync(dev)
        t1 = time.perf_counter()
        window_s = t1 - t0
        device_info = None
        if prof is not None:
            device_info = prof.stop(t0, t1)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        rec.uninstall()
    rounds = rec.rounds
    n = len(rounds)
    if n == 0:
        raise BenchError("no round completed in the window")

    metrics = {}
    for m in manifest["end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "round_ms":
            value = window_s / n * 1e3
        elif m["name"] == "decide_p95_ms":
            value = yardstick.percentile([r["decide_s"] for r in rounds], 95) * 1e3
        else:
            raise BenchError(f"no measurement for end-to-end metric {m['name']!r}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ctx = dict(
        rounds=rounds,
        window_s=window_s,
        spans=obs.tracer.roots() if obs is not None else [],
        device=device_info,
        launches=rec.launches,
    )
    breakdown = None
    if trace:
        metrics = {}
        for m in manifest["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if device_info is not None:
            breakdown = devtrace.breakdown(device_info)

    counts = band_counts(rounds, num_gpus)
    # the program's state goes before the reference runs
    del sim, sched, obs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    compared, bad_rounds = check(rounds, jobs, config, mix, seed)
    parts["reference_s"] = time.perf_counter() - t_ref
    compared = {"failed_rounds": {"value": failed, "limit": 0}, **compared}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    out = dict(
        correct=bool(correct),
        attempted=n + failed,
        failed=failed + bad_rounds,
        metrics=metrics,
        device=dict(
            platform="gpu" if dev.type == "cuda" else "cpu",
            kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            count=1,
            memory_peak_bytes=int(peak),
        ),
        window=dict(rounds=n, seconds=window_s, **counts, not_watched=rec.missing),
        setup=parts,
        compared=compared,
    )
    if device_info is not None:
        out["device"]["busy_s"] = device_info["busy_s"]
        out["device"]["window_s"] = device_info["window_s"]
    if breakdown is not None:
        out["breakdown"] = breakdown
    if error is not None:
        out["error"] = error
    if keep_rounds:
        out["rounds"], out["jobs"] = rounds, jobs
    return out


def warm_state(workload: str, config: Dict, mix: Dict, jobs: List, dev, parts: Dict, cache_dir: Path) -> Path:
    """The saved state of the simulation ``live_rounds`` short of the
    window's start (round ``warmup_rounds``).

    The warm-up's jobs are the same for every seed (``traffic.make_trace``),
    so that state is the same for every run of the cell in a checkout: the
    first run simulates those rounds once, on a system of its own, and
    saves the state (``Simulator.save_state``) under ``cache_dir``
    (``build/tesserae_bench/`` of the checkout); every run, the first too,
    loads it into a fresh system and runs the last ``live_rounds`` itself,
    so the kernels, the allocator and the matching context are warm and
    every window starts from the same process state."""
    if dev.type == "cuda":
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        build.build_all()
        parts["kernels_s"] = time.perf_counter() - t0
    key = json.dumps([config, mix, dev.type], sort_keys=True).encode()
    path = Path(cache_dir) / f"{workload}-{hashlib.sha256(key).hexdigest()[:16]}.npz"
    if not path.exists():
        t0 = time.perf_counter()
        sim, _ = build_system(config, jobs, dev, None, None)
        if sim.run(stop_after_rounds=mix["warmup_rounds"] - mix["live_rounds"]) is not None:
            raise BenchError("the trace ended during the warm-up")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        sim.save_state(str(tmp))
        os.replace(tmp, path)
        del sim
        gc.collect()
        parts["simulated_state_s"] = time.perf_counter() - t0
    return path


def band_counts(rounds: List[Dict], num_gpus: int) -> Dict:
    """The window's least and most active jobs, pending jobs and share of
    GPUs placed: the traffic's stationarity band as the run saw it."""
    act = [r["placed"].size + r["pending"].size for r in rounds]
    pend = [r["pending"].size for r in rounds]
    used = [float((r["phys"] != -1).any(axis=-1).sum()) / num_gpus for r in rounds]
    return dict(
        active=[min(act), max(act)],
        pending=[min(pend), max(pend)],
        placed_gpu_share=[min(used), max(used)],
    )


def sample_rounds(n: int, k: int, seed: int, longest: int) -> List[int]:
    """``k`` of the window's ``n`` rounds, drawn from the seed, with the
    round of the longest pending queue among them."""
    rng = np.random.default_rng([seed, 1])
    pick = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    pick.discard(longest)
    return sorted([longest] + sorted(pick)[: max(0, k - 1)])


def check(rounds: List[Dict], jobs: List, config: Dict, mix: Dict, seed: int, judge=None):
    """The numbers compared, each with its limit: feasibility on every
    round; K5, the fan-out, the relabel and packing on rounds sampled from
    the seed.  ``judge(rec)`` may put another producer's outputs in a
    round's place (the control).  Returns (compared, rounds that failed)."""
    ref = load_module("reference", config["reference"])
    table = ref.Jobs(jobs)
    gpn = config["cluster"]["gpus_per_node"]
    limits = config["limits"]
    judge = judge or (lambda r: r)
    infeasible = np.array([ref.infeasibility(judge(r), table, gpn, r["prev_phys"]) > 0 for r in rounds])
    bad = infeasible.copy()
    longest = int(np.argmax([r["pending"].size for r in rounds]))
    worst: Dict[str, float] = {}
    for i in sample_rounds(len(rounds), mix["reference_rounds"], seed, longest):
        r = judge(rounds[i])
        nums = ref.relabel_numbers(r, table, gpn)
        nums["pack_gap_over_bound"] = ref.packing_gap(r, table)
        bad[i] |= any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0), v)
    compared = {"infeasible_rounds": {"value": int(infeasible.sum()), "limit": 0}}
    for k in limits:
        if k in worst:  # a number the rounds held nothing to read for is left out
            compared[k] = {"value": worst[k], "limit": limits[k]}
    return compared, int(bad.sum())
