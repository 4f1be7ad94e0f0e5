"""The yardstick's arithmetic and the per-layer metric readers."""

import types

import pytest

from tesserae_bench import devtrace, harness, yardstick


def test_nearest_rank_percentile():
    vals = list(range(1, 101))
    assert yardstick.percentile(vals, 50) == 50
    assert yardstick.percentile(vals, 95) == 95
    assert yardstick.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_busy_union_and_idle_gaps():
    busy = yardstick.union([(5, 7), (1, 3), (2, 4), (9, 20), (-5, 0)], 0, 10)
    assert busy == [(1, 4), (5, 7), (9, 10)]
    assert yardstick.gaps(busy, 0, 10) == [(0, 1), (4, 5), (7, 9)]


def test_least_bytes():
    assert yardstick.lap_auction_bytes(2, 3, 5) == 2 * 3 * (4 * 5 + 4)
    assert yardstick.migration_cost_bytes(4, 6) == 10 * 2 * 12 + 8 * 24


def test_short_names():
    assert devtrace.short_name("void (anonymous namespace)::auction_warp_kernel<false, 4>(float const*, int)") == "auction_warp_kernel<false, 4>"
    assert devtrace.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def _span(name, t0, dur, children=()):
    return types.SimpleNamespace(name=name, t0=t0, dur_s=dur, children=list(children))


def test_idle_time_split_by_the_innermost_span():
    spans = [
        _span("round", 0.0, 1.0, [_span("decide", 0.1, 0.5, [_span("pack", 0.2, 0.1)]), _span("advance_round", 0.7, 0.2)]),
        _span("round", 2.0, 1.0),
    ]
    segs = devtrace.innermost(spans, (0.0, 2.5))
    assert [n for *_, n in segs] == ["round", "decide", "pack", "decide", "round", "advance_round", "round", "no span", "round"]
    assert segs[0][0] == 0.0 and segs[-1][1] == 2.5
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    got = {}
    for name, t in devtrace.overlaps([(0.15, 0.25), (0.95, 2.1)], segs):
        got[name] = got.get(name, 0) + t
    assert got == pytest.approx({"decide": 0.05, "pack": 0.05, "round": 0.15, "no span": 1.0})


def _ctx(device=None):
    rounds = [dict(timings=dict(schedule_s=0.001, place_s=0.002, pack_s=0.01, migrate_s=0.02),
                   match_stats=dict(memo_instances=3, warm_instances=4, cold_instances=6, host_syncs=8))] * 4
    spans = [_span("round", 0, 0.1, [_span("decide", 0, 0.08)])] * 4
    return dict(rounds=rounds, window_s=0.5, spans=spans, device=device,
                launches={"lap_auction": [(10, 4, 4)] * 3, "migration_cost": [(64, 64)] * 4})


def test_metric_readers_on_a_known_window():
    read = lambda name, ctx: harness.load_module("metrics", name).read(ctx)  # noqa: E731
    ctx = _ctx()
    assert read("place_ms", ctx) == pytest.approx(3.0)
    assert read("pack_ms", ctx) == pytest.approx(10.0)
    assert read("migrate_ms", ctx) == pytest.approx(20.0)
    assert read("sim_host_ms", ctx) == pytest.approx((0.5 - 0.32) / 4 * 1e3)
    assert read("lap_memo_pct", ctx) == pytest.approx(30.0)
    assert read("host_syncs_per_round", ctx) == 8
    for name in ("lap_auction_roofline_pct", "migration_cost_roofline_pct", "device_idle_pct"):
        assert read(name, ctx) is None  # no device trace: nothing to read, never 0
    dev = dict(busy_s=0.1, window_s=0.5, idle_by_span={},
               kernel_s={"auction_warp_kernel<false, 4>": 1e-6, "migration_cost_kernel<8>": 2e-6})
    ctx = _ctx(dev)
    assert read("device_idle_pct", ctx) == pytest.approx(80.0)
    least = 3 * yardstick.lap_auction_bytes(10, 4, 4) / yardstick.HBM_BW
    assert read("lap_auction_roofline_pct", ctx) == pytest.approx(100 * least / 1e-6)
    least = 4 * yardstick.migration_cost_bytes(64, 64) / yardstick.HBM_BW
    assert read("migration_cost_roofline_pct", ctx) == pytest.approx(100 * least / 2e-6)
