"""The six readers of the program's stage spans, on hand-made spans: the
hand-computed value where the spans are there, and ``None`` (never an
error) on a program without them."""

import pytest

from tesserae_bench import harness

from repro_torch.obs.tracer import Span

READERS = (
    "lap_host_ms", "pack_lap_dev_ms", "migrate_lap_dev_ms",
    "migrate_cost_ms", "pack_graph_ms", "sim_self_ms",
)


def sp(name, ms=0.0, device_ms=None, children=(), **attrs):
    s = Span(name, attrs, 0, 0)
    s.dur_s = ms * 1e-3
    s.device_s = None if device_ms is None else device_ms * 1e-3
    s.children = list(children)
    return s


def solve(family, ms, device_ms=None, staged=True, run=True):
    kids = []
    if staged:
        kids = [sp("lap.prepare"), sp("lap.identity")]
        if run:
            kids.append(sp("lap.run", device_ms=device_ms))
        kids.append(sp("lap.check"))
    return sp("lap.solve", ms, children=kids, family=family)


def round_spans(graph, pack, pairs, node, cost, sim, staged=True, hook=3.0):
    """One round's roots; ``pack``/``pairs``/``node`` are (wall ms, lap.run
    device ms or None for a memo-served solve), ``sim`` the five
    simulator spans' ms."""
    ev, scan, adv, hand, cont = sim
    pack_kids = [solve("packing", pack[0], pack[1], staged)]
    mig_kids = [
        solve("migration_pairs", pairs[0], pairs[1], staged, run=pairs[1] is not None),
        solve("migration_node", node[0], node[1], staged),
    ]
    if staged:
        pack_kids = [sp("pack.graph", graph)] + pack_kids + [sp("pack.apply")]
        mig_kids = [sp("migrate.prepare"), sp("migrate.cost", cost, 0.1)] + mig_kids
    decide = sp("decide", children=[sp("pack", children=pack_kids),
                                     sp("migrate.host", children=mig_kids)])
    roots = [sp("apply_events", ev)]
    if staged:
        roots.append(sp("sim.scan", scan))
    roots.append(sp("round", children=[decide, sp("advance_round", adv)]))
    if staged:
        roots += [sp("sim.handover", hand), sp("sim.hook", hook), sp("sim.contention", cont)]
    return roots


def ctx_of(spans, rounds=2):
    return dict(rounds=[{}] * rounds, spans=spans, window_s=1.0, device=None, launches={})


def window(staged=True, device=True):
    d = (lambda x: x) if device else (lambda x: None)
    return ctx_of(
        round_spans(4, (30, d(20)), (6, d(1)), (2, d(0.5)), 3, (1, 5, 10, 2, 1), staged)
        + round_spans(6, (40, d(30)), (4, None), (2, d(0.7)), 5, (2, 7, 12, 2, 1), staged)
    )


@pytest.mark.parametrize(
    "name,want",
    [
        # (30+6+2 + 40+4+2) - (20+1+0.5 + 30+0.7), over 2 rounds
        ("lap_host_ms", (84 - 52.2) / 2),
        ("pack_lap_dev_ms", (20 + 30) / 2),
        ("migrate_lap_dev_ms", (1 + 0.5 + 0.7) / 2),
        ("migrate_cost_ms", (3 + 5) / 2),
        ("pack_graph_ms", (4 + 6) / 2),
        # apply_events, sim.scan, advance_round, sim.handover, sim.contention
        ("sim_self_ms", ((1 + 5 + 10 + 2 + 1) + (2 + 7 + 12 + 2 + 1)) / 2),
    ],
)
def test_reader_gives_the_hand_computed_value(name, want):
    assert harness.load_module("metrics", name).read(window()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_stage_spans(name):
    reader = harness.load_module("metrics", name).read
    assert reader(window(staged=False)) is None  # the spans of a program without them
    assert reader(ctx_of([])) is None
    assert reader(ctx_of([], rounds=0)) is None


def test_device_readers_need_a_device_time():
    """On the CPU (no device timer) the two device-time readers give
    ``None`` and the engine's host time is all of ``lap.solve``."""
    ctx = window(device=False)
    for name in ("pack_lap_dev_ms", "migrate_lap_dev_ms"):
        assert harness.load_module("metrics", name).read(ctx) is None
    assert harness.load_module("metrics", "lap_host_ms").read(ctx) == pytest.approx(84 / 2)
