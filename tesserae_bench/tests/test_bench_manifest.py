"""``BENCHMARK.json`` against the contract's shape, and every cell's
files found by name."""

import json
import re

import pytest

from tesserae_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(1 <= len(w) <= 200 and "\t" not in w for w in cmd)
    assert any(w.startswith(manifest["paths"][0] + "/") for w in cmd)
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_run_seconds_fits_the_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text_fields(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for text in [c["source"] for c in manifest["configs"]] + [
        x["why"] for x in manifest["configs"] + manifest["workloads"]
    ] + [m["layer"] for m in manifest["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))


def test_bounds_and_metric_links(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and 1 < len(e2e) <= 16
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_every_cell_resolves_its_files(manifest, cell):
    w, config, mix = harness.resolve(manifest, cell)
    assert config["name"] == w["config"] and mix["name"] == w["traffic"]
    assert (harness.BENCH / "reference" / f"{config['reference']}.py").exists()
    reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    assert {"setup_s"} < {m["name"] for m in reported}
    layers = [m for m in manifest["per_layer"] if cell in m.get("workloads", [cell])]
    assert layers
    for m in layers:
        assert callable(harness.load_module("metrics", m["name"]).read)
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    assert entry["file"].startswith(manifest["paths"][0] + "/")
    assert sorted(config["reduced"]) == sorted(entry["reduced"])


def test_every_config_is_used(manifest):
    assert {c["name"] for c in manifest["configs"]} == {w["config"] for w in manifest["workloads"]}
