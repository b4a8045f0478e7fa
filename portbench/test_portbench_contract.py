"""``BENCHMARK.json`` holds together: every name resolves to its files,
every cell reports set-up, another end-to-end metric and a per-layer
one, and the fields keep their forms."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(w["config"])
    assert spec.traffic(w["traffic"])["loop"] in ("serve", "train")
    assert (spec.ROOT / "limits" / f"{cell}.json").is_file()
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS
