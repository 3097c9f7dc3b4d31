"""BENCHMARK.json against the contract's shape, and cells, configurations,
traffic mixes and metrics found by name, so that new files and entries
add them."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from conftest import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|width")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    # the check's budget at the full 24 cells
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    all_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(all_names) == len(set(all_names))


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric(bench):
    from benchkit.spec import find_cell

    for w in bench["workloads"]:
        cell = find_cell(w["name"], ROOT, bench)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))


def test_a_new_cell_config_traffic_and_metric_are_files_and_entries(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and new entries alone."""
    from benchkit.run_record import RunRecord
    from benchkit.spec import find_cell, read_metrics

    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "port_bench")
    cfg = json.loads((root / "port_bench/configs/tracknetv3.json").read_text())
    cfg["name"] = "tracknetv3_b"
    (root / "port_bench/configs/tracknetv3_b.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "port_bench/traffic/rally_clips.json").read_text())
    tr["batch_size"] = 120
    (root / "port_bench/traffic/rally_clips_b120.json").write_text(json.dumps(tr))
    (root / "port_bench/metrics/serve.clips.py").write_text(
        "def read(run):\n    return len(run.clips) if run.kind == 'serve' else None\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tracknetv3_b", "source": "s", "reduced": [], "why": "w",
                           "file": "port_bench/configs/tracknetv3_b.json"})
    new["workloads"].append({"name": "serve.v3.b120", "config": "tracknetv3_b",
                             "traffic": "rally_clips_b120", "chips": 1, "why": "w"})
    new["per_layer"].append({"name": "serve.clips", "unit": "clips", "better": "higher",
                             "source": "host_clock", "layer": "chunk loop",
                             "moves": "frames_per_s", "workloads": ["serve.v3.b120"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    cell = find_cell("serve.v3.b120", str(root))
    assert cell.traffic["batch_size"] == 120 and cell.config["name"] == "tracknetv3_b"
    assert cell.runner == "serve_clips"
    assert [m["name"] for m in cell.per_layer] == ["serve.clips"]
    run = RunRecord(kind="serve", model=cell.config["model"], clips=[(60, 53, 0.1)])
    assert read_metrics(cell.per_layer, run, str(root)) == {
        "serve.clips": {"value": 1.0, "unit": "clips"}}
    # the committed cells are found as before
    assert find_cell("serve.v3.clips", str(root)).traffic["batch_size"] == 16


def test_unknown_names_are_refused(bench):
    from benchkit.spec import SpecError, find_cell, metric_reader

    with pytest.raises(SpecError):
        find_cell("no.such.cell", ROOT, bench)
    with pytest.raises(SpecError):
        metric_reader("no_such_metric")
    with pytest.raises(SpecError):
        metric_reader("../run")
