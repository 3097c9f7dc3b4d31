"""The result line: its keys, metrics read by name, nothing where there is
nothing to read, and no result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT


def _cell(name):
    from benchkit.spec import find_cell

    return find_cell(name, ROOT)


def test_result_keys_and_checks_last():
    import run
    from benchkit.run_record import Check, RunRecord

    cell = _cell("serve.v3.clips")
    rec = RunRecord(kind="serve", model=cell.config["model"], setup_s=12.5, window_s=51.0,
                    clips=[(240, 233, 0.3), (60, 53, 0.1)], attempted=2,
                    checks=[Check("rows_off", 0.0, 0.0), Check("prob_gap", 1e-4, 1.6e-3)])
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1}
    out = run.result(cell, rec, False, dev)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] == 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "clip_p90_ms", "setup_s"}
    assert out["metrics"]["frames_per_s"] == {"value": 300 / 51.0, "unit": "frames/s"}
    assert out["checks"]["prob_gap"] == {"value": 1e-4, "limit": 1.6e-3}
    json.dumps(out)
    rec.checks.append(Check("inpaint_gap", 1.0, 2e-6))
    assert run.result(cell, rec, False, dev)["correct"] is False
    rec.checks = []
    assert run.result(cell, rec, False, dev)["correct"] is False  # nothing compared


def test_traced_line_without_a_trace_reads_no_device_metric():
    import run
    from benchkit.run_record import RunRecord

    cell = _cell("train.v3.resident")
    rec = RunRecord(kind="train", model=cell.config["model"], batch=10, window_s=51.0,
                    steps=1200, spans={"input": 3.0, "step": 48.0})
    out = run.result(cell, rec, True, {})
    # spans and the host clock read; the device trace's metrics are left out
    assert set(out["metrics"]) == {"train.input_wait_ms", "train.mfu"}
    assert "breakdown" not in out


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve.v3.clips",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_no_program_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark alone the run
    exits nonzero and prints no result."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve.v3.clips",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


_EMIT = """
import json, sys
sys.path[:0] = [sys.argv[1] + '/port_bench', sys.argv[1]]
import run
from benchkit.run_record import Check, RunRecord
from benchkit.spec import find_cell
cell = find_cell('serve.v3.clips', sys.argv[1])
rec = RunRecord(kind='serve', model=cell.config['model'], setup_s=12.5, window_s=51.0,
                clips=[(240, 233, 0.3)], attempted=1, checks=[Check('rows_off', 0.0, 0.0)])
dev = {'platform': 'gpu', 'kind': 'card', 'count': 1, 'memory_peak_bytes': 1}
sys.exit(run.emit(cell, rec, False, dev, 1))
"""


def _emit(root, stub_dir):
    env = dict(os.environ, PYTHONPATH=str(stub_dir))
    return subprocess.run([sys.executable, "-c", _EMIT, str(root)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_forbidden_module_loaded_by_a_metric_reader_gives_no_result(tmp_path):
    """A metric reader runs after the window; a ``jax`` it loads still
    stops the result line (exit 4)."""
    import shutil

    root, stub = tmp_path / "checkout", tmp_path / "stub"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sound = _emit(root, stub)
    assert sound.returncode == 0, sound.stderr
    assert json.loads(sound.stdout.strip().splitlines()[-1])["correct"] is True

    bench["end_to_end"].append({"name": "probe_jax", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "port_bench" / "metrics" / "probe_jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    p = _emit(root, stub)
    assert p.returncode == 4 and p.stdout.strip() == ""
    assert "jax" in p.stderr
