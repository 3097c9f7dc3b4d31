#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tracknetv3_tpu_torch``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name (``benchkit/spec.py``); the traffic
mix's ``runner`` names the module of ``benchkit`` that runs it. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared for ``correct``
beside its limit, which the last lines of standard error repeat. Exits
nonzero with no result where the card is missing, the cell asks for more
cards than there are, the program is not beside the benchmark, or
``jax``, ``jaxlib``, ``flax`` or ``tracknetv3_tpu`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "tracknetv3_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, chips: int, peak: int, rec, trace: bool) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}
    if trace and rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s()
        info["window_s"] = rec.trace.window_s()
    return info


def result(cell, rec, trace: bool, device: dict) -> dict:
    from benchkit.spec import read_metrics

    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, rec, cell.root)
    correct = rec.failed == 0 and all(c.ok for c in rec.checks) and bool(rec.checks)
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        out["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                            "idle_gaps": rec.trace.idle_gaps(10)}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchkit.spec import find_cell

    cell = find_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    import tracknetv3_tpu_torch  # noqa: F401 - the program must be beside the benchmark

    runner = importlib.import_module(f"benchkit.{cell.runner}")
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    to_runner = time.perf_counter() - T_START
    try:
        rec = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", tmp, T_START)
        rec.notes["imports_and_init_s"] = to_runner
        dev = device_info(torch, cell.chips, rec.memory_peak_bytes, rec, bool(args.trace))
        return emit(cell, rec, bool(args.trace), dev, args.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def emit(cell, rec, trace: bool, device: dict, seed: int) -> int:
    """Print the run's details, the checks and, last, the result line;
    print nothing and give 4 where a forbidden module is loaded once
    everything the lines need (the metric readers too) has run."""
    out = result(cell, rec, trace, device)
    info = {"cell": cell.name, "seed": seed, "setup_s": rec.setup_s,
            "window_s": rec.window_s, "memory_peak_bytes": rec.memory_peak_bytes,
            "notes": rec.notes, "spans_s": rec.spans, "traced": rec.traced}
    if rec.trace is not None:
        info["kernel_s_by_category"] = rec.trace.by_category()
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(info), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
