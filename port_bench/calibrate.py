#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control_seeds 1,2,3]

For each seed, what a run of the cell checks, without a timed window: the
program against the reference; for each control seed also the control
(the reference in the next lower precision, fp8 for the bfloat16 network,
TF32 for float32 InpaintNet) and, for a training cell, the reference over
half of each batch, each in the program's place. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control_seeds", type=seeds, default=[])
    args = ap.parse_args(argv)

    import torch

    from benchkit.spec import find_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(args.workload, ROOT)
    runner = importlib.import_module(f"benchkit.{cell.runner}")
    torch.backends.cudnn.benchmark = True
    tmp = tempfile.mkdtemp(prefix="port_bench_cal_")
    try:
        for seed in args.seeds:
            control = seed in args.control_seeds
            (row,) = runner.calibrate(cell, [seed], "cuda", tmp, control=control)
            print(json.dumps({"cell": cell.name, **row}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
