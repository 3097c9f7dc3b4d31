"""Tests of the benchmark itself, on the CPU at tiny sizes; the ones marked
``card`` need a CUDA card and skip elsewhere.

    python -m pytest port_bench/tests            # here
    python -m pytest port_bench/tests -m card    # on the card
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _load(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def tiny_cell(config: str, traffic: str, **limits):
    """A cell of the committed configuration and traffic mix, cut to a size
    the CPU runs in seconds: 48x80 frames, clips of 20-40 frames, train batch 4
    and rallies of 40 frames; ``limits`` replace the configuration's for
    its runner."""
    from benchkit.spec import Cell

    cfg = copy.deepcopy(_load("configs", f"{config}.json"))
    cfg["model"].update(height=48, width=80)
    tr = copy.deepcopy(_load("traffic", f"{traffic}.json"))
    if tr["runner"] == "serve_clips":
        tr.update(length={"frames": [40, 20, 30], "strata": 3}, pool_frames=80,
                  check={"clips": 2, "max_frames": 200, "window_chunks": 5},
                  trace={"skip_clips": 3, "clips": 1})
    else:
        tr.update(rallies=2, frames_per_rally=40, warmup_steps=4, check_steps=3,
                  trace={"skip_steps": 0, "steps": 2})
        cfg["train"]["batch_size"] = 4
    cfg["limits"][tr["runner"]].update(limits)
    return Cell(f"tiny.{config}.{traffic}", 1, config, cfg, traffic, tr, root=ROOT)
