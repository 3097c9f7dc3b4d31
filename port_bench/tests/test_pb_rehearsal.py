"""Each cell's runner end to end on the CPU at a tiny size: the program's
entry sequence, the window, the read-back and the comparison with the
plain reference. No device metric comes out of these runs: run.py, which
prints the result line, refuses to run without a card."""

from __future__ import annotations

import time

import pytest

from conftest import tiny_cell

SEED = 2**31 + 77


@pytest.mark.parametrize("config", ["tracknetv3", "tracknetv2"])
def test_serving_cell_rehearsal(config, tmp_path):
    from benchkit import serve_clips

    cell = tiny_cell(config, "rally_clips")
    rec = serve_clips.run(cell, SEED, 2.0, False, "cpu", str(tmp_path), time.perf_counter())
    assert rec.failed == 0 and rec.clips and rec.window_s >= 2.0
    names = {c.name for c in rec.checks}
    assert names == ({"rows_off", "prob_gap", "frame_gap", "inpaint_gap"}
                     if config == "tracknetv3" else {"rows_off", "prob_gap"})
    assert all(c.ok for c in rec.checks), rec.checks
    # every sampled clip of the first cycle was served and held to the reference
    assert rec.notes["checked_clips"] == rec.notes["sampled_clips"] >= 1
    assert rec.memory_peak_bytes == 0 and rec.trace is None  # no device reading on the CPU
    assert set(rec.spans) == {"stage", "run", "post"}


@pytest.mark.parametrize("traffic", ["train_readme", "train_resident"])
def test_training_cell_rehearsal(traffic, tmp_path):
    from benchkit import train_steps

    cell = tiny_cell("tracknetv3", traffic, head_grad_diff=0.1)
    rec = train_steps.run(cell, SEED, 2.0, False, "cpu", str(tmp_path), time.perf_counter(),
                          data_root=str(tmp_path))
    assert rec.failed == 0 and rec.steps > 0
    assert {c.name for c in rec.checks} == {"head_grad_diff", "change_gap"}
    assert all(c.ok for c in rec.checks), rec.checks
    assert rec.notes["split_written"] and rec.notes["gaps"]["leaves_left_out"] == 0
    # a second run finds the split written
    rec2 = train_steps.run(cell, SEED + 1, 0.5, False, "cpu", str(tmp_path),
                           time.perf_counter(), data_root=str(tmp_path))
    assert not rec2.notes["split_written"]
