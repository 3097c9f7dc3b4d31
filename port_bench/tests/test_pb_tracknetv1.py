"""The ``serve.v1.clips`` cell (TrackNetV1, the original TrackNet) on the
CPU at a tiny size: found by name, rehearsed end to end through its runner
and the plain reference, not correct with a moved answer or with the
BatchNorm before the ReLU, and its new metric readers silent where a run
holds nothing for them."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest

from conftest import BENCH_DIR, ROOT

torch = pytest.importorskip("torch")

SEED = 2**31 + 1234
CELL = "serve.v1.clips"


def _tiny_cell(**limits):
    """The committed configuration and traffic mix at 48x80, clips of 20-40
    frames, two sampled clips; ``limits`` replace the configuration's."""
    from benchkit.spec import Cell

    with open(os.path.join(BENCH_DIR, "configs", "tracknetv1.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", "rally_clips_v1.json")) as f:
        tr = json.load(f)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["model"].update(height=48, width=80)
    tr.update(length={"frames": [40, 20, 30], "strata": 3}, pool_frames=80,
              check={"clips": 2, "max_frames": 200, "window_chunks": 4},
              trace={"skip_clips": 3, "clips": 1}, batch_size=8)
    cfg["limits"]["serve_clips_v1"].update(limits)
    return Cell("tiny.tracknetv1.rally_clips_v1", 1, "tracknetv1", cfg, "rally_clips_v1", tr,
                root=ROOT)


def _run(tmp_path, seconds=1.0, **limits):
    from benchkit import serve_clips_v1

    rec = serve_clips_v1.run(_tiny_cell(**limits), SEED, seconds, False, "cpu", str(tmp_path),
                             time.perf_counter())
    assert rec.notes["checked_clips"] == rec.notes["sampled_clips"] >= 1
    return rec


def _correct(rec) -> bool:
    return rec.failed == 0 and bool(rec.checks) and all(c.ok for c in rec.checks)


def test_the_cell_is_found_by_name():
    from benchkit.spec import find_cell

    cell = find_cell(CELL, ROOT)
    assert cell.runner == "serve_clips_v1" and cell.chips == 1
    assert cell.config["model"]["arch"] == "TrackNetV1" and cell.traffic["batch_size"] == 16
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "clip_p90_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"serve.v1.conv_roofline", "serve.v1.mfu", "serve.classify_ms"} <= names
    assert not names & {"serve.conv_roofline", "serve.mfu"}  # they count U-Net FLOPs
    with open(os.path.join(BENCH_DIR, "traffic", "rally_clips.json")) as f:
        v3 = json.load(f)
    for key in ("length", "pool_frames", "source_wh", "batch_size"):
        assert cell.traffic[key] == v3[key]


def test_rehearsal_is_correct_and_reads_the_program_spans(tmp_path):
    rec = _run(tmp_path, seconds=2.0)
    assert rec.failed == 0 and rec.clips and rec.window_s >= 2.0
    assert {c.name for c in rec.checks} == {"rows_off", "logit_gap"}
    assert _correct(rec), rec.checks
    nums = {c.name: c.value for c in rec.checks}
    # the program's bfloat16 logits against the float32 reference: apart, within the limit
    assert nums["rows_off"] == 0 and 0 < nums["logit_gap"]
    assert set(rec.spans) == {"stage", "run", "post"} and rec.trace is None
    # every clip's windows: one a frame from frame 2 on
    assert all(w == n - 2 for n, w, _ in rec.clips)


def test_a_moved_answer_is_not_correct(tmp_path, monkeypatch):
    """The decode moves one frame's detection by 10 pixels."""
    import tracknetv3_tpu_torch.inference as inference

    decode = inference.decode_heatmaps

    def moved(maps, *a, **k):
        out = decode(maps, *a, **k)
        out["cx"] = out["cx"].clone()
        out["cx"].view(-1)[0] += 10
        return out

    monkeypatch.setattr(inference, "decode_heatmaps", moved)
    rec = _run(tmp_path)
    assert not _correct(rec)
    assert {c.name: c.value for c in rec.checks}["rows_off"] >= 1


def test_the_batchnorm_before_the_relu_is_not_correct(tmp_path, monkeypatch):
    """The served forward applies each block's affine before its ReLU."""
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.models import fused_forward

    def swapped(x, w, b, scale, shift, backend):
        wt = w.reshape(3, 3, -1, w.shape[-1]).permute(3, 2, 0, 1).float()
        y = F.conv2d(x.float(), wt, padding=1) + b.reshape(1, -1, 1, 1)
        y = y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
        return y.relu().to(x.dtype).contiguous(memory_format=torch.channels_last)

    monkeypatch.setattr(fused_forward, "_conv_relu_affine", swapped)
    rec = _run(tmp_path, seconds=0.5)
    nums = {c.name: c for c in rec.checks}
    assert not _correct(rec) and not nums["logit_gap"].ok and nums["logit_gap"].value != float(
        "inf"), rec.checks


@pytest.mark.parametrize("name", ["serve.v1.conv_roofline", "serve.v1.mfu",
                                  "serve.classify_ms"])
def test_new_readers_are_silent_without_what_they_read(name, monkeypatch):
    from benchkit.run_record import RunRecord
    from benchkit.spec import find_cell, metric_reader

    from tracknetv3_tpu_torch.utils import profiling

    model = find_cell(CELL, ROOT).config["model"]
    read = metric_reader(name, ROOT).read
    # an untraced run, and a traced one in which no kernel ran
    untraced = RunRecord(kind="serve", model=model, clips=[(100, 98, 0.2)], window_s=1.0)
    monkeypatch.setattr(profiling, "recorded", lambda: {"spans": {}, "counters": {}})
    if name == "serve.v1.mfu":
        assert read(untraced) > 0  # host clock: no trace needed
        assert read(RunRecord(kind="serve", model={"arch": "TrackNet"},
                              clips=[(100, 98, 0.2)], window_s=1.0)) is None
        assert read(RunRecord(kind="train", model=model)) is None
    else:
        assert read(untraced) is None
    from benchkit.trace import DeviceTrace

    traced = RunRecord(kind="serve", model=model, trace=DeviceTrace([], 0.0, 1.0),
                       traced={"frames": 100, "windows": 98, "clips": 1, "host_s": 0.1})
    if name in ("serve.classify_ms", "serve.v1.conv_roofline"):
        assert read(traced) is None  # no argmax or conv kernel ran


def test_classify_ms_reads_the_argmax_kernels_inside_the_run():
    """Device time of the argmax kernels that start inside ``bench.run``, in
    microseconds a frame (= ms per 1000 frames); other kernels, and argmax
    kernels outside the run, do not count."""
    from benchkit.run_record import RunRecord
    from benchkit.spec import metric_reader
    from benchkit.trace import DeviceTrace

    argmax = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, "
              "at::native::ArgMaxOps<float>, unsigned int, long, 4> >")
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.run", "ts": 100, "dur": 900},
              {"ph": "X", "cat": "kernel", "name": argmax, "ts": 200, "dur": 300},
              {"ph": "X", "cat": "kernel", "name": argmax, "ts": 600, "dur": 200},
              {"ph": "X", "cat": "kernel", "name": "conv3x3_9tap_kernel", "ts": 500, "dur": 90},
              {"ph": "X", "cat": "kernel", "name": argmax, "ts": 1500, "dur": 400}]
    run = RunRecord(kind="serve", model={"arch": "TrackNetV1"},
                    trace=DeviceTrace(events, 0.0, 2000.0),
                    traced={"frames": 100, "windows": 98, "clips": 1, "host_s": 0.1})
    assert metric_reader("serve.classify_ms", ROOT).read(run) == pytest.approx(500 / 100)


def test_the_roofline_counts_the_published_network():
    from benchkit import roofline_v1
    from benchkit.spec import find_cell

    model = find_cell(CELL, ROOT).config["model"]
    layers = roofline_v1.conv_layers(model)
    assert len(layers) == 18 and layers[0][1:] == (9, 64) and layers[-1][1:] == (64, 256)
    assert [p for p, _, _ in layers][7:10] == [45 * 80] * 3
    assert roofline_v1.forward_flops(model) == pytest.approx(367.6e9, rel=1e-3)
    # the head alone: 64 -> 256 at full resolution
    assert 2 * 9 * 360 * 640 * 64 * 256 == pytest.approx(67.9e9, rel=1e-3)


def test_the_new_modules_load_no_jax_and_the_reference_none_of_the_program():
    import subprocess
    import sys

    def loaded(code):
        p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
        assert p.returncode == 0, p.stderr
        return set(json.loads(p.stdout.strip().splitlines()[-1]))

    head = "import json, sys; sys.path[:0] = ['port_bench', '.']\n"
    tail = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    tops = loaded(head + "import benchkit.serve_clips_v1, benchkit.weights_v1, "
                  "benchkit.roofline_v1, reference.tracknet_v1\n" + tail)
    assert not tops & {"jax", "jaxlib", "flax", "tracknetv3_tpu"}
    tops = loaded(head + "import reference.tracknet_v1\n" + tail)
    assert "tracknetv3_tpu_torch" not in tops and "jax" not in tops
