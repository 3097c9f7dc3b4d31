"""The port's tracing module (``tracknetv3_tpu_torch/utils/profiling.py``):
spans that cost a flag check unless a profiler records, counters with a
total and a recorded view, ``spans.json``'s attribution of the device's
idle time and of the host's synchronisations to the innermost program span,
and the spans of the serving and training paths on the CPU. The last test
needs a CUDA card (it skips without one): a staged clip under ``trace``,
whose attributed idle must sum to the trace's idle.

This file imports no JAX, so that the card test runs on a machine without
it (``python -m pytest tests/test_torch_profiling.py --noconftest``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from torch_dp_data import crossing_mixup, tracknet_batch, tracknet_model  # noqa: E402
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

SERVE_SPANS = {"serve::upload", "serve::yuv420_to_rgb", "serve::median", "serve::preprocess",
               "serve::forward", "serve::decode", "serve::fetch", "serve::inpaint",
               "serve::csv"}
TRAIN_SPANS = {"train::input_wait", "train::h2d", "train::assemble", "train::forward",
               "train::backward", "train::optimizer"}


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_span_records_nothing_and_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with profiling.span("serve::decode"):
        pass
    assert opened == []
    assert profiling.recorded() == {"spans": {}, "counters": {}}
    assert profiling.span("a::b") is profiling.span("c::d")  # one shared no-op


def test_spans_add_seconds_and_counts_and_nest_in_the_trace_in_call_order(tmp_path):
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("serve::outer"):
                with profiling.span("serve::inner"):
                    torch.ones(64).sum()
        with profiling.span("train::after"):
            pass
    spans = profiling.recorded()["spans"]
    assert {k: v["n"] for k, v in spans.items()} == {"serve::outer": 3, "serve::inner": 3,
                                                      "train::after": 1}
    assert 0 < spans["serve::inner"]["s"] <= spans["serve::outer"]["s"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in _annotations(tmp_path / "trace.json")))
    assert [r[2] for r in ranges] == ["serve::outer", "serve::inner"] * 3 + ["train::after"]
    for (a0, b0, _), (a1, b1, _) in zip(ranges[0:6:2], ranges[1:6:2]):
        assert a0 <= a1 and b1 <= b0
    written = json.loads((tmp_path / "spans.json").read_text())
    assert {k: v["n"] for k, v in written["spans"].items()} == {
        "serve::outer": 3, "serve::inner": 3, "train::after": 1}


def test_counters_go_to_both_views_while_recording_and_to_the_total_alone_otherwise():
    profiling.count("h2d_bytes", 5)
    with torch.profiler.profile():
        profiling.count("h2d_bytes", 7)
        profiling.count("launch.widget")
    profiling.count("launch.widget", 2)
    c = profiling.counters()
    assert c["h2d_bytes"] == 12 and c["launch.widget"] == 3
    assert profiling.recorded()["counters"] == {"h2d_bytes": 7, "launch.widget": 1}
    c["h2d_bytes"] = 0  # a snapshot
    assert profiling.counters()["h2d_bytes"] == 12


def test_reset_clears_both_views():
    profiling.declare("launch.widget")
    with torch.profiler.profile():
        profiling.count("launch.widget", 4)
        with profiling.span("serve::x"):
            pass
    profiling.reset()
    assert profiling.counters()["launch.widget"] == 0
    assert profiling.recorded() == {"spans": {}, "counters": {}}


def test_h2d_counts_only_copies_that_leave_the_host():
    t = torch.zeros(6, dtype=torch.float64)
    assert profiling.h2d(t, torch.device("cpu")) is t
    assert profiling.counters().get("h2d_bytes", 0) == 0


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


def test_summary_puts_idle_and_syncs_down_to_the_innermost_span():
    events = [
        _x("Trace", "profile", 0, 100),
        _x("user_annotation", "serve::outer", 10, 60),   # [10, 70)
        _x("user_annotation", "serve::inner", 30, 20),   # [30, 50)
        _x("user_annotation", "bench.run", 0, 100),      # not a program span
        _x("kernel", "k1", 0, 20),
        _x("gpu_memcpy", "copy", 18, 14),                # busy [0, 32)
        _x("kernel", "k2", 44, 4),                       # busy [44, 48)
        _x("gpu_memset", "set", 60, 30),                 # busy [60, 90)
        _x("cuda_runtime", "cudaStreamSynchronize", 35, 9),
        _x("cuda_runtime", "cudaMemcpy", 52, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 36, 1),  # no sync
        _x("cuda_runtime", "cudaDeviceSynchronize", 95, 3),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    out = profiling.summarize(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(66e-6)
    assert out["idle_s"] == pytest.approx(34e-6)
    # gaps: [32, 44) mid 38 inner; [48, 60) mid 54 outer; [90, 100) mid 95 none
    assert out["idle_by_span"] == pytest.approx({"serve::inner": 12e-6, "serve::outer": 12e-6,
                                                 "none": 10e-6})
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["idle_s"])
    assert out["syncs_by_span"] == {
        "serve::inner": {"n": 1, "s": pytest.approx(9e-6)},
        "serve::outer": {"n": 1, "s": pytest.approx(2e-6)},
        "none": {"n": 1, "s": pytest.approx(3e-6)}}
    assert out["spans"] == {"serve::outer": {"s": pytest.approx(60e-6), "n": 1},
                            "serve::inner": {"s": pytest.approx(20e-6), "n": 1}}


def test_summary_of_a_trace_without_device_work_is_all_idle():
    out = profiling.summarize([_x("user_annotation", "train::step", 0, 10)])
    assert out["busy_s"] == 0 and out["idle_s"] == pytest.approx(10e-6)
    assert out["idle_by_span"] == pytest.approx({"train::step": 10e-6})
    assert profiling.summarize([])["window_s"] == 0.0


H, W = 32, 64


def _predictor(tmp_path, eval_mode: str, device="cpu", hw=(H, W), batch=4,
               dtype=torch.float32):
    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    gen = torch.Generator().manual_seed(0)
    tn, inp = str(tmp_path / "tn.pt"), str(tmp_path / "inp.pt")
    save_checkpoint(tn, epoch=0, max_val_acc=0.0,
                    model=get_model("TrackNet", 3, "concat", generator=gen),
                    param_dict={"model_name": "TrackNet", "seq_len": 3, "bg_mode": "concat"})
    save_checkpoint(inp, epoch=0, max_val_acc=0.0, model=get_model("InpaintNet", generator=gen),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    return TrackNetPredictor(tn, inp, eval_mode=eval_mode, batch_size=batch, compute_dtype=dtype,
                             input_hw=hw, device=device)


def _serve(p, frames: int, csv_path: str, hw=(H, W)):
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    rng = np.random.default_rng(0)
    yuv = rng.integers(0, 256, (frames, hw[0] * hw[1] * 3 // 2), dtype=np.uint8)
    staged = p.finalize_staged(p.upload_staged(yuv, yuv=True))
    pred = p.inpaint_trajectory(p.run_staged(staged), (2 * hw[1], 2 * hw[0]))
    write_pred_csv(pred, csv_path)
    return pred


@pytest.mark.parametrize("eval_mode", ["weight", "nonoverlap"])
def test_a_cpu_clip_records_every_serving_span(tmp_path, eval_mode):
    p = _predictor(tmp_path, eval_mode)
    with torch.profiler.profile():
        pred = _serve(p, 19, str(tmp_path / "clip.csv"))
    assert len(pred["Frame"]) == 19
    spans = profiling.recorded()["spans"]
    want = SERVE_SPANS - ({"serve::ensemble"} if eval_mode == "nonoverlap" else set())
    assert want <= set(spans), sorted(spans)
    assert ("serve::ensemble" in spans) == (eval_mode != "nonoverlap")
    windows = 19 - 2 if eval_mode != "nonoverlap" else -(-19 // 3)
    chunks = -(-windows // 4)
    assert spans["serve::forward"]["n"] == chunks
    assert spans["serve::fetch"]["n"] == spans["serve::csv"]["n"] == 1


def test_a_cpu_train_step_records_every_training_span():
    from tracknetv3_tpu_torch.parallel.mesh import make_mesh
    from tracknetv3_tpu_torch.training import optim, steps
    from tracknetv3_tpu_torch.training.loop import prefetch_to_device

    model = tracknet_model(dtype=torch.float32)
    opt, schedule = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    mesh = make_mesh(1, device="cpu")
    step = steps.make_tracknet_shares_train_step(model, opt, "concat", 0.5, schedule, mesh=mesh)
    batches = [tracknet_batch("plain", B=4, seed=s) for s in range(2)]
    perm, lam = crossing_mixup(4)
    with torch.profiler.profile():
        for i, shares in enumerate(prefetch_to_device(batches, torch.device("cpu"), mesh=mesh)):
            loss = step(shares, i, perm, lam)
    assert torch.isfinite(loss)
    spans = profiling.recorded()["spans"]
    assert TRAIN_SPANS <= set(spans), sorted(spans)
    assert spans["train::assemble"]["n"] == spans["train::optimizer"]["n"] == 2
    assert spans["train::input_wait"]["n"] == 3  # the end of the feed too
    assert profiling.recorded()["counters"].get("h2d_bytes", 0) == 0  # the host is the device


def test_a_staged_clip_on_the_card_puts_all_idle_down_to_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _predictor(tmp_path, "weight", device="cuda", hw=(288, 512), batch=16,
                   dtype=torch.bfloat16)
    _serve(p, 64, str(tmp_path / "warm.csv"), hw=(288, 512))  # builds the kernels
    torch.cuda.synchronize()
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        _serve(p, 200, str(tmp_path / "clip.csv"), hw=(288, 512))
        torch.cuda.synchronize()
    written = json.loads((out / "spans.json").read_text())
    with open(out / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")):
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    idle = (hi - lo - busy) * 1e-6
    assert idle > 0
    assert sum(written["idle_by_span"].values()) == pytest.approx(idle, rel=0.01)
    assert SERVE_SPANS <= set(written["spans"])
    assert written["counters"]["h2d_bytes"] >= 200 * 288 * 512 * 3 // 2
    assert written["counters"]["launch.conv3x3_9tap"] == 17 * -(-(200 - 2) // 16)
    assert set(written["idle_by_span"]) & SERVE_SPANS
