"""Serving runner for TrackNetV1 (the original TrackNet): one client sends
rally clips, one after another.

The same closed loop and clip sequence as ``serve_clips``, whose helpers it
imports: each clip takes the path that ``inference.predict_video`` takes
for a TrackNetV1 checkpoint after decode: ``upload_staged`` (planar YUV420
at model resolution) -> ``finalize_staged`` (YUV420 -> RGB; no median) ->
``run_staged`` (one window a frame, newest first; the folded forward with
the ReLU -> BatchNorm epilogue; the 256-way argmax; the decode; the one
fetch) -> ``utils.io.write_pred_csv``. Decode of video is left out: the
card's machine has no libav and no cv2.

Set-up: the seeded weights with the detector path (``weights_v1``, made
on the device) written as the predictor's checkpoint, the predictor, the
pool of YUV420 frames, and one warm-up clip of the shortest length.

``correct``: a sample of the mix's first cycle is drawn from the seed
(``serve_clips.pick``). While the window serves those clips,
``serve_clips.Recorder`` keeps a copy of the class logits that
``TrackNetPredictor._windows`` returns for a seeded sample of chunks, on the
device in the program's dtype (its ``windows``; TrackNetV1 calls no
ensemble and has no InpaintNet, so it keeps nothing else). Once the window has closed, each
sampled clip's CSV rows are held to the plain reference
(``reference.tracknet_v1.clip_rows``, float32, TF32 off), as ``rows_off``,
and the kept logits to the reference's logits of the same windows, as
``logit_gap``, the largest absolute difference.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import torch

from . import scene, weights_v1
from .run_record import Check, RunRecord
from .serve_clips import Recorder, pick, read_csv_rows, worst
from .trace import Profiled, Spans
from .traffic import clip_lengths, clip_sequence, torch_seed

SEQ_LEN = 3


class Served:
    """The program under test and the inputs of one run."""

    def __init__(self, cell, seed: int, device, tmp: str):
        from tracknetv3_tpu_torch.inference import TrackNetPredictor

        self.cell, self.seed, self.device, self.tmp = cell, seed, torch.device(device), tmp
        self.setup_s: Dict[str, float] = {}
        t0 = time.perf_counter()
        cfg, tr = cell.config, cell.traffic
        self.model = cfg["model"]
        self.h, self.w = int(self.model["height"]), int(self.model["width"])
        self.batch = int(tr["batch_size"])
        self.src_wh = tuple(tr["source_wh"])
        self.sd = weights_v1.state(torch_seed(seed, 2), self.device)
        weights_v1.set_detector(self.sd, cfg["detector"])
        path = weights_v1.write_checkpoint(os.path.join(tmp, "TrackNetV1_best.pt"), self.sd,
                                           self.h, self.w)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.model["compute_dtype"]]
        self.predictor = TrackNetPredictor(
            path, batch_size=self.batch, compute_dtype=dtype, input_hw=(self.h, self.w),
            device=self.device, conv_backend=self.model.get("conv_backend"))
        if getattr(self.predictor, "arch", None) != "TrackNetV1":
            raise RuntimeError("the program did not load the checkpoint as TrackNetV1")
        self.setup_s["weights_and_predictor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pool = scene.yuv_pool(torch_seed(seed, 4), int(tr["pool_frames"]), self.h, self.w,
                                   self.device)
        self.csv_dir = os.path.join(tmp, "csv")
        os.makedirs(self.csv_dir, exist_ok=True)
        self.setup_s["pool"] = time.perf_counter() - t0

    @staticmethod
    def windows(n: int) -> int:
        """Windows of an n-frame clip: one a frame from frame 2 on."""
        return max(n - SEQ_LEN + 1, 0)

    def chunks(self, n: int) -> int:
        """Forward calls of an n-frame clip: its windows in batches."""
        return -(-self.windows(n) // self.batch)

    def serve(self, n: int, offset: int, path: str, spans: Spans) -> None:
        from tracknetv3_tpu_torch.utils.io import write_pred_csv

        p = self.predictor
        with spans("stage"):
            staged = p.finalize_staged(p.upload_staged(self.pool[offset:offset + n],
                                                       src_wh=self.src_wh, yuv=True))
        with spans("run"):
            pred = p.run_staged(staged)
        del staged
        with spans("post"):
            write_pred_csv(pred, path)

    def warm_up(self) -> None:
        """Every shape the mix's clips use: a full chunk and a last, partial
        one (batch-sized chunks of fixed shape), in one clip of the
        shortest length."""
        t0 = time.perf_counter()
        lengths = clip_lengths(self.cell.traffic["length"])
        self.serve(lengths[0], 0, os.path.join(self.tmp, "warm.csv"), Spans())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s["warm_clip"] = time.perf_counter() - t0

    def free(self) -> None:
        self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def judge(s: Served, clip: Dict, rows: Dict, kept: List, names) -> Dict[str, float]:
    """``rows_off``: the frames of the clip whose row differs from the
    reference's (``reference.serve.rows_off``); ``logit_gap``: the largest
    |kept logit - the reference's logit| over the kept windows that start
    before the clip's last window (infinite where none was kept)."""
    from reference.serve import rows_off
    from reference.tracknet_v1 import clip_rows

    out = {k: (0.0 if k == "rows_off" else float("inf")) for k in names}
    want = {}
    for k, (st, _) in enumerate(kept):
        for j, v in enumerate(st.tolist()):
            if v < s.windows(clip["frames"]):
                want.setdefault(int(v), (k, j))
    if want and "logit_gap" in out:
        out["logit_gap"] = 0.0

    def on_block(st, ref):
        for i, v in enumerate(st.tolist()):
            if v in want:
                k, j = want[v]
                gap = (kept[k][1][j].to(ref.device, torch.float32) - ref[i]).abs().max()
                out["logit_gap"] = max(out["logit_gap"], float(gap))

    yuv = torch.from_numpy(s.pool[clip["offset"]:clip["offset"] + clip["frames"]]).to(s.device)
    ref = clip_rows(yuv, s.model, s.src_wh, s.sd, on_block=on_block if want else None)
    out["rows_off"] = float(rows_off(rows, ref, float(
        s.cell.config["limits"]["serve_clips_v1"]["row_tolerance_px"])))
    return out


def control_got(s: Served, clip: Dict):
    """The rows and the kept logits of the reference in fp8, in the
    program's place, at the windows of the chunks the program's copy would
    keep."""
    from reference.tracknet import FP8
    from reference.tracknet_v1 import clip_rows

    keep = {st for k in clip["chunks"] for st in range(k * s.batch, (k + 1) * s.batch)}
    kept = []

    def on_block(st, out):
        sel = [i for i, v in enumerate(st.tolist()) if v in keep]
        if sel:
            kept.append((st[sel], out[sel]))

    yuv = torch.from_numpy(s.pool[clip["offset"]:clip["offset"] + clip["frames"]]).to(s.device)
    rows = clip_rows(yuv, s.model, s.src_wh, s.sd, quant=FP8, on_block=on_block)
    return rows, kept


def check_names(cell) -> List[str]:
    return [k for k in cell.config["limits"]["serve_clips_v1"] if k != "row_tolerance_px"]


def run(cell, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_start: float) -> RunRecord:
    s = Served(cell, seed, device, tmp)
    on_card = s.device.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True  # as the predict CLI: fixed shapes
    s.warm_up()
    tr = cell.traffic
    skip, n_traced = int(tr["trace"]["skip_clips"]), int(tr["trace"]["clips"])
    prof = None
    if trace and on_card:
        Profiled.warm_up(s.device)
    rec = RunRecord(kind="serve", model=s.model)
    spans = Spans(annotate=trace and on_card, sync=trace and on_card)
    traced_spans = Spans(annotate=True, sync=True)  # the profiled clips': left out of spans
    seq = clip_sequence(tr["length"], int(tr["pool_frames"]), seed)
    picked = {c["index"]: c for c in pick(s, seed)}
    traced = {"frames": 0, "windows": 0, "clips": 0, "host_s": 0.0}
    rec.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last_sampled = max(picked, default=-1)
    i = 0
    while time.perf_counter() < deadline or i <= last_sampled:
        n, off = next(seq)
        if trace and on_card and i == skip:
            prof = Profiled(tmp)
        path = os.path.join(s.csv_dir, f"clip{i:05d}.csv")
        c0 = time.perf_counter()
        rec.attempted += 1
        recorder = Recorder(s.predictor, picked[i]["chunks"]) if i in picked else None
        try:
            if recorder is not None:
                with recorder:
                    s.serve(n, off, path, traced_spans if prof is not None else spans)
            else:
                s.serve(n, off, path, traced_spans if prof is not None else spans)
        except Exception as e:  # noqa: BLE001 - a failed clip is counted and reported
            rec.failed += 1
            rec.notes.setdefault("errors", []).append(f"clip {i}: {type(e).__name__}: {e}")
        else:
            rec.clips.append((n, s.windows(n), time.perf_counter() - c0))
            if recorder is not None:
                picked[i].update(path=path, kept=recorder.windows)
            if prof is not None:
                traced["frames"] += n
                traced["windows"] += s.windows(n)
                traced["clips"] += 1
        if prof is not None and (i == skip + n_traced - 1 or time.perf_counter() >= deadline):
            rec.trace, traced["host_s"] = prof.close()
            prof = None
        i += 1
    rec.window_s = time.perf_counter() - t0
    rec.traced = traced
    rec.spans = dict(spans.seconds)
    if on_card:
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(s.device))

    t_check = time.perf_counter()
    names = check_names(cell)
    done = [c for c in picked.values() if "kept" in c]
    readings = [judge(s, c, read_csv_rows(c["path"]), c.pop("kept"), names) for c in done]
    limits = cell.config["limits"]["serve_clips_v1"]
    rec.checks = [Check(k, v, float(limits[k])) for k, v in worst(readings, names).items()]
    rec.notes["setup_parts_s"] = s.setup_s
    rec.notes["check_s"] = time.perf_counter() - t_check
    rec.notes["checked_frames"] = sum(c["frames"] for c in done)
    rec.notes["checked_clips"] = len(done)
    rec.notes["sampled_clips"] = len(picked)
    s.free()
    return rec


def calibrate(cell, seeds: List[int], device, tmp: str, control: bool = True) -> List[Dict]:
    """Readings for the limits: for each seed, the clips a run would check,
    served by the program with the same copies kept and held to the
    reference; with ``control``, the reference in fp8 in the program's
    place."""
    out = []
    names = check_names(cell)
    for seed in seeds:
        s = Served(cell, seed, device, tmp)
        picked = pick(s, seed)
        program, ctrl = [], []
        for c in picked:
            path = os.path.join(s.csv_dir, f"cal{c['index']}.csv")
            with Recorder(s.predictor, c["chunks"]) as r:
                s.serve(c["frames"], c["offset"], path, Spans())
            program.append(judge(s, c, read_csv_rows(path), r.windows, names))
            del r
            if control:
                rows, kept = control_got(s, c)
                ctrl.append(judge(s, c, rows, kept, names))
                del kept
        row = {"seed": seed, "frames": sum(c["frames"] for c in picked),
               "program": worst(program, names)}
        if control:
            row["control"] = worst(ctrl, names)
        s.free()
        out.append(row)
        del s
        gc.collect()
    return out
