"""Serving runner: one client sends rally clips, one after another.

Each clip takes the path that ``inference.predict_video`` takes after
decode: ``upload_staged`` (planar YUV420 at model resolution, as the
native reader hands it over) -> ``finalize_staged`` (YUV420 -> RGB, the
median) -> ``run_staged`` -> ``inpaint_trajectory`` (with an InpaintNet)
-> ``utils.io.write_pred_csv`` into the run's temporary directory. Decode
is left out: the card's machine has no libav and no cv2.

Set-up: the seeded weights (made on the device) written as the
predictor's checkpoints, the predictor, the pool of YUV420 frames (drawn
and converted on the device, held on the host), and one warm-up clip plus
an InpaintNet pass for every window bucket the mix's lengths reach. The
window then serves clips until ``seconds`` have passed and the sampled
clips (below) are served, whichever comes later; the clip running at the
close finishes and counts. (A window of the cells' length serves the first
cycle in its first third.)

``correct``: before the window a sample of the mix's first cycle is drawn
from the seed (its longest clip and others). While the window serves those
clips, ``Recorder`` keeps a copy of what the program computes in its own
calls: the window probabilities of a seeded sample of chunks
(``TrackNetPredictor._windows``), every ensembled frame map
(``inference.ensemble_update_fn`` and ``ensemble_flush``) and InpaintNet's
inputs and outputs (a forward hook). Once the window has closed, each
sampled clip's CSV rows and those copies are held to the plain reference
(``judge``).
"""

from __future__ import annotations

import csv
import gc
import os
import time
from typing import Dict, List, Set

import numpy as np
import torch

from . import scene, weights
from .run_record import Check, RunRecord
from .trace import Profiled, Spans
from .traffic import clip_lengths, clip_sequence, sub_seed, torch_seed


class Served:
    """The program under test and the inputs of one run."""

    def __init__(self, cell, seed: int, device, tmp: str):
        from tracknetv3_tpu_torch.inference import TrackNetPredictor

        self.cell, self.seed, self.device, self.tmp = cell, seed, torch.device(device), tmp
        self.setup_s: Dict[str, float] = {}
        t0 = time.perf_counter()
        cfg, tr = cell.config, cell.traffic
        self.model = cfg["model"]
        L, bg = int(self.model["seq_len"]), self.model["bg_mode"]
        self.h, self.w = int(self.model["height"]), int(self.model["width"])
        self.eval_mode = cfg["serve"]["eval_mode"]
        self.batch = int(tr["batch_size"])
        self.src_wh = tuple(tr["source_wh"])
        self.sd = weights.tracknet_state(L, bg, torch_seed(seed, 2), self.device)
        weights.set_detector(self.sd, L, bg, cfg["detector"])
        tn, inp = weights.checkpoint_paths(tmp)
        weights.write_tracknet_checkpoint(tn, self.sd, L, bg)
        self.inpaint_sd = None
        self.inpaint_len = int(cfg.get("inpaintnet", {}).get("seq_len", 16))
        if "inpaintnet" in cfg:
            self.inpaint_sd = weights.inpaint_state(torch_seed(seed, 3), self.device)
            weights.write_inpaint_checkpoint(inp, self.inpaint_sd, self.inpaint_len)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.model["compute_dtype"]]
        self.predictor = TrackNetPredictor(
            tn, inp if self.inpaint_sd is not None else None, eval_mode=self.eval_mode,
            batch_size=self.batch, compute_dtype=dtype, input_hw=(self.h, self.w),
            device=self.device, conv_backend=self.model.get("conv_backend"))
        self.setup_s["weights_and_predictor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pool = scene.yuv_pool(torch_seed(seed, 4), int(tr["pool_frames"]), self.h, self.w,
                                   self.device)
        self.csv_dir = os.path.join(tmp, "csv")
        os.makedirs(self.csv_dir, exist_ok=True)
        self.setup_s["pool"] = time.perf_counter() - t0

    def windows(self, n: int) -> int:
        """Windows of an n-frame clip the forward needs."""
        L = int(self.model["seq_len"])
        return -(-n // L) if self.eval_mode == "nonoverlap" else max(n - L + 1, 1)

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
            if p.inpaintnet is not None:
                pred = p.inpaint_trajectory(pred, self.src_wh)
            write_pred_csv(pred, path)

    def warm_up(self) -> None:
        """Every shape the mix's clips use: one clip of the shortest length
        and an InpaintNet pass for each window bucket (multiples of 64)
        that the lengths reach."""
        t0 = time.perf_counter()
        lengths = clip_lengths(self.cell.traffic["length"])
        self.serve(lengths[0], 0, os.path.join(self.tmp, "warm.csv"), Spans())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s["warm_clip"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.predictor.inpaintnet is not None:
            for bucket in sorted({-(-n // 64) * 64 for n in lengths}):
                traj = {"Frame": list(range(bucket)), "X": [640] * bucket, "Y": [360] * bucket,
                        "Visibility": [1] * bucket}
                self.predictor.inpaint_trajectory(traj, self.src_wh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s["warm_inpaint"] = time.perf_counter() - t0

    def free(self) -> None:
        self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def read_csv_rows(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="", encoding="utf8") as f:
        rows = list(csv.DictReader(f))
    return {k: np.asarray([int(r[k]) for r in rows], np.int64) for k in ("Visibility", "X", "Y")}


def sample(clips: List[Dict], seed: int, n: int, max_frames: int) -> List[Dict]:
    """The longest clip and up to ``n - 1`` others drawn from the seed
    while their frames stay within ``max_frames``."""
    if not clips:
        return []
    longest = max(range(len(clips)), key=lambda i: (clips[i]["frames"], -i))
    picked, total = [clips[longest]], clips[longest]["frames"]
    rng = np.random.default_rng(sub_seed(seed, 5))
    for i in rng.permutation(len(clips)):
        if len(picked) >= n:
            break
        if i != longest and total + clips[i]["frames"] <= max_frames:
            picked.append(clips[i])
            total += clips[i]["frames"]
    return picked


def first_cycle(cell, seed: int) -> List[Dict]:
    """The clips of the mix's first cycle (every length once), by their
    index in the run's sequence; a run serves them first."""
    tr = cell.traffic
    seq = clip_sequence(tr["length"], int(tr["pool_frames"]), seed)
    return [{"index": i, "frames": n, "offset": off}
            for i, (n, off) in zip(range(len(clip_lengths(tr["length"]))), seq)]


def pick(s: "Served", seed: int) -> List[Dict]:
    """The sampled clips, each with the chunks whose window probabilities
    are kept (``chunks``): every clip's first and last, the rest drawn from
    the seed up to the mix's ``check.window_chunks`` in all."""
    chk = s.cell.traffic["check"]
    picked = sample(first_cycle(s.cell, seed), seed, int(chk["clips"]), int(chk["max_frames"]))
    budget = int(chk["window_chunks"])
    rest = []
    for c in picked:
        n = s.chunks(c["frames"])
        c["chunks"] = {0, n - 1}
        rest += [(c["index"], k) for k in range(1, n - 1)]
    budget -= sum(len(c["chunks"]) for c in picked)
    rng = np.random.default_rng(sub_seed(seed, 6))
    by_index = {c["index"]: c for c in picked}
    for j in rng.permutation(len(rest))[:max(budget, 0)]:
        i, k = rest[j]
        by_index[i]["chunks"].add(k)
    return picked


class Recorder:
    """A copy of what the program computes for one clip, taken from its own
    calls while it serves the clip: the (starts, probabilities) of each of
    ``TrackNetPredictor._windows``'s calls whose ordinal is in ``chunks``;
    each frame map that ``inference.ensemble_update_fn`` finalises and
    ``inference.ensemble_flush`` gives, by frame; InpaintNet's inputs and
    output, from a forward hook. Copies stay on the device; nothing waits
    for the device."""

    def __init__(self, predictor, chunks: Set[int]):
        self.p, self.chunks = predictor, chunks
        self.windows: List = []
        self.frames: List = []
        self.net: List = []

    def __enter__(self) -> "Recorder":
        import tracknetv3_tpu_torch.inference as inference

        p, windows, calls = self.p, self.p._windows, [0]

        def recorded_windows(pre, buf, med, starts, params=None):
            out = windows(pre, buf, med, starts, params)
            if calls[0] in self.chunks:
                self.windows.append((starts.clone(), out.clone()))
            calls[0] += 1
            return out

        update, flush = inference.ensemble_update_fn, inference.ensemble_flush

        def recorded_update(state, wins, weights, n_valid):
            first = int(state.next_frame)
            new, frames = update(state, wins, weights, n_valid)
            self.frames.append((first, frames[:int(n_valid)].clone()))
            return new, frames

        def recorded_flush(state):
            out = flush(state)
            self.frames.append((int(state.next_frame), out.clone()))
            return out

        self._undo = [lambda: delattr(p, "_windows"),
                      lambda: setattr(inference, "ensemble_update_fn", update),
                      lambda: setattr(inference, "ensemble_flush", flush)]
        p._windows = recorded_windows
        inference.ensemble_update_fn, inference.ensemble_flush = recorded_update, recorded_flush
        if p.inpaintnet is not None:
            hook = p.inpaintnet.register_forward_hook(
                lambda mod, args, out: self.net.append(
                    (args[0].clone(), args[1].clone(), out.clone())))
            self._undo.append(hook.remove)
        return self

    def __exit__(self, *exc) -> None:
        for undo in self._undo:
            undo()

    def got(self, T: int) -> Dict:
        """``windows``: (starts, (n, L, h, w) probabilities) or None;
        ``frames``: (T, h, w) frame maps, None where a frame is missing;
        ``net``: [(coords, mask, output)]."""
        wins = None
        if self.windows:
            wins = (torch.cat([st for st, _ in self.windows]),
                    torch.cat([pr for _, pr in self.windows]).float())
        frames = None
        if self.frames:
            h, w = self.frames[0][1].shape[-2:]
            frames = torch.empty((T, h, w), dtype=torch.float32, device=self.frames[0][1].device)
            seen = np.zeros(T, bool)
            for first, block in self.frames:
                n = max(min(block.shape[0], T - first), 0)
                frames[first:first + n] = block[:n]
                seen[first:first + n] = True
            frames = frames if seen.all() else None
        return {"windows": wins, "frames": frames, "net": self.net}


def judge(s: "Served", clip: Dict, rows: Dict[str, np.ndarray], got: Dict,
          names) -> Dict[str, float]:
    """The numbers ``names`` of one clip: ``rows_off``, the frames whose
    row differs from the reference's (``reference.serve.rows_off``);
    ``prob_gap``, the largest gap of a kept window probability;
    ``frame_gap``, of an ensembled frame map; ``inpaint_gap``, of an
    InpaintNet output against the reference's network on the same inputs
    (TF32 off). A number with nothing to compare reads infinite."""
    from reference.serve import clip_rows, rows_off
    from reference.tracknet import inpaintnet, plain_math

    out = {k: (0.0 if k == "rows_off" else float("inf")) for k in names}
    # real windows start before S (``weight``) or before T (``nonoverlap``)
    limit = clip["frames"] if s.eval_mode == "nonoverlap" else s.windows(clip["frames"])
    want: Dict[int, int] = {}
    if got["windows"] is not None:
        for j, st in enumerate(got["windows"][0].tolist()):
            if st < limit:
                want.setdefault(int(st), j)
    if want and "prob_gap" in out:
        out["prob_gap"] = 0.0

    def on_block(st, p_ref):
        pairs = [(i, want[v]) for i, v in enumerate(st.tolist()) if v in want]
        if pairs:
            ri, gi = (torch.as_tensor(x, device=p_ref.device) for x in zip(*pairs))
            gap = (got["windows"][1][gi].to(p_ref.device) - p_ref[ri]).abs().max()
            out["prob_gap"] = max(out["prob_gap"], float(gap))

    def on_frames(probs):
        if got["frames"] is not None and "frame_gap" in out:
            out["frame_gap"] = float((got["frames"].to(probs.device) - probs).abs().max())

    yuv = torch.from_numpy(s.pool[clip["offset"]:clip["offset"] + clip["frames"]]).to(s.device)
    ref = clip_rows(yuv, s.model, s.eval_mode, s.src_wh, s.sd, s.inpaint_sd, s.inpaint_len,
                    on_block=on_block if want else None, on_frames=on_frames)
    out["rows_off"] = float(rows_off(rows, ref, float(
        s.cell.config["limits"]["serve_clips"]["row_tolerance_px"])))
    if "inpaint_gap" in out and got["net"]:
        gap = 0.0
        for cw, mw, o in got["net"]:
            with plain_math(), torch.no_grad():
                gap = max(gap, float((o - inpaintnet(s.inpaint_sd, cw, mw)).abs().max()))
        out["inpaint_gap"] = gap
    return out


def control_got(s: "Served", clip: Dict):
    """The rows and the ``Recorder.got`` of the reference in fp8 (TrackNet)
    and TF32 (InpaintNet): the control, in the program's place, with the
    windows of the chunks the program's copy would keep."""
    from reference.serve import clip_rows
    from reference.tracknet import FP8

    B, L = s.batch, int(s.model["seq_len"])
    step = L if s.eval_mode == "nonoverlap" else 1
    keep = {st * step for k in clip["chunks"] for st in range(k * B, (k + 1) * B)}
    starts, probs, frames, net = [], [], [], []

    def on_block(st, p):
        sel = [i for i, v in enumerate(st.tolist()) if v in keep]
        if sel:
            starts.append(st[sel])
            probs.append(p[sel])

    yuv = torch.from_numpy(s.pool[clip["offset"]:clip["offset"] + clip["frames"]]).to(s.device)
    rows = clip_rows(yuv, s.model, s.eval_mode, s.src_wh, s.sd, s.inpaint_sd, s.inpaint_len,
                     quant=FP8, inpaint_tf32=True, on_block=on_block,
                     on_frames=lambda f: frames.append(f) if s.eval_mode != "nonoverlap" else None,
                     on_net=lambda cw, mw, o: net.append((cw, mw, o)))
    got = {"windows": (torch.cat(starts), torch.cat(probs)) if starts else None,
           "frames": frames[0] if frames else None, "net": net}
    return rows, got


def check_names(cell) -> List[str]:
    return [k for k in cell.config["limits"]["serve_clips"] if k != "row_tolerance_px"]


def worst(readings: List[Dict[str, float]], names) -> Dict[str, float]:
    """Each number's worst over the clips: rows_off summed, gaps the
    largest; infinite where no clip was compared."""
    if not readings:
        return {k: float("inf") for k in names}
    return {k: (sum(r[k] for r in readings) if k == "rows_off" else max(r[k] for r in readings))
            for k in names}


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
    clips: List[Dict] = []
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
            latency = time.perf_counter() - c0
            clips.append({"frames": n, "offset": off, "path": path})
            rec.clips.append((n, s.windows(n), latency))
            if recorder is not None:
                picked[i].update(path=path, recorder=recorder)
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
    done = [c for c in picked.values() if "recorder" in c]
    readings = [judge(s, c, read_csv_rows(c["path"]), c.pop("recorder").got(c["frames"]), names)
                for c in done]
    limits = cell.config["limits"]["serve_clips"]
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
    reference; with ``control``, the reference in fp8 (InpaintNet in TF32)
    in the program's place."""
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
            program.append(judge(s, c, read_csv_rows(path), r.got(c["frames"]), names))
            if control:
                rows, got = control_got(s, c)
                ctrl.append(judge(s, c, rows, got, names))
        row = {"seed": seed, "frames": sum(c["frames"] for c in picked),
               "program": worst(program, names)}
        if control:
            row["control"] = worst(ctrl, names)
        s.free()
        out.append(row)
        del s
        gc.collect()
    return out
