"""Training runner: the README's TrackNet command, step after step, with
its input pipeline running.

Set-up: the split (``write_split``: synthetic rallies in the dataset
layout, written once into the checkout's ``build/`` and kept there, since
its content is fixed), its window index (``data/dataset.build_split_index``),
the loader the mix names (``HeatmapBatchLoader`` on the host, or
``ResidentHeatmapLoader`` with the split on the card), the seeded weights
(made on the device), Adam and the train step of ``training/steps``
(``make_tracknet_shares_train_step`` on a one-entry mesh, as
``training/loop.train`` builds it), fed by ``training/loop.prefetch_to_device``
one epoch after another. Each step's mixup is drawn from
``default_rng([seed, step])`` as the train loop draws it. The first steps
run through the same call and feed as the window's; what they do is
recorded for ``correct`` (each step's loss, the first gradient from Adam's
first moment, each parameter's change), and more steps warm up. The
window then steps until ``seconds`` have passed and synchronises.

``correct``: the reference takes the same windows (by their identity in
the batch), works out their frames, medians and labels from the scene
itself, and runs the same steps plainly in float32 from the same seeded
weights.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from . import scene, weights
from .run_record import Check, RunRecord
from .spec import ROOT
from .trace import Profiled, Spans
from .traffic import mixup_rng, torch_seed

DATA_SEED = 0  # the split's content is fixed: every run reads the same frames


def data_dir(tr: Dict, model: Dict, root: str = ROOT) -> str:
    h, w = int(model["height"]), int(model["width"])
    return os.path.join(root, "build", "port_bench", "train_split",
                        f"r{tr['rallies']}_t{tr['frames_per_rally']}_{h}x{w}")


class Trained:
    """The program's model, optimizer, step and feed for one run."""

    def __init__(self, cell, seed: int, device, data_root: str = ROOT):
        from tracknetv3_tpu_torch.data.dataset import (HeatmapBatchLoader, ResidentHeatmapLoader,
                                                       build_split_index)
        from tracknetv3_tpu_torch.models.tracknet import TrackNet
        from tracknetv3_tpu_torch.parallel.mesh import Mesh
        from tracknetv3_tpu_torch.training.optim import build_optimizer
        from tracknetv3_tpu_torch.training.steps import make_tracknet_shares_train_step

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.setup_s: Dict[str, float] = {}
        t0 = time.perf_counter()
        cfg, tr = cell.config, cell.traffic
        self.model_cfg = m = cfg["model"]
        self.train_cfg = tc = cfg["train"]
        L, bg = int(m["seq_len"]), m["bg_mode"]
        self.h, self.w = int(m["height"]), int(m["width"])
        self.rallies, self.T = int(tr["rallies"]), int(tr["frames_per_rally"])
        self.data_dir = data_dir(tr, m, data_root)
        self.wrote_split = scene.ensure_split(self.data_dir, DATA_SEED, self.rallies, self.T,
                                              self.h, self.w)
        index = build_split_index(self.data_dir, "train", L, 1, "heatmap",
                                  input_hw=(self.h, self.w))
        self.setup_s["split"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.batch = B = int(tc["batch_size"])
        self.alpha = float(tc["alpha"])
        self.sd = weights.tracknet_state(L, bg, torch_seed(seed, 2), self.device)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["compute_dtype"]]
        with torch.device("meta"):
            model = TrackNet(weights.in_channels(L, bg), L, dtype=dtype)
        model.load_state_dict({k: v.clone() for k, v in self.sd.items()}, assign=True)
        if self.device.type == "cuda":
            model = model.to(self.device, memory_format=torch.channels_last)
        self.model = model
        self.param_names = [k for k, _ in model.named_parameters()]
        self.opt, schedule = build_optimizer(tc["optimizer"], model.parameters(),
                                             float(tc["learning_rate"]))
        self.mesh = Mesh((self.device,))
        self.step_fn = make_tracknet_shares_train_step(model, self.opt, bg, self.alpha, schedule,
                                                       mesh=self.mesh)
        loader_seed = int(torch_seed(seed, 6))
        if tr["loader"] == "resident":
            self.loader = ResidentHeatmapLoader(index, bg, B, shuffle=True, drop_last=True,
                                                seed=loader_seed, data_dir=self.data_dir,
                                                device=self.device)
        else:
            self.loader = HeatmapBatchLoader(index, bg, B, shuffle=True, drop_last=True,
                                             seed=loader_seed, data_dir=self.data_dir)
        self.setup_s["model_and_loader"] = time.perf_counter() - t0
        self.step_i = 0
        self.losses: List[torch.Tensor] = []
        self._feed = self._epochs()

    def _epochs(self):
        from tracknetv3_tpu_torch.training.loop import prefetch_to_device

        while True:
            yield from prefetch_to_device(self.loader, self.device, mesh=self.mesh)

    def next_batch(self):
        return next(self._feed)

    def step(self, shares):
        from tracknetv3_tpu_torch.training.steps import sample_mixup_params

        perm = lam = None
        if self.alpha > 0:
            rows = shares[0]["cxcy"].shape[0] * len(shares)
            perm, lam = sample_mixup_params(mixup_rng(self.seed, self.step_i), rows, self.alpha)
        self.losses.append(self.step_fn(shares, self.step_i, perm, lam))
        self.step_i += 1
        return perm, lam

    def close(self) -> None:
        self._feed.close()

    def free(self) -> None:
        self.close()
        self.model = self.opt = self.step_fn = self.loader = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_batch(t: Trained, ids: np.ndarray, perm, lam) -> Dict:
    """The windows ``ids`` (B, L, 2) (rally, frame) worked out from the
    scene: frames, each rally's median (truncated to uint8, as the split
    stores it) and the label centres."""
    from reference.serve import median as ref_median

    frames_of, median_of = {}, {}
    lab = scene.labels(t.T, t.w, t.h)
    B, L = ids.shape[:2]
    frames = np.empty((B, L, t.h, t.w, 3), np.uint8)
    median = np.empty((B, t.h, t.w, 3), np.uint8)
    centers = np.empty((B, L, 2), np.int64)
    for b in range(B):
        r = int(ids[b, 0, 0])
        if r not in frames_of:
            frames_of[r] = scene.rally_frames(DATA_SEED, r, t.T, t.h, t.w)
            on_dev = torch.from_numpy(frames_of[r]).to(t.device)
            median_of[r] = ref_median(on_dev).to(torch.uint8).cpu().numpy()
        pos = ids[b, :, 1]
        frames[b] = frames_of[r][pos]
        median[b] = median_of[r]
        centers[b] = lab[pos][:, 2:4]
    return {"frames": frames, "median": median, "centers": centers,
            "perm": np.asarray(perm, np.int64), "lam": np.asarray(lam, np.float32)}


def first_steps(t: Trained, n: int):
    """Run the first ``n`` steps, recording what the check compares: the
    batches' window identities and mixup, each loss, the first gradient
    (Adam's first moment after step 1 over 1 - beta1, kept as it is and by
    its norm), each leaf's change."""
    p0 = {k: p.detach().clone() for k, p in t.model.named_parameters()}
    batches, grad_norms, grads = [], {}, {}
    beta1 = t.opt.param_groups[0]["betas"][0]
    for i in range(n):
        shares = t.next_batch()
        perm, lam = t.step(shares)
        batches.append((np.asarray(shares[0]["id"]).copy(), perm, lam))
        if i == 0:
            for k, p in t.model.named_parameters():
                m1 = t.opt.state[p].get("exp_avg")  # none where the step never reached Adam
                m1 = torch.zeros_like(p) if m1 is None else m1.detach()
                grads[k] = m1.float() / (1.0 - beta1)
                grad_norms[k] = float(grads[k].norm())
    change = {k: float((p.detach() - p0[k]).norm()) for k, p in t.model.named_parameters()}
    losses = [float(x) for x in t.losses[:n]]
    return batches, {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                     "grads": grads}


def reference_run(t: Trained, batches, quant=None, half_batch: bool = False) -> Dict:
    from reference.train import run_steps

    ref_batches = [reference_batch(t, ids, perm, lam) for ids, perm, lam in batches]
    return run_steps(t.sd, t.param_names, ref_batches, float(t.train_cfg["learning_rate"]),
                     quant=quant, half_batch=half_batch)


def run(cell, seed: int, seconds: float, trace: bool, device, tmp: str, t_start: float,
        data_root: str = ROOT) -> RunRecord:
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # as the train CLI: fixed shapes
    t = Trained(cell, seed, device, data_root)
    tr = cell.traffic
    on_card = t.device.type == "cuda"
    t0 = time.perf_counter()
    batches, prog = first_steps(t, int(tr["check_steps"]))
    while t.step_i < int(tr["warmup_steps"]):
        t.step(t.next_batch())
    if on_card:
        torch.cuda.synchronize(t.device)
    t.setup_s["first_and_warm_steps"] = time.perf_counter() - t0
    if trace and on_card:
        Profiled.warm_up(t.device)
    if on_card:
        torch.cuda.synchronize(t.device)
    rec = RunRecord(kind="train", model=t.model_cfg, batch=t.batch)
    rec.notes["split_written"] = t.wrote_split
    rec.notes["setup_parts_s"] = t.setup_s
    spans = Spans(annotate=trace and on_card)
    traced_spans = Spans(annotate=True)  # the profiled steps': left out of spans
    skip, n_traced = int(tr["trace"]["skip_steps"]), int(tr["trace"]["steps"])
    prof = None
    traced = {"steps": 0, "host_s": 0.0}
    first_window_step = t.step_i
    rec.setup_s = time.perf_counter() - t_start
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        k = t.step_i - first_window_step
        if trace and on_card and k == skip:
            prof = Profiled(tmp)
        sp = traced_spans if prof is not None else spans
        with sp("input"):
            shares = t.next_batch()
        with sp("step"):
            t.step(shares)
        if prof is not None:
            traced["steps"] += 1
            if k == skip + n_traced - 1 or time.perf_counter() >= deadline:
                rec.trace, traced["host_s"] = prof.close()
                prof = None
    if on_card:
        torch.cuda.synchronize(t.device)
    rec.window_s = time.perf_counter() - t0
    # the process's CPU seconds in the window, every thread's: a host-bound
    # run shows here how many cores it kept busy
    rec.notes["cpu_s_in_window"] = time.process_time() - cpu0
    rec.traced = traced
    rec.steps = t.step_i - first_window_step
    rec.attempted = t.step_i
    rec.failed = int((~torch.isfinite(torch.stack(t.losses))).sum())
    rec.spans = dict(spans.seconds)
    if on_card:
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(t.device))
    t.free()

    t_check = time.perf_counter()
    ref = reference_run(t, batches)
    from reference.train import gaps

    nums = gaps(prog, ref)
    rec.notes["check_s"] = time.perf_counter() - t_check
    limits = cell.config["limits"]["train_steps"]
    rec.checks = [Check(k, nums[k], float(limits[k])) for k in limits]
    rec.notes["gaps"] = {k: v for k, v in nums.items()
                         if k not in limits and not k.endswith("_leaves")}
    return rec


def calibrate(cell, seeds: List[int], device, tmp: str, control: bool = True,
              data_root: str = ROOT) -> List[Dict]:
    """Readings for the limits, per seed: the program's first steps against
    the reference; with ``control``, the reference in fp8 and the
    reference over half of each batch (both in the program's place)
    against the reference. ``tmp`` is not used: the split is written
    under ``data_root``."""
    from reference.tracknet import FP8
    from reference.train import gaps

    out = []
    n = int(cell.traffic["check_steps"])
    for seed in seeds:
        t = Trained(cell, seed, device, data_root)
        batches, prog = first_steps(t, n)
        t.free()
        ref = reference_run(t, batches)
        row = {"seed": seed, "program": gaps(prog, ref)}
        if control:
            row["control"] = gaps(reference_run(t, batches, quant=FP8), ref)
            row["half_batch"] = gaps(reference_run(t, batches, half_batch=True), ref)
        out.append(row)
        del t
        gc.collect()
    return out
