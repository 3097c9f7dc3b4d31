"""Training loop of TrackNet and InpaintNet: epochs, validation, checkpoints,
resume.

Port of the JAX package's ``training/loop.py::train``: the
train split at stride 1 (shuffled, full batches), the val
split at stride ``seq_len``, validation after every epoch,
``{model}_best.pt`` (best val accuracy) and ``{model}_cur.pt`` each epoch,
and ``resume_training`` from ``{model}_cur.pt`` with the ``param_dict``
override contract (the checkpoint's config replaces the caller's, except
``epochs``, ``verbose`` and the resume flag).

Batches are assembled on the host by a background thread into pinned
buffers and copied to the card with ``non_blocking`` copies, so the copy
of the next batch overlaps the current step. ``segment_windows`` > 1 ships
each segment's unique frames once and ``frame_alpha`` > 0 the frame-mixup
blend plan (``HeatmapBatchLoader``); ``resident_frames`` puts the train and
val splits' frames on the device once and ships indices
(``ResidentHeatmapLoader``; frame mixup, or a train split over the loader's
budget on one device, falls back to the host loader). On a mesh or over
processes the train split is placed as the JAX loop places it,
``frame_sharding="auto"``: replicated on every card within the budget, else
sharded over them (each card 1/N of the frames, the windows' rows exchanged
in the step); on a mesh the val split too, whose batches the eval step
gathers on the first entry. Over processes each rank validates on its own
device, so there the val split stays whole and goes to the host loader
above the budget.

Observability is the JAX loop's: ``write_to_tb`` logs the losses and the
val metrics after each epoch to ``save_dir/logs`` (``scalars.jsonl``,
appended to on resume, and TensorBoard events where TensorBoard imports),
and every ``display_step``-th train step (100, 4 with ``debug``)
``visualize_step`` runs the eval step on that batch and writes
``cur_pred.gif`` (TrackNet) or ``cur_traj.png`` (InpaintNet) into
``save_dir``, drawn on a background thread (``SampleWriter``) while
training goes on; ``train`` returns once the last one is written. Unlike
the JAX loop, which catches every exception there, an error of the eval
step (or of the drawing) propagates; only a missing plotting library, or a
resident batch (frame indices, no frames to draw), skips the sample with a
``(viz skipped: ...)`` line.

InpaintNet (``model_name="InpaintNet"``) trains on the coordinate-mode index
of the ``predicted_csv`` files (``CoordinateBatchLoader``) in float32 with
TF32 off, Adam with its gradients clipped to a global norm of 1.0, and a
Bernoulli(``mask_ratio``) mask drawn on the host per step from
``(seed, step)``; it validates with ``eval_inpaintnet`` and keeps the best
'inpaint' accuracy. The TrackNet input options (segments, frame mixup,
resident frames, sample mixup) do not apply to it and are ignored, as in
the JAX loop.

Data parallel, as the JAX loop: ``num_devices`` > 1 trains on a
one-process ``Mesh`` of that many cards (CPU entries with ``device="cpu"``),
and under a caller's ``torch.distributed`` group of more than one process
(``train --multihost``: ``parallel.processes.init_from_env``) each process
trains one share on its device; ``num_devices`` must then be unset or the
process count. One device is a mesh of one entry. Every step is the single
step on the global batch (``training/steps.make_*_shares_train_step``),
each batch a list of this process's shares: the loaders hand each
process its rows of the global batch (``process_id`` / ``process_count``),
the mixup parameters and InpaintNet's mask are drawn for the global batch,
and the logged ``train_loss`` is the global mean on every rank. On a mesh
validation runs on the first entry (eval mode takes no batch statistics);
over processes each rank evaluates its share of the val batches and the
metrics are merged (``evaluation/loops.py``). Rank 0 alone writes
checkpoints and progress samples, and logs to ``logs``; rank r > 0 logs to
``logs_p{r}``. Resume reads the checkpoint on every rank.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..config import TrainConfig
from ..data.dataset import (
    CoordinateBatchLoader,
    HeatmapBatchLoader,
    ResidentHeatmapLoader,
    build_split_index,
)
from ..device import resolve_device
from ..evaluation.loops import eval_inpaintnet, eval_tracknet
from ..models.factory import get_model
from ..models.convert import inpaintnet_from_jax, tracknet_from_jax
from ..parallel.mesh import Mesh, canonical_device, make_mesh, shard_train_batch
from ..parallel.processes import device_group, process_count_index
from ..utils.visualize import ScalarLogger, write_to_tb
from .checkpoint import (
    load_checkpoint,
    load_optimizer_jax_leaves,
    optimizer_to_jax_leaves,
    save_checkpoint,
)
from .optim import build_optimizer
from .steps import (
    assemble_tracknet_labels,
    make_inpaintnet_eval_step,
    make_inpaintnet_shares_train_step,
    make_tracknet_eval_step,
    make_tracknet_shares_train_step,
    sample_inpaint_mask,
    sample_mixup_params,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# batch keys that the device needs; ``id`` stays on the host for eval, and a
# resident loader's ``res_*_buf`` are device tensors already
_DEVICE_KEYS = ("rgb", "diff", "median", "cxcy", "seg_rgb", "seg_diff", "mix_pair",
                "mix_pix_w", "mix_centers", "mix_hm_w", "res_idx", "res_median_idx")
# an InpaintNet batch's keys that the device needs (``coor`` and
# ``coor_pred`` also go back to the host for the eval's confusions)
_COORDINATE_KEYS = ("coor", "coor_pred", "vis", "inpaint_mask")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for the option the port does not have,
    ``fast_bn``, and ``ValueError`` where a process group of more than one
    process meets a ``num_devices`` other than its process count (the JAX
    loop's rule: several processes train over every device, one a process)."""
    if cfg.fast_bn:
        raise NotImplementedError("not ported to PyTorch yet: fast_bn")
    processes = process_count_index()[0]
    if processes > 1 and cfg.num_devices not in (None, processes):
        raise ValueError(
            f"a process group of {processes} processes trains on {processes} devices, one a "
            f"process; num_devices {cfg.num_devices} is not supported (drop it or set it "
            f"to {processes})")


def _pinned(batch: Dict[str, np.ndarray], pin: bool, keys) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(batch)
    for k in keys:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(loader: Iterable, device: torch.device, depth: int = 2,
                       keys=_DEVICE_KEYS, mesh: Optional[Mesh] = None) -> Iterator:
    """Yield the loader's batches with the ``keys`` they hold on ``device``
    (TrackNet's by default), or, given a ``mesh``, each batch as the list of
    its shares on the mesh's entries (``shard_train_batch``).

    A thread assembles and pins the next ``depth`` batches; the consumer
    issues ``non_blocking`` host-to-device copies on the current stream.
    """
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def producer():
        try:
            for batch in loader:
                if stop.is_set():
                    return
                q.put(_pinned(batch, pin, keys))
        except BaseException as e:  # re-raised in the consumer
            q.put(e)
        finally:
            q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            if mesh is not None:
                yield shard_train_batch(item, mesh)
            else:
                yield {k: (v.to(device, non_blocking=True) if k in keys else v)
                       for k, v in item.items()}
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class SampleWriter:
    """Draws the progress samples on a background thread, one at a time: a
    288x512 GIF's colour quantisation takes seconds of host time, for which
    the card would otherwise wait every ``display_step`` steps. ``wait``
    joins the drawing in flight and re-raises its error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, draw) -> None:
        self.wait()

        def run():
            try:
                draw()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="progress-sample", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error


def visualize_step(model_name: str, eval_step, batch: Dict, save_dir: str,
                   verbose_print=print, writer: Optional[SampleWriter] = None) -> None:
    """Training-progress sample of one train batch (reference:
    train.py:103-119, 172-175; the JAX loop's ``visualize_step``): the eval
    step on ``batch`` and, for its first sample, the 4-panel heatmap GIF
    ``cur_pred.gif`` (TrackNet: the window's frames from ``rgb``,
    ``seg_rgb``, ``seg_diff`` or ``diff``, the label maps and the
    probabilities) or the trajectory plot ``cur_traj.png`` (InpaintNet),
    drawn by ``writer`` if given, else here. An error of the eval step
    propagates; a missing plotting library or a resident batch skips the
    sample with a ``(viz skipped: ...)`` line."""
    import importlib

    from ..utils import visualize

    if model_name == "TrackNet":
        if "res_idx" in batch:
            verbose_print("  (viz skipped: a resident batch holds frame indices, not frames)")
            return
        _, probs = eval_step(batch)
        h, w, L = probs.shape[1:]
        first = {k: batch[k][:1] for k in ("cxcy", "mix_pair", "mix_centers", "mix_hm_w")
                 if k in batch}
        probs0 = np.moveaxis(_host(probs[0]), -1, 0)  # (L, H, W)
        y0 = np.moveaxis(_host(assemble_tracknet_labels(first, h, w)[0]), -1, 0)
        key = next(k for k in ("rgb", "seg_rgb", "seg_diff", "diff") if k in batch)
        frames0 = batch[key][0].cpu().numpy()
        frames0 = frames0[:L] if key.startswith("seg_") else frames0
        frames0 = frames0.astype(np.float32) / 255.0
        if key in ("seg_diff", "diff"):
            frames0 = np.repeat(frames0, 3, -1)
        plot = lambda: visualize.plot_heatmap_pred_sample(  # noqa: E731
            frames0, y0, probs0, save_dir=save_dir)
    else:
        _, coor = eval_step(batch)
        coor_gt, coor0, mask = (_host(t[0]) for t in (batch["coor"], coor,
                                                       batch["inpaint_mask"]))
        plot = lambda: visualize.plot_traj_pred_sample(  # noqa: E731
            coor_gt, coor0, mask, save_dir=save_dir)
    try:  # the library the plot draws with
        importlib.import_module("PIL" if model_name == "TrackNet" else "matplotlib")
    except ImportError as e:
        verbose_print(f"  (viz skipped: {e})")
        return
    if writer is None:
        plot()
    else:
        writer.submit(plot)


def train(
    config: TrainConfig,
    data_dir: str = "data",
    device: Optional[Union[str, torch.device]] = None,
    verbose_print=print,
) -> Dict[str, Any]:
    """Train TrackNet or InpaintNet; returns ``dict(history, max_val_acc,
    model, step)``."""
    cfg = config
    dev = resolve_device(device)
    os.makedirs(cfg.save_dir, exist_ok=True)

    ckpt = None
    cur_path = os.path.join(cfg.save_dir, f"{cfg.model_name}_cur.pt")
    if cfg.resume_training:
        if not os.path.exists(cur_path):
            raise FileNotFoundError(f"No checkpoint found in {cfg.save_dir}")
        ckpt = load_checkpoint(cur_path)
        restored = TrainConfig.from_param_dict(ckpt["param_dict"])
        restored.resume_training = True
        restored.epochs = cfg.epochs
        restored.verbose = cfg.verbose
        cfg = restored
    check_supported(cfg)
    param_dict = cfg.to_param_dict()
    verbose_print(f"Parameters: {param_dict}")
    tracknet = cfg.model_name == "TrackNet"

    # ----- data parallel: a one-process mesh, or one share a process -----
    processes, rank = process_count_index()
    mesh = group = None  # ``mesh``: one of several entries in this process
    if processes > 1:
        group = device_group(dev)
    elif (cfg.num_devices or 1) > 1:
        mesh = make_mesh(cfg.num_devices, device=dev.type)
        dev = mesh.devices[0]
        if cfg.batch_size % mesh.size:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by mesh size "
                             f"{mesh.size}")
    step_mesh = mesh if mesh is not None else Mesh((canonical_device(dev),))
    shares = step_mesh.size * processes

    # ----- data -----
    data_mode = "heatmap" if tracknet else "coordinate"
    train_index = build_split_index(
        data_dir, "train", cfg.seq_len, 1, data_mode, debug=cfg.debug, input_hw=cfg.input_hw
    )
    val_index = build_split_index(
        data_dir, "val", cfg.seq_len, cfg.seq_len, data_mode, debug=cfg.debug,
        input_hw=cfg.input_hw,
    )
    if tracknet:
        train_loader, val_loader = _tracknet_loaders(cfg, train_index, val_index, data_dir, dev,
                                                     verbose_print, mesh, rank, processes)
        keys = _DEVICE_KEYS
    else:
        train_loader = CoordinateBatchLoader(train_index, cfg.batch_size, shuffle=True,
                                             drop_last=True, seed=cfg.seed, process_id=rank,
                                             process_count=processes)
        val_loader = CoordinateBatchLoader(val_index, cfg.batch_size)
        keys = _COORDINATE_KEYS
    steps_per_epoch = max(len(train_loader), 1)
    verbose_print(f"Dataset: {len(train_index)} train / {len(val_index)} val windows")

    # ----- model + optimizer -----
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.model_name, cfg.seq_len, cfg.bg_mode, generator=gen,
                      dtype=_DTYPES[cfg.compute_dtype])
    step = 0
    start_epoch, max_val_acc = 0, 0.0
    if ckpt is not None:
        from_jax = tracknet_from_jax if tracknet else inpaintnet_from_jax
        model.load_state_dict(from_jax(ckpt["model"]))
        step = int((ckpt.get("scheduler") or {}).get("opt_step", 0))
        start_epoch = ckpt["epoch"] + 1
        max_val_acc = ckpt["max_val_acc"]
    if dev.type == "cuda" and tracknet:
        model = model.to(dev, memory_format=torch.channels_last)
    else:
        model = model.to(dev)
    optimizer, schedule = build_optimizer(
        cfg.optim, model.parameters(), cfg.learning_rate, cfg.lr_scheduler,
        cfg.epochs, steps_per_epoch, clip_norm=None if tracknet else 1.0,
    )
    if ckpt is not None:
        if ckpt.get("optimizer") is not None:
            load_optimizer_jax_leaves(optimizer, model, cfg.optim, ckpt["optimizer"], step)
        verbose_print(f"Resume training from epoch {start_epoch}...")

    if tracknet:
        train_step = make_tracknet_shares_train_step(
            model, optimizer, cfg.bg_mode, cfg.alpha, schedule, mesh=step_mesh, group=group)
        eval_step = make_tracknet_eval_step(model, cfg.bg_mode)
    else:
        train_step = make_inpaintnet_shares_train_step(model, optimizer, schedule,
                                                       mesh=step_mesh, group=group)
        eval_step = make_inpaintnet_eval_step(model)
    # the validation loops' share of the val batches under a process group
    val_kw = dict(process_id=rank, process_count=processes) if group is not None else {}

    display_step = 4 if cfg.debug else 100  # reference: train.py:213
    samples = SampleWriter()

    # ----- epochs -----
    logger = ScalarLogger(os.path.join(cfg.save_dir, "logs" if rank == 0 else f"logs_p{rank}"))
    try:
        history = []
        t_train = time.time()
        for epoch in range(start_epoch, cfg.epochs):
            verbose_print(f"Epoch [{epoch + 1} / {cfg.epochs}]")
            t0 = time.time()
            losses = []
            for step_i, batch in enumerate(prefetch_to_device(train_loader, dev, keys=keys,
                                                              mesh=step_mesh)):
                # one host draw per step for the global batch, seeded by (seed,
                # step): resume replays the same mixup or mask as an
                # uninterrupted run, and every share takes its rows of it
                rng = np.random.default_rng([cfg.seed, step])
                first = batch[0]
                rows = first["cxcy" if tracknet else "vis"].shape[0] * shares
                if not tracknet:
                    mask = sample_inpaint_mask(rng, (rows,) + tuple(first["vis"].shape[1:]),
                                               cfg.mask_ratio)
                    losses.append(train_step(batch, step, mask))
                else:
                    perm = lam = None
                    if cfg.alpha > 0:
                        perm, lam = sample_mixup_params(rng, rows, cfg.alpha)
                    losses.append(train_step(batch, step, perm, lam))
                step += 1
                if (step_i + 1) % display_step == 0 and rank == 0:
                    visualize_step(cfg.model_name, eval_step, first, cfg.save_dir, verbose_print,
                                   samples)
            train_loss = float(torch.stack(losses).mean()) if losses else 0.0

            val_batches = prefetch_to_device(val_loader, dev, keys=keys)
            if tracknet:
                val_loss, val_res = eval_tracknet(eval_step, val_batches, cfg.tolerance,
                                                  exact_decode=cfg.exact_decode, **val_kw)
                cur_val_acc = val_res["accuracy"]
            else:
                val_loss, val_res = eval_inpaintnet(eval_step, val_batches, cfg.tolerance,
                                                    input_hw=val_index.input_hw, **val_kw)
                cur_val_acc = val_res["inpaint"]["accuracy"]
            write_to_tb(cfg.model_name, logger, (train_loss, val_loss), val_res, epoch)
            best = cur_val_acc >= max_val_acc
            if best:
                max_val_acc = cur_val_acc
            if rank == 0:  # one writer over processes, as in the JAX loop
                common = dict(
                    epoch=epoch,
                    model=model,
                    opt_leaves=optimizer_to_jax_leaves(
                        optimizer, model, cfg.optim, step, scheduled=cfg.lr_scheduler != ""
                    ),
                    scheduler=dict(lr_scheduler=cfg.lr_scheduler, opt_step=step),
                    param_dict=param_dict,
                )
                if best:
                    save_checkpoint(
                        os.path.join(cfg.save_dir, f"{cfg.model_name}_best.pt"),
                        max_val_acc=max_val_acc, **common,
                    )
                save_checkpoint(cur_path, max_val_acc=max_val_acc, **common)
            verbose_print(
                f"  train_loss={train_loss:.6f} val_loss={val_loss:.6f} "
                f"val_acc={cur_val_acc:.4f} ({time.time() - t0:.1f}s)"
            )
            history.append(dict(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                                val_res=val_res))

        samples.wait()
    finally:
        logger.close()
    verbose_print(f"Training time: {(time.time() - t_train) / 3600.0:.2f} hrs")
    return dict(history=history, max_val_acc=max_val_acc, model=model, step=step)


def _tracknet_loaders(cfg: TrainConfig, train_index, val_index, data_dir: str,
                      dev: torch.device, verbose_print, mesh: Optional[Mesh] = None,
                      process_id: int = 0, process_count: int = 1):
    """TrackNet's train and val loaders: resident frames where asked and
    possible, else the host loader (segments, frame mixup). The train
    loader gives this process its rows of each global batch (on a ``mesh``
    or over processes replicated or sharded, as ``frame_sharding="auto"``
    resolves); the val loader full batches, on ``dev`` or placed on the
    ``mesh`` alike."""
    train_loader = val_loader = None
    if cfg.resident_frames and cfg.frame_alpha <= 0:
        try:
            train_loader = ResidentHeatmapLoader(
                train_index, cfg.bg_mode, cfg.batch_size, shuffle=True, drop_last=True,
                seed=cfg.seed, data_dir=data_dir, mesh=mesh, process_id=process_id,
                process_count=process_count, device=dev,
            )
        except MemoryError as e:
            verbose_print(f"resident_frames fallback: {e}")
        if train_loader is not None:
            try:
                val_loader = ResidentHeatmapLoader(
                    val_index, cfg.bg_mode, cfg.batch_size, data_dir=data_dir, mesh=mesh,
                    device=dev)
            except MemoryError as e:
                if process_count == 1:  # on one device or a mesh both go to the host
                    verbose_print(f"resident_frames fallback: {e}")
                    train_loader = None
                else:
                    verbose_print(f"resident_frames: the val split stays on the host: {e}")
        if train_loader is not None:
            holders = mesh.size if mesh is not None else process_count
            verbose_print("Resident frames: split staged to device memory" + (
                f" ({train_loader.frame_sharding} over {holders} devices)"
                if holders > 1 else ""))
    if cfg.resident_frames and cfg.frame_alpha > 0:
        verbose_print("resident_frames fallback: frame mixup plans its blends on the host loader")
    if train_loader is None:
        train_loader = HeatmapBatchLoader(
            train_index, cfg.bg_mode, cfg.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, data_dir=data_dir, frame_alpha=cfg.frame_alpha,
            segment_windows=cfg.segment_windows, process_id=process_id,
            process_count=process_count,
        )
    if val_loader is None:
        val_loader = HeatmapBatchLoader(val_index, cfg.bg_mode, cfg.batch_size,
                                        data_dir=data_dir)
    return train_loader, val_loader
