"""Training loop of TrackNet and InpaintNet: epochs, validation, checkpoints,
resume.

Port of the JAX package's ``training/loop.py::train`` on one device: the
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
(``ResidentHeatmapLoader``; frame mixup, or a split over the loader's
budget, falls back to the host loader).

InpaintNet (``model_name="InpaintNet"``) trains on the coordinate-mode index
of the ``predicted_csv`` files (``CoordinateBatchLoader``) in float32 with
TF32 off, Adam with its gradients clipped to a global norm of 1.0, and a
Bernoulli(``mask_ratio``) mask drawn on the host per step from
``(seed, step)``; it validates with ``eval_inpaintnet`` and keeps the best
'inpaint' accuracy. The TrackNet input options (segments, frame mixup,
resident frames, sample mixup) do not apply to it and are ignored, as in
the JAX loop.
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
from .checkpoint import (
    load_checkpoint,
    load_optimizer_jax_leaves,
    optimizer_to_jax_leaves,
    save_checkpoint,
)
from .optim import build_optimizer
from .steps import (
    make_inpaintnet_eval_step,
    make_inpaintnet_train_step,
    make_tracknet_eval_step,
    make_tracknet_train_step,
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
    """Raise ``NotImplementedError`` for options this slice does not port."""
    unsupported = {
        "num_devices > 1": (cfg.num_devices or 1) > 1,
        "fast_bn": bool(cfg.fast_bn),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported to PyTorch yet: {', '.join(bad)}")


def _pinned(batch: Dict[str, np.ndarray], pin: bool, keys) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(batch)
    for k in keys:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(loader: Iterable, device: torch.device, depth: int = 2,
                       keys=_DEVICE_KEYS) -> Iterator[Dict]:
    """Yield the loader's batches with the ``keys`` they hold on ``device``
    (TrackNet's by default).

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
                                                     verbose_print)
        keys = _DEVICE_KEYS
    else:
        train_loader = CoordinateBatchLoader(train_index, cfg.batch_size, shuffle=True,
                                             drop_last=True, seed=cfg.seed)
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
        train_step = make_tracknet_train_step(model, optimizer, cfg.bg_mode, cfg.alpha, schedule)
        eval_step = make_tracknet_eval_step(model, cfg.bg_mode)
    else:
        train_step = make_inpaintnet_train_step(model, optimizer, schedule)
        eval_step = make_inpaintnet_eval_step(model)

    # ----- epochs -----
    history = []
    t_train = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        verbose_print(f"Epoch [{epoch + 1} / {cfg.epochs}]")
        t0 = time.time()
        losses = []
        for batch in prefetch_to_device(train_loader, dev, keys=keys):
            # one host draw per step, seeded by (seed, step): resume replays
            # the same mixup or mask as an uninterrupted run
            rng = np.random.default_rng([cfg.seed, step])
            if not tracknet:
                mask = sample_inpaint_mask(rng, tuple(batch["vis"].shape), cfg.mask_ratio)
                losses.append(train_step(batch, step, torch.from_numpy(mask).to(dev)))
            else:
                perm = lam = None
                if cfg.alpha > 0:
                    p, l = sample_mixup_params(rng, batch["cxcy"].shape[0], cfg.alpha)
                    perm = torch.from_numpy(p).to(dev)
                    lam = torch.from_numpy(l).to(dev)
                losses.append(train_step(batch, step, perm, lam))
            step += 1
        train_loss = float(torch.stack(losses).mean()) if losses else 0.0

        val_batches = prefetch_to_device(val_loader, dev, keys=keys)
        if tracknet:
            val_loss, val_res = eval_tracknet(eval_step, val_batches, cfg.tolerance,
                                              exact_decode=cfg.exact_decode)
            cur_val_acc = val_res["accuracy"]
        else:
            val_loss, val_res = eval_inpaintnet(eval_step, val_batches, cfg.tolerance,
                                                input_hw=val_index.input_hw)
            cur_val_acc = val_res["inpaint"]["accuracy"]
        common = dict(
            epoch=epoch,
            model=model,
            opt_leaves=optimizer_to_jax_leaves(
                optimizer, model, cfg.optim, step, scheduled=cfg.lr_scheduler != ""
            ),
            scheduler=dict(lr_scheduler=cfg.lr_scheduler, opt_step=step),
            param_dict=param_dict,
        )
        if cur_val_acc >= max_val_acc:
            max_val_acc = cur_val_acc
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

    verbose_print(f"Training time: {(time.time() - t_train) / 3600.0:.2f} hrs")
    return dict(history=history, max_val_acc=max_val_acc, model=model, step=step)


def _tracknet_loaders(cfg: TrainConfig, train_index, val_index, data_dir: str,
                      dev: torch.device, verbose_print):
    """TrackNet's train and val loaders: resident frames where asked and
    possible, else the host loader (segments, frame mixup)."""
    train_loader = val_loader = None
    if cfg.resident_frames and cfg.frame_alpha <= 0:
        try:
            train_loader = ResidentHeatmapLoader(
                train_index, cfg.bg_mode, cfg.batch_size, shuffle=True, drop_last=True,
                seed=cfg.seed, data_dir=data_dir, device=dev,
            )
            val_loader = ResidentHeatmapLoader(
                val_index, cfg.bg_mode, cfg.batch_size, data_dir=data_dir, device=dev
            )
            verbose_print("Resident frames: split staged to device memory")
        except MemoryError as e:
            verbose_print(f"resident_frames fallback: {e}")
            train_loader = val_loader = None
    if cfg.resident_frames and cfg.frame_alpha > 0:
        verbose_print("resident_frames fallback: frame mixup plans its blends on the host loader")
    if train_loader is None:
        train_loader = HeatmapBatchLoader(
            train_index, cfg.bg_mode, cfg.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, data_dir=data_dir, frame_alpha=cfg.frame_alpha,
            segment_windows=cfg.segment_windows,
        )
    if val_loader is None:
        val_loader = HeatmapBatchLoader(val_index, cfg.bg_mode, cfg.batch_size,
                                        data_dir=data_dir)
    return train_loader, val_loader
