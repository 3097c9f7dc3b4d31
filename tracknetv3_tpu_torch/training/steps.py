"""TrackNet and InpaintNet train and eval steps.

Port of the JAX package's ``training/steps.py``. TrackNet: batch assembly
(window expansion of segmented batches, the gather of device-resident
frames, frame-mixup blending, channel stacking, /255), sample mixup,
forward, loss, backward and the optimizer update. PyTorch runs eagerly, so
a step is a function that updates the model and optimizer in place and
returns the loss as a device scalar (no host sync).

The gathers of the assembly are the copy kernels of ``ops/shift_copy.py``
(``window_copy``, ``repeat_rows``) on a CUDA batch and their plain versions
on a CPU batch. They run on the uint8 frames and the cast to float32
follows (the JAX step casts first; the values are the same).

Mixup randomness is explicit: ``sample_mixup_params`` draws the per-sample
``lam ~ Beta(alpha, alpha)`` (then ``max(lam, 1 - lam)``) and the
permutation from a ``numpy.random.Generator`` on the host, once per step,
and the B values travel with the batch. Tests hand the same ``perm``/``lam``
to both packages.

On the card the loss is the hand-written kernel pair ``wbce_disk_loss``
with ``pack_mixup_targets`` (``pack_plain_targets`` when ``alpha <= 0``,
``pack_frame_mixup_targets`` on a frame-mixup batch): the (B, H, W, L) label
tensor never exists. On the CPU the same call runs the plain composition.
Frame mixup together with sample mixup needs four disks per label, which
the kernels' two-disk form does not hold: that step materialises the
labels and takes ``wbce_from_logits``, as the JAX step does.

InpaintNet: the train step masks a Bernoulli(``mask_ratio``) share of the
visible frames (``inpaint_mask = (vis > 0) * mask``), feeds the prediction
with those frames zeroed and takes ``masked_mse`` against the ground truth on
them; the eval step composites the network's output into the masked frames,
takes the same loss and zeroes the points under ``COOR_TH``. The mask is
drawn on the host (``sample_inpaint_mask``), as the mixup parameters are:
``jax.random.bernoulli``'s stream has no torch counterpart, so the tests
hand one mask to both packages. Both steps run with TF32 off.

The train steps are data parallel (``make_tracknet_shares_train_step``,
``make_inpaintnet_shares_train_step``): a step over W shares of a global
batch, the entries of a one-process ``Mesh`` or one share on each rank of a
process group, computes the single step on the global batch, as the JAX
step does under GSPMD: each share assembles its own input with the copy
kernels on its entry, every BatchNorm takes the global batch's statistics
(``TrackNet.forward_shares``), the loss is the mean of the shares' means
(the shares are equal), and the shares' gradients are summed before the
optimizer step (autograd through ``parallel.mesh.entry_params`` on a mesh;
one all-reduce of every gradient and the loss over a process group), so
InpaintNet's global-norm clip sees the global gradient. The step's random
draws are the global batch's (``perm`` / ``lam``, the mask); sample
mixup's partner rows may lie on other shares, so each share takes them
from the global batch's inputs and labels: the shares' concatenated on a
mesh, all-gathered over a group. Resident frames sharded over the
holders (``frame_sharding="shard"``: a batch with ``res_shards``) reach each
share through the exchange of ``parallel/mesh.py`` before the assembly: the
holders' ``window_copy`` gathers, the copy between entries on a mesh or one
all-to-all over a group, the receiver's reorder; the uint8 frames a share
assembles are those of the replicated buffers, bit for bit. The eval step
takes a sharded batch's frames to its one device the same way.
``make_tracknet_train_step`` and
``make_inpaintnet_train_step`` are the same steps over one share on the
model's device, where nothing is gathered or reduced and every BatchNorm
is the unsplit op.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import COOR_TH
from ..device import tf32_off
from ..ops.heatmap import make_heatmaps
from ..ops.losses import masked_mse, wbce, wbce_from_logits
from ..ops.preprocess import window_channels
from ..ops.shift_copy import repeat_rows, window_copy
from ..ops.wbce_disk import (
    pack_frame_mixup_targets,
    pack_mixup_targets,
    pack_plain_targets,
    wbce_disk_loss,
)
from ..parallel.mesh import Mesh, entry_params, mesh_exchange, mesh_reducer
from ..parallel.processes import DeviceGroup

Batch = Dict[str, torch.Tensor]


def _take_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[idx]`` for an index tensor of any shape: idx.shape + buf.shape[1:]."""
    out = window_copy(buf, idx.reshape(-1).contiguous(), 1)
    return out.reshape(tuple(idx.shape) + tuple(buf.shape[1:]))


def _expand_segments(segs: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(n_seg, seg + L - 1, h, w, c) unique frames -> the (n_seg * seg, L, h,
    w, c) overlapping windows, segment-major. The table of window starts is
    built from this batch's own shape (the tail batch has fewer segments)."""
    n_seg, span = segs.shape[:2]
    seg = span - seq_len + 1
    dev = segs.device
    starts = (torch.arange(n_seg, device=dev)[:, None] * span
              + torch.arange(seg, device=dev)[None, :]).reshape(-1)
    return window_copy(segs.reshape((n_seg * span,) + tuple(segs.shape[2:])), starts, seq_len)


def _blend_slots(frames: torch.Tensor, pair: torch.Tensor, pix_w: torch.Tensor) -> torch.Tensor:
    """Frame-mixup pixel blending: frames (B, L, h, w, c), pair (B, L, 2)
    indices (ja, jb) into a window's frames; out[b, l] = w * frames[b, ja]
    + (1 - w) * frames[b, jb] in float32."""
    B, L = frames.shape[:2]
    flat = frames.reshape((B * L,) + tuple(frames.shape[2:]))
    rows = torch.arange(B, device=frames.device)[:, None] * L + pair.long().movedim(-1, 0)
    fa = _take_rows(flat, rows[0]).to(torch.float32)
    fb = _take_rows(flat, rows[1]).to(torch.float32)
    w = pix_w.to(torch.float32)[..., None, None, None]
    return fa * w + fb * (1.0 - w)


_FRAME_BUFFERS = (("res_rgb_buf", "rgb"), ("res_diff_buf", "diff"))


def _on(buf, device: torch.device) -> torch.Tensor:
    """A resident buffer on ``device``: the tensor, or of a mesh's tuple of
    replicated buffers the one there."""
    if isinstance(buf, (tuple, list)):
        return next(b for b in buf if b.device == device)
    return buf


def assemble_tracknet_inputs(batch: Batch, bg_mode: str) -> torch.Tensor:
    """Model input x (B, H, W, C) float32 in [0, 1] from a device batch:
    a plain one (``rgb`` / ``diff`` / ``median``), a segmented one
    (``seg_rgb`` / ``seg_diff``), one of device-resident frames (``res_idx``;
    replicated buffers, or frames sharded over a mesh's entries, which
    ``res_shards`` brings to ``res_idx``'s device) or a frame-mixup one
    (``mix_pair``)."""
    rgb, diff, median = (batch.get(k) for k in ("rgb", "diff", "median"))

    if "res_idx" in batch:
        # the batch carries (B, L) flat frame indices into the split's buffers
        idx = batch["res_idx"]
        frames = {}
        for key, name in _FRAME_BUFFERS:
            if key not in batch:
                continue
            if "res_shards" in batch:
                (got,) = mesh_exchange(batch[key], batch["res_shards"].exchange(1), [idx.device])
                frames[name] = got.reshape(tuple(idx.shape) + tuple(got.shape[1:]))
            else:
                frames[name] = _take_rows(_on(batch[key], idx.device), idx)
        rgb, diff = frames.get("rgb", rgb), frames.get("diff", diff)
        if "res_median_buf" in batch:
            median = _take_rows(_on(batch["res_median_buf"], idx.device),
                                batch["res_median_idx"])

    if "seg_rgb" in batch or "seg_diff" in batch:
        L = batch["cxcy"].shape[1]
        segs = batch["seg_rgb"] if "seg_rgb" in batch else batch["seg_diff"]
        if "seg_rgb" in batch:
            rgb = _expand_segments(batch["seg_rgb"], L)
        if "seg_diff" in batch:
            diff = _expand_segments(batch["seg_diff"], L)
        if median is not None:
            median = repeat_rows(median, segs.shape[1] - L + 1)

    if "mix_pair" in batch:
        # the blend gathers its two operands from the uint8 frames and casts them
        pair, pix_w = batch["mix_pair"], batch["mix_pix_w"]
        if rgb is not None:
            rgb = _blend_slots(rgb, pair, pix_w)
        if diff is not None:
            diff = _blend_slots(diff, pair, pix_w)

    rgb, diff, median = (None if t is None else t.float() for t in (rgb, diff, median))
    return window_channels(rgb, diff, median, bg_mode)


def assemble_tracknet_labels(batch: Batch, h: int, w: int) -> torch.Tensor:
    """Materialised label heatmaps y (B, h, w, L): the eval path, and the
    train step with both mixups."""
    if "mix_pair" in batch:
        return frame_mixup_labels(batch["mix_centers"], batch["mix_hm_w"], h, w)
    cxcy = batch["cxcy"]
    return make_heatmaps(cxcy[..., 0], cxcy[..., 1], h, w).movedim(1, -1)  # (B, h, w, L)


def frame_mixup_labels(centers: torch.Tensor, hm_w: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A frame-mixup batch's label heatmaps (B, h, w, L) from its blend plan
    (``mix_centers`` (B, L, 2, 2), ``mix_hm_w`` (B, L))."""
    hm_w = hm_w.to(torch.float32)[..., None, None]
    map_a = make_heatmaps(centers[..., 0, 0], centers[..., 0, 1], h, w)
    map_b = make_heatmaps(centers[..., 1, 0], centers[..., 1, 1], h, w)
    return (map_a * hm_w + map_b * (1.0 - hm_w)).movedim(1, -1)


def sample_mixup_params(
    rng: np.random.Generator, batch_size: int, alpha: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample ``lam = max(l, 1 - l)``, ``l ~ Beta(alpha, alpha)`` (float32)
    and a permutation of the batch (int64), drawn on the host."""
    lam = rng.beta(alpha, alpha, size=batch_size)
    lam = np.maximum(lam, 1.0 - lam).astype(np.float32)
    return rng.permutation(batch_size).astype(np.int64), lam


def sample_mixup_inputs(x: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor,
                        partners: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x * lam + x[perm] * (1 - lam)`` per sample; ``partners`` stands for
    ``x[perm]`` where the partner rows lie outside ``x`` (a share)."""
    lx = lam.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return x * lx + (x[perm] if partners is None else partners) * (1.0 - lx)


def _to_model_input(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W); a contiguous x makes this a
    channels_last tensor, the layout cuDNN prefers."""
    return x.permute(0, 3, 1, 2)


def _model_mesh(model: torch.nn.Module) -> Mesh:
    """A mesh of one entry, the device of ``model``'s parameters."""
    return Mesh((next(model.parameters()).device,))


def make_tracknet_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    bg_mode: str,
    alpha: float,
    schedule: Optional[Callable[[int], float]] = None,
):
    """Returns ``step(batch, step_idx, perm=None, lam=None) -> loss``, the
    step on the model's device (``make_tracknet_shares_train_step`` over one
    share).

    ``batch`` holds device tensors (the keys ``assemble_tracknet_inputs``
    reads, and ``cxcy``); with ``alpha > 0`` the caller passes the step's
    ``perm``/``lam`` from ``sample_mixup_params`` (arrays or tensors).
    ``step_idx`` is the optimizer step (from 0) that ``schedule`` reads.
    """
    step = make_tracknet_shares_train_step(model, optimizer, bg_mode, alpha, schedule,
                                           mesh=_model_mesh(model))
    return lambda batch, step_idx, perm=None, lam=None: step([batch], step_idx, perm, lam)


class _Shares:
    """What a data-parallel step needs of its topology: this process's
    mesh entries and, under a process group, the group."""

    def __init__(self, mesh: Mesh, group: Optional[DeviceGroup]):
        if group is not None and mesh.size != 1:
            raise ValueError(f"under a process group each process holds one share, not "
                             f"{mesh.size}")
        self.mesh, self.group = mesh, group
        self.size = mesh.size * (group.size if group is not None else 1)
        self.reducer = group.reducer() if group is not None else mesh_reducer(mesh)

    def rows(self, b: int) -> List[slice]:
        """Global batch rows of this process's shares of ``b`` rows each."""
        first = (self.group.rank if self.group is not None else 0) * self.mesh.size * b
        return [slice(first + i * b, first + (i + 1) * b) for i in range(self.mesh.size)]

    def gather(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The global batch of the shares' ``ts``, on each share's device."""
        if self.group is not None:
            return [self.group.all_gather(ts[0])]
        if len(ts) == 1:
            return list(ts)
        first = torch.cat([t.to(self.mesh.devices[0]) for t in ts])
        return [first.to(dev) for dev in self.mesh.devices]

    def frames(self, shares: Sequence[Batch]) -> Sequence[Batch]:
        """The shares of a batch of sharded resident frames (``res_shards``)
        with each share's windows' frames exchanged into ``rgb`` / ``diff``
        (B_i, L, H, W, C) on its device, in place of the shards; any other
        batch's shares as they are."""
        if "res_shards" not in shares[0]:
            return shares
        fs = shares[0]["res_shards"]
        if fs.holders != self.size:
            raise ValueError(f"frames sharded over {fs.holders} holders reach {self.size} shares")
        ex = fs.exchange(self.size)
        out = [{k: v for k, v in b.items() if k != "res_shards"} for b in shares]
        for key, name in _FRAME_BUFFERS:
            if key not in shares[0]:
                continue
            if self.group is not None:
                got = [self.group.exchange(shares[0][key], ex)]
            else:
                got = mesh_exchange([b[key] for b in shares], ex, self.mesh.devices)
            for b, g in zip(out, got):
                del b[key]
                b[name] = g.reshape(tuple(b["res_idx"].shape) + tuple(g.shape[1:]))
        return out

    def params(self, model: torch.nn.Module) -> List[Dict[str, torch.Tensor]]:
        return entry_params(model, self.mesh)

    def backward(self, model: torch.nn.Module, losses: Sequence[torch.Tensor]) -> torch.Tensor:
        """Backward of the global loss, the mean of the shares' ``losses``
        (on a mesh autograd sums the entries' gradients; over a group one
        all-reduce sums every gradient and the loss); returns it detached."""
        first = self.mesh.devices[0]
        loss = sum(l.to(first) for l in losses) / len(losses)
        if self.group is None:
            loss.backward()
            return loss.detach()
        (loss / self.group.size).backward()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1).to(params[0].dtype)])
        self.group.all_reduce_(flat)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
        return (flat[-1] / self.group.size).to(loss.dtype)


def _host_rows(t, rows: slice, device) -> torch.Tensor:
    """Rows of a global draw (an array or a tensor) on ``device``."""
    return torch.as_tensor(t[rows]).to(device)


def make_tracknet_shares_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    bg_mode: str,
    alpha: float,
    schedule: Optional[Callable[[int], float]] = None,
    *,
    mesh: Mesh,
    group: Optional[DeviceGroup] = None,
):
    """The TrackNet train step over shares: returns ``step(shares, step_idx,
    perm=None, lam=None) -> loss``. ``shares`` holds one batch per
    entry of ``mesh`` on its device (``parallel.mesh.shard_train_batch``);
    under a process group (``group``, from ``parallel.processes.device_group``)
    ``mesh`` is this process's one entry and the other shares are the other
    ranks'. ``perm`` / ``lam`` are the global batch's
    (``sample_mixup_params`` at the global batch size; arrays or tensors). The
    model and its optimizer live on the mesh's first entry. Returns the
    global batch's loss on that entry, the same on every rank."""
    sh = _Shares(mesh, group)

    def step(shares: Sequence[Batch], step_idx: int, perm=None, lam=None) -> torch.Tensor:
        model.train()
        frame_mix = "mix_pair" in shares[0]
        xs = [assemble_tracknet_inputs(b, bg_mode) for b in sh.frames(shares)]
        rows = sh.rows(xs[0].shape[0])
        perms = lams = None
        if alpha > 0:
            perms = [_host_rows(perm, r, x.device) for r, x in zip(rows, xs)]
            lams = [_host_rows(lam, r, x.device) for r, x in zip(rows, xs)]
            xs = [sample_mixup_inputs(x, p, lm, every[p])
                  for x, every, p, lm in zip(xs, sh.gather(xs), perms, lams)]
        labels = targets = None
        if frame_mix and alpha > 0:
            h, w = xs[0].shape[1:3]
            every = {k: sh.gather([b[k] for b in shares]) for k in ("mix_centers", "mix_hm_w")}
            labels = []
            for i, (b, p, lm) in enumerate(zip(shares, perms, lams)):
                own = assemble_tracknet_labels(b, h, w)
                partner = frame_mixup_labels(every["mix_centers"][i][p],
                                             every["mix_hm_w"][i][p], h, w)
                ly = lm.to(own.dtype).reshape((own.shape[0],) + (1,) * (own.dim() - 1))
                labels.append(own * ly + partner * (1.0 - ly))
        elif frame_mix:
            targets = [pack_frame_mixup_targets(b["mix_centers"], b["mix_hm_w"]) for b in shares]
        elif alpha > 0:
            every = sh.gather([b["cxcy"] for b in shares])
            targets = [pack_mixup_targets(b["cxcy"], p, lm, e[p])
                       for b, e, p, lm in zip(shares, every, perms, lams)]
        else:
            targets = [pack_plain_targets(b["cxcy"]) for b in shares]
        if schedule is not None:
            for g in optimizer.param_groups:
                g["lr"] = schedule(step_idx)
        optimizer.zero_grad(set_to_none=True)
        logits = model.forward_shares([_to_model_input(x) for x in xs], sh.params(model),
                                      sh.reducer)
        logits = [z.movedim(1, -1) for z in logits]  # (b, H, W, L)
        if labels is not None:
            losses = [wbce_from_logits(z, y) for z, y in zip(logits, labels)]
        else:
            losses = [wbce_disk_loss(z, *t) for z, t in zip(logits, targets)]
        loss = sh.backward(model, losses)
        optimizer.step()
        return loss

    return step


def make_tracknet_eval_step(model: torch.nn.Module, bg_mode: str):
    """Returns ``step(batch) -> (loss, probs (B, H, W, L))``: running-stat
    BatchNorm, WBCE on probabilities against materialised labels."""

    @torch.no_grad()
    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        x = assemble_tracknet_inputs(batch, bg_mode)
        y = assemble_tracknet_labels(batch, x.shape[1], x.shape[2])
        probs = torch.sigmoid(model(_to_model_input(x))).movedim(1, -1)
        return wbce(probs, y), probs

    return step


def sample_inpaint_mask(rng: np.random.Generator, shape: Tuple[int, ...],
                        mask_ratio: float) -> np.ndarray:
    """Bernoulli(``mask_ratio``) draws of ``shape`` as float32 0 / 1, on the host."""
    return (rng.random(shape) < mask_ratio).astype(np.float32)


def make_inpaintnet_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Optional[Callable[[int], float]] = None,
):
    """Returns ``step(batch, step_idx, mask) -> loss``, the step on the
    model's device (``make_inpaintnet_shares_train_step`` over one share):
    ``batch`` holds the device tensors ``coor_pred``, ``coor`` and ``vis``
    (B, L, 1) of a ``CoordinateBatchLoader`` batch, ``mask`` the step's
    Bernoulli draws of ``vis``'s shape (``sample_inpaint_mask``);
    ``step_idx`` is the optimizer step (from 0) that ``schedule`` reads.
    The optimizer clips (built with ``clip_norm=1.0``)."""
    step = make_inpaintnet_shares_train_step(model, optimizer, schedule,
                                             mesh=_model_mesh(model))
    return lambda batch, step_idx, mask: step([batch], step_idx, mask)


def make_inpaintnet_eval_step(model: torch.nn.Module):
    """Returns ``step(batch) -> (loss, coor_inpaint (B, L, 2))``: the network
    on the prediction and its ``inpaint_mask``, its output composited into
    the masked frames, ``masked_mse`` against ``coor``, then every point with
    both coordinates under ``COOR_TH`` set to (0, 0)."""

    @torch.no_grad()
    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        coor_pred, coor_gt, m = batch["coor_pred"], batch["coor"], batch["inpaint_mask"]
        with tf32_off():
            out = model(coor_pred, m)
        coor_inpaint = out * m + coor_pred * (1.0 - m)
        loss = masked_mse(coor_inpaint, coor_gt, m)
        th = (coor_inpaint[..., 0] < COOR_TH) & (coor_inpaint[..., 1] < COOR_TH)
        coor_inpaint = coor_inpaint.masked_fill(th[..., None], 0.0)
        return loss, coor_inpaint

    return step


def make_inpaintnet_shares_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Optional[Callable[[int], float]] = None,
    *,
    mesh: Mesh,
    group: Optional[DeviceGroup] = None,
):
    """The InpaintNet train step over shares: returns ``step(shares,
    step_idx, mask) -> loss`` with ``shares`` and ``mesh`` / ``group`` as in
    ``make_tracknet_shares_train_step`` and ``mask`` the global batch's
    Bernoulli draws (an array or a tensor), of which each share takes its
    rows: ``inpaint_mask = (vis > 0) * mask``, the prediction with those
    frames zeroed, ``masked_mse`` on them. The optimizer's clip runs on the
    summed gradient."""
    sh = _Shares(mesh, group)

    def step(shares: Sequence[Batch], step_idx: int, mask) -> torch.Tensor:
        model.train()
        rows = sh.rows(shares[0]["vis"].shape[0])
        if schedule is not None:
            for g in optimizer.param_groups:
                g["lr"] = schedule(step_idx)
        optimizer.zero_grad(set_to_none=True)
        with tf32_off():
            losses = []
            for b, r, p in zip(shares, rows, sh.params(model)):
                coor_pred, coor_gt, vis = b["coor_pred"], b["coor"], b["vis"]
                inpaint_mask = (vis > 0).to(coor_pred.dtype) * _host_rows(mask, r, vis.device)
                coor_in = coor_pred * (1.0 - inpaint_mask)
                out = torch.func.functional_call(model, p, (coor_in, inpaint_mask))
                losses.append(masked_mse(out, coor_gt, inpaint_mask))
            loss = sh.backward(model, losses)
        optimizer.step()
        return loss

    return step
