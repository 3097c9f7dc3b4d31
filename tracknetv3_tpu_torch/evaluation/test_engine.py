"""Rally evaluation: the ``test`` CLI's engine (the JAX package's
``evaluation/test_engine.py``).

Every rally of a split goes through TrackNet (heatmap mode) or, given an
InpaintNet, through InpaintNet over the rally's ``predicted_csv`` trajectory
(coordinate mode), in ``nonoverlap`` or temporal-ensemble (``weight`` /
``average``) eval mode. Each frame is classified into the 5-way confusion;
``get_test_res`` sums it over rallies, with the drop-frame window of the
test split. ``test(save_inpaint_mask=True)`` writes each rally's
``predicted_csv`` file: InpaintNet's training data.

The TrackNet path per rally:

1. stage: the rally's uint8 frames at model resolution (``FrameCache``) go
   to the card once, padded with L-1 repeats of the last frame (so every
   window's frames exist), and the float32 median beside them;
2. per chunk of ``batch_size`` windows: the window gather by the
   ``window_copy`` kernel on the uint8 buffer (``ops/shift_copy.py``, its
   plain version on the CPU; window starts past the last real window are
   clamped and checked on the host before they go to the card),
   ``window_channels``, the folded-BN TrackNet forward, the carried-tail
   ensemble, and the decode into packed ``[cx, cy, vis, conf, bbox]`` rows
   kept on the card;
3. one fetch of the rally's rows.

With a ``mesh`` (``parallel/mesh.py``) every entry keeps a copy of the
staged rally on its device, each chunk's window starts are split into the
mesh's equal shares, each entry gathers (``window_copy``) and forwards its
share, and the shares come back in window order to the mesh's first device
(the engine's) for the ensemble and the decode.

Under an initialised ``torch.distributed`` group of more than one process,
``test`` takes the rallies ``rally_dirs[rank::world_size]``, then merges the
per-rally prediction dicts of every process (``_merge_pred_dicts``: JSON
bytes, all-gathered over a gloo group on the host) into the split's order,
so that every process holds the whole dict, as in the JAX package.

``exact_decode`` picks the decode: False, the serving decoder
(``decode_heatmaps``, the peak blob); True (or ``"device"``), the
largest-bbox-area rule on the card (``decode_heatmaps_exact``) inside the
chunk loop; ``"host"``, the same rule on the host
(``decode_heatmaps_host``) over the ensembled heatmaps, fetched once a
rally. The JAX package's TPU workarounds (length buckets, power-of-two
padding, compiled-program caches) are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import HEIGHT, PRED_TYPES, PRED_TYPES_MAP, WIDTH
from ..data.dataset import FrameCache, build_rally_coordinate_index
from ..device import resolve_device, tf32_off
from ..inference import zero_below_th
from ..models.fused_forward import fold_batchnorm, fused_params, tracknet_fused_forward
from ..ops.detect import decode_heatmaps, decode_heatmaps_exact, decode_heatmaps_host
from ..ops.ensemble import (
    ensemble_chunk,
    ensemble_flush,
    ensemble_init,
    ensemble_update_fn,
    get_ensemble_weight,
)
from ..ops.postprocess import generate_inpaint_mask, linear_interp
from ..ops.preprocess import window_channels
from ..ops.shift_copy import check_starts, window_copy
from ..parallel.mesh import (check_mesh, device_context, gather_batch, replicate_tree,
                             split_batch)
from ..parallel.processes import host_group, process_count_index
from ..utils.io import (
    get_rally_dirs,
    label_csv_path,
    parse_rally_dir,
    png_size,
    read_csv_columns,
    write_pred_csv,
)
from .metrics import classify_detections, gt_center_from_label, metrics_dict


class StagedRally(NamedTuple):
    """A rally's frames on the device: T real frames, then L-1 repeats of
    the last."""

    rgb: Optional[torch.Tensor]  # (T + L - 1, h, w, 3) uint8 (the rgb modes)
    diff: Optional[torch.Tensor]  # (T + L - 1, h, w, 1) uint8 (the subtract modes)
    median: Optional[torch.Tensor]  # (h, w, 3) float32 (concat)
    T: int
    replicas: Tuple["StagedRally", ...] = ()  # with a mesh: a copy on each entry's device

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self[:3] if x is not None)


def _label_columns(rally_dir: str, *columns: str) -> Dict[str, np.ndarray]:
    match_dir, rally_id = parse_rally_dir(rally_dir)
    return read_csv_columns(label_csv_path(match_dir, rally_id), ("Frame",) + columns)


def _frame_size(rally_dir: str) -> Tuple[int, int]:
    return png_size(os.path.join(rally_dir, "0.png"))


def _rally_key(rally_dir: str) -> str:
    match_dir, rally_id = parse_rally_dir(rally_dir)
    return f"{match_dir.split('match')[-1]}_{rally_id}"


class RallyTestEngine:
    """Evaluates rallies with a TrackNet and optionally an InpaintNet.

    ``tracknet`` is the port's ``TrackNet`` (or its state dict, or the JAX
    package's variable tree: anything ``fold_batchnorm`` takes), or None;
    ``inpaintnet`` the port's ``InpaintNet`` or None. ``device`` defaults to
    the card and raises without one; pass ``"cpu"`` for the plain versions
    of the kernels. ``compute_dtype`` (bfloat16 by default) and
    ``conv_backend`` are ``TrackNetPredictor``'s. ``num_workers`` is
    accepted for the CLI's sake and unused. ``mesh``, a
    ``parallel.mesh.Mesh`` whose size divides ``batch_size`` and whose first
    device is ``device``, shards each chunk's windows over its entries.
    """

    def __init__(
        self,
        tracknet,
        inpaintnet=None,
        *,
        tracknet_seq_len: int = 8,
        inpaintnet_seq_len: int = 16,
        bg_mode: str = "",
        eval_mode: str = "weight",
        batch_size: int = 16,
        tolerance: float = 4.0,
        num_workers: int = 0,
        mesh=None,
        exact_decode: Union[bool, str] = False,
        input_hw: Optional[Tuple[int, int]] = None,
        device: Optional[Union[str, torch.device]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        conv_backend: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            check_mesh(mesh, int(batch_size), self.device, "engine")
        self.mesh = mesh
        if eval_mode not in ("nonoverlap", "average", "weight"):
            raise ValueError(f"Invalid eval_mode: {eval_mode!r}")
        self.seq_len = int(tracknet_seq_len)
        self.inpaint_seq_len = int(inpaintnet_seq_len)
        self.bg_mode = bg_mode
        self.h, self.w = (int(input_hw[0]), int(input_hw[1])) if input_hw else (HEIGHT, WIDTH)
        self.eval_mode = eval_mode
        self.batch_size = int(batch_size)
        self.tolerance = tolerance
        # True / "device": the largest-bbox-area rule on the card; "host": on the host
        self.exact_decode = exact_decode
        self._decode = (decode_heatmaps_exact if exact_decode and exact_decode != "host"
                        else decode_heatmaps)
        self.compute_dtype = compute_dtype if compute_dtype is not None else torch.bfloat16
        self.tracknet = tracknet
        self.params = None
        if tracknet is not None:
            self.params = fused_params(fold_batchnorm(tracknet), self.compute_dtype,
                                       self.device, conv_backend)
        # the folded weights on each mesh entry's device, copied once
        self._mesh_params = (replicate_tree(self.params, mesh)
                             if mesh is not None and self.params is not None else None)
        self._weights = None
        if eval_mode != "nonoverlap":
            self._weights = torch.from_numpy(
                get_ensemble_weight(self.seq_len, eval_mode)).to(self.device)
        self.inpaintnet = inpaintnet.to(self.device).eval() if inpaintnet is not None else None
        self._staged_rallies: Dict[str, StagedRally] = {}
        self.last_eval_stats: Dict[str, float] = {}
        self.last_merge_s: Optional[float] = None  # test()'s merge across processes

    # ------------------------------------------------------------ staging

    def _put(self, arr: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def _stage_rally(self, cache: FrameCache, rally_dir: str, frame_ids) -> StagedRally:
        """Upload one rally's cached frames, padded with L-1 repeats of the
        last, and its median; with a mesh, copy them to each entry's device."""
        rgb_all, diff_all, med = cache.load(rally_dir)
        need_rgb = self.bg_mode in ("", "subtract_concat", "concat")

        def pad(x):
            return np.concatenate([x, np.repeat(x[-1:], self.seq_len - 1, axis=0)], axis=0)

        rgb = self._put(pad(rgb_all[frame_ids])) if need_rgb else None
        diff = self._put(pad(diff_all[frame_ids][..., None])) if diff_all is not None else None
        median = self._put(med.astype(np.float32)) if med is not None else None
        staged = StagedRally(rgb, diff, median, len(frame_ids))
        if self.mesh is not None:
            staged = staged._replace(replicas=tuple(replicate_tree(staged, self.mesh)))
        return staged

    def prestage(self, data_dir: str, rally_dirs, cache: FrameCache,
                 budget_bytes: float = 8e9) -> int:
        """Stage the rallies up front, up to ``budget_bytes`` of device
        memory (the rest are staged when evaluated). Nothing is staged for
        InpaintNet, which reads trajectories only. Returns the number of
        rallies staged."""
        if self.tracknet is None or self.inpaintnet is not None:
            return 0
        used, n = 0, 0
        for rally_dir in rally_dirs:
            if rally_dir in self._staged_rallies:
                n += 1
                continue
            frame_ids = _label_columns(rally_dir)["Frame"].astype(np.int64)
            staged = self._stage_rally(cache, rally_dir, frame_ids)
            if used + staged.nbytes > budget_bytes and n > 0:
                break
            self._staged_rallies[rally_dir] = staged
            used += staged.nbytes
            n += 1
        return n

    # ------------------------------------------------------------ TrackNet

    def _forward_cached(self, staged: StagedRally, starts: np.ndarray) -> torch.Tensor:
        """Forward the windows starting at the host ``starts``: (B, L, h, w)
        float32 probabilities. The windows are gathered from the uint8
        buffers by ``window_copy`` and cast after (the same bits as casting
        first). With a mesh each entry forwards its share of ``starts`` from
        its copy of the rally, and the shares are gathered in order on the
        engine's device."""
        L = self.seq_len
        n_rows = (staged.rgb if staged.rgb is not None else staged.diff).shape[0]
        check_starts(starts, L, n_rows)
        if self.mesh is None:
            return self._forward_share(staged, starts, self.params, self.device)
        shares = []
        for dev, rep, params, s in zip(self.mesh.devices, staged.replicas, self._mesh_params,
                                       split_batch(np.asarray(starts), self.mesh.size)):
            with device_context(dev):
                shares.append(self._forward_share(rep, s, params, dev))
        return gather_batch(shares, self.mesh)

    def _forward_share(self, staged: StagedRally, starts: np.ndarray, params,
                       device: torch.device) -> torch.Tensor:
        L = self.seq_len
        st = self._put(np.asarray(starts, np.int32), device)
        rgb = window_copy(staged.rgb, st, L).to(torch.float32) if staged.rgb is not None else None
        diff = (window_copy(staged.diff, st, L).to(torch.float32)
                if staged.diff is not None else None)
        x = window_channels(rgb, diff, staged.median, self.bg_mode)
        return tracknet_fused_forward(params, x).permute(0, 3, 1, 2)

    def _chunks(self, staged: StagedRally) -> Iterator[Tuple[torch.Tensor, int]]:
        """The rally's per-frame heatmaps as (maps (n, h, w) on the device,
        number of leading maps that are real frames), in frame order: the
        real maps of all chunks are the rally's frames (then padding, in
        ``nonoverlap``). The caller runs it under ``torch.inference_mode``."""
        T, L, B = staged.T, self.seq_len, self.batch_size
        if self.eval_mode == "nonoverlap":
            n_win = -(-T // L)
            for s in range(0, n_win, B):
                starts = np.minimum(np.arange(s, s + B) * L, (n_win - 1) * L)
                wins = self._forward_cached(staged, starts)
                yield wins.reshape((-1,) + wins.shape[2:]), min(B, n_win - s) * L
            return
        S = max(T - L + 1, 1)  # real windows
        state = ensemble_init(L, (self.h, self.w), self.device)
        for w0 in range(0, S, B):
            n_valid = min(B, S - w0)
            # windows past the last real one are masked by n_valid
            starts = np.minimum(w0 + np.arange(B), S - 1)
            state, frames = ensemble_update_fn(state, self._forward_cached(staged, starts),
                                               self._weights, n_valid)
            yield frames, n_valid
        if L > 1:
            yield ensemble_flush(state), T - S

    def ensembled_frames(self, staged: StagedRally) -> torch.Tensor:
        """(T, h, w) float32 heatmaps of the rally's frames, on the device."""
        with torch.inference_mode():
            return torch.cat([maps[:n] for maps, n in self._chunks(staged) if n])[: staged.T]

    @staticmethod
    def _pack_dec(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(N, 8) float32 rows [cx, cy, vis, conf, bbox x, y, w, h]."""
        cols = [dec[k].to(torch.float32)[:, None] for k in ("cx", "cy", "vis", "conf")]
        return torch.cat(cols + [dec["bbox"].to(torch.float32)], dim=1)

    def _staged(self, cache: FrameCache, rally_dir: str, frame_ids) -> StagedRally:
        staged = self._staged_rallies.get(rally_dir)
        return staged if staged is not None else self._stage_rally(cache, rally_dir, frame_ids)

    def predict_rally_heatmap(self, cache: FrameCache, rally_dir: str,
                              frame_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Decoded predictions of a rally's frames in model pixels: ``cx``,
        ``cy`` (int64, T), ``conf`` (float32, T), ``bbox`` (int64, (T, 4))."""
        staged = self._staged(cache, rally_dir, frame_ids)
        T = staged.T
        if self.exact_decode == "host":
            dec = decode_heatmaps_host(self.ensembled_frames(staged).cpu().numpy())
            return {"cx": dec["cx"].astype(np.int64), "cy": dec["cy"].astype(np.int64),
                    "conf": dec["conf"], "bbox": dec["bbox"].astype(np.int64)}
        with torch.inference_mode():
            rows = [self._pack_dec(self._decode(maps[:n])) for maps, n in self._chunks(staged)
                    if n]
            arr = torch.cat(rows)[:T].cpu().numpy()  # the one fetch
        return {"cx": arr[:, 0].astype(np.int64), "cy": arr[:, 1].astype(np.int64),
                "conf": arr[:, 3], "bbox": arr[:, 4:8].astype(np.int64)}

    # ------------------------------------------------------------ InpaintNet

    def predict_rally_coordinate(self, rally_dir: str) -> Dict[str, np.ndarray]:
        """InpaintNet over a rally's ``predicted_csv`` trajectory: the
        refined coordinates normalised by the model resolution (T, 2), with
        the ground truth and the TrackNet prediction beside them."""
        match_dir, rally_id = parse_rally_dir(rally_dir)
        L = self.inpaint_seq_len
        nonoverlap = self.eval_mode == "nonoverlap"
        data = build_rally_coordinate_index("", rally_dir, 0, L, L if nonoverlap else 1,
                                            padding=nonoverlap)
        cols = read_csv_columns(os.path.join(match_dir, "predicted_csv", f"{rally_id}_ball.csv"),
                                ("Frame", "X", "Y", "X_GT", "Y_GT"))
        T = len(cols["Frame"])
        norm = np.asarray([self.w, self.h], np.float32)

        S = len(data["id"])
        pad = max(S + L - 1, 1) - S  # the ensemble reads S + L - 1 rows
        cwin = np.concatenate([data["coor_pred"] / norm, np.zeros((pad, L, 2), np.float32)])
        mwin = np.concatenate([data["inpaint_mask"][..., None],
                               np.zeros((pad, L, 1), np.float32)])
        cw = torch.from_numpy(cwin).to(self.device)
        mw = torch.from_numpy(mwin).to(self.device)
        with torch.inference_mode(), tf32_off():
            out = self.inpaintnet(cw, mw)
            out = zero_below_th(out * mw + cw * (1.0 - mw))
            if nonoverlap:
                flat = out[:S].reshape(-1, 2).cpu().numpy()
                # the padded last window repeats its frames: keep each frame once
                _, first = np.unique(data["id"][..., 1].reshape(-1), return_index=True)
                refined = flat[np.sort(first)][:T]
            else:
                weights = torch.from_numpy(get_ensemble_weight(L, self.eval_mode))
                lead = torch.zeros((L - 1, L, 2), device=self.device)
                ens = ensemble_chunk(torch.cat([lead, out]), weights, 0, S)
                refined = zero_below_th(ens).cpu().numpy()[:T]

        def pair(a, b):
            return np.stack([cols[a], cols[b]], axis=-1).astype(np.float32) / norm

        return {"refined": refined, "coor_gt": pair("X_GT", "Y_GT"),
                "coor_pred": pair("X", "Y"), "frame": cols["Frame"].astype(np.int64)}

    # ------------------------------------------------------------ rallies

    def test_rally(self, data_dir: str, rally_dir: str, cache: FrameCache,
                   save_inpaint_mask: bool = False, output_bbox: bool = False,
                   output_gt: bool = False) -> Dict[str, list]:
        """One rally's prediction dict: ``Frame``, ``X``, ``Y`` (source
        pixels, or model pixels with ``save_inpaint_mask``), ``Visibility``,
        ``Type`` (the 5-way class), and in heatmap mode ``Inpaint_Mask``,
        with ``BBox`` / ``Confidence`` (``output_bbox``) and the ground
        truth (``output_gt`` or ``save_inpaint_mask``)."""
        cols = _label_columns(rally_dir, "X", "Y")
        w, h = _frame_size(rally_dir)
        w_s, h_s = (1.0, 1.0) if save_inpaint_mask else (w / self.w, h / self.h)

        if self.inpaintnet is not None:
            out = self.predict_rally_coordinate(rally_dir)
            cx_p = (out["refined"][:, 0] * self.w).astype(np.int64)
            cy_p = (out["refined"][:, 1] * self.h).astype(np.int64)
            cx_t = (out["coor_gt"][:, 0] * self.w).astype(np.int64)
            cy_t = (out["coor_gt"][:, 1] * self.h).astype(np.int64)
            types = classify_detections(cx_p, cy_p, cx_t, cy_t, self.tolerance)
            vis = (np.maximum(cx_p, cy_p) > 0).astype(int)
            return {"Frame": list(range(len(cx_p))), "X": [int(v * w_s) for v in cx_p],
                    "Y": [int(v * h_s) for v in cy_p], "Visibility": vis.tolist(),
                    "Type": types.tolist()}

        frame_ids = cols["Frame"].astype(np.int64)
        dec = self.predict_rally_heatmap(cache, rally_dir, frame_ids)
        cx_t, cy_t = gt_center_from_label(cols["X"], cols["Y"], w / self.w, h / self.h)
        types = classify_detections(dec["cx"], dec["cy"], cx_t, cy_t, self.tolerance)
        vis = (np.maximum(dec["cx"], dec["cy"]) > 0).astype(int)
        pred = {"Frame": list(range(len(frame_ids))), "X": [int(v * w_s) for v in dec["cx"]],
                "Y": [int(v * h_s) for v in dec["cy"]], "Visibility": vis.tolist(),
                "Type": types.tolist()}
        if output_bbox:
            pred["BBox"] = [[int(b[0] * w_s), int(b[1] * h_s), int(b[2] * w_s), int(b[3] * h_s)]
                            for b in dec["bbox"]]
            pred["Confidence"] = [float(c) for c in dec["conf"]]
        if output_gt or save_inpaint_mask:
            pred["X_GT"] = [int(v * w_s) for v in cx_t]
            pred["Y_GT"] = [int(v * h_s) for v in cy_t]
            pred["Visibility_GT"] = (np.maximum(cx_t, cy_t) > 0).astype(int).tolist()
        # th_h=30 is a threshold in model pixels: the gap scan reads the
        # model-space rows whatever space pred["Y"] is in
        mask_view = {"Visibility": vis.tolist(), "Y": [int(v) for v in dec["cy"]]}
        pred["Inpaint_Mask"] = generate_inpaint_mask(mask_view, th_h=30)
        return pred

    def test_rally_linear(self, data_dir: str, rally_dir: str, cache: FrameCache
                          ) -> Dict[str, list]:
        """The linear-interpolation baseline over TrackNet's trajectory."""
        pred = self.test_rally(data_dir, rally_dir, cache, save_inpaint_mask=False)
        cols = _label_columns(rally_dir, "X", "Y")
        w, h = _frame_size(rally_dir)
        w_s, h_s = w / self.w, h / self.h
        mask = pred["Inpaint_Mask"]
        x_interp = linear_interp(np.asarray(pred["X"], np.float64) / w_s, mask)
        y_interp = linear_interp(np.asarray(pred["Y"], np.float64) / h_s, mask)
        cx_t = (cols["X"] / w * self.w).astype(np.int64)
        cy_t = (cols["Y"] / h * self.h).astype(np.int64)
        cx_p = x_interp.astype(np.int64)
        cy_p = y_interp.astype(np.int64)
        types = classify_detections(cx_p, cy_p, cx_t, cy_t, self.tolerance)
        vis = (np.maximum(cx_p, cy_p) > 0).astype(int)
        return {"Frame": list(range(len(cx_p))), "X": [int(v * w_s) for v in cx_p],
                "Y": [int(v * h_s) for v in cy_p], "Visibility": vis.tolist(),
                "Type": types.tolist()}

    def test(self, data_dir: str, split: str, save_inpaint_mask: bool = False,
             use_linear_interp: bool = False, output_bbox: bool = False,
             output_gt: bool = False, debug: bool = False, verbose: bool = False
             ) -> Dict[str, Dict]:
        """Every rally of ``split``: {"{match}_{rally}": prediction dict}.
        With ``save_inpaint_mask`` each rally's ``predicted_csv`` file is
        written. ``last_eval_stats`` holds the frames, seconds and frames/s
        of the run.

        Under an initialised ``torch.distributed`` group of ``pc > 1``
        processes, rank ``pi`` evaluates the rallies ``rally_dirs[pi::pc]``
        (round robin, so long and short rallies spread evenly) and the
        dicts are merged (``_merge_pred_dicts``): every process returns the
        whole dict in the split's order, writes every ``predicted_csv``
        file from it, and counts its frames in ``last_eval_stats``;
        ``last_merge_s`` holds the merge's seconds."""
        pc, pi = process_count_index()
        rally_dirs = [os.path.join(data_dir, rd) for rd in get_rally_dirs(data_dir, split)]
        if debug:
            rally_dirs = rally_dirs[:1]
        my_rallies = rally_dirs if pc == 1 else rally_dirs[pi::pc]
        cache = FrameCache(data_dir, self.bg_mode, input_hw=(self.h, self.w))
        t0 = time.time()
        if self.tracknet is not None and not use_linear_interp:
            n_staged = self.prestage(data_dir, my_rallies, cache)
            if verbose:
                print(f"  prestaged {n_staged}/{len(my_rallies)} rallies")
        pred_dict = {}
        for rally_dir in my_rallies:
            key = _rally_key(rally_dir)
            if verbose:
                print(f"  rally {key}")
            if use_linear_interp:
                pred_dict[key] = self.test_rally_linear(data_dir, rally_dir, cache)
            else:
                pred_dict[key] = self.test_rally(data_dir, rally_dir, cache,
                                                 save_inpaint_mask=save_inpaint_mask,
                                                 output_bbox=output_bbox, output_gt=output_gt)
        if pc > 1:
            t_merge = time.time()
            pred_dict = self._merge_pred_dicts(pred_dict, rally_dirs, host_group())
            self.last_merge_s = time.time() - t_merge
        if save_inpaint_mask:
            for rally_dir in rally_dirs:
                match_dir, rally_id = parse_rally_dir(rally_dir)
                out_dir = os.path.join(match_dir, "predicted_csv")
                os.makedirs(out_dir, exist_ok=True)
                write_pred_csv(pred_dict[_rally_key(rally_dir)],
                               os.path.join(out_dir, f"{rally_id}_ball.csv"),
                               save_inpaint_mask=True)
        seconds = time.time() - t0
        frames = sum(len(p["Frame"]) for p in pred_dict.values())
        self.last_eval_stats = dict(frames=frames, seconds=round(seconds, 3),
                                    fps=round(frames / seconds, 2) if seconds > 0 else 0.0)
        return pred_dict

    @staticmethod
    def _merge_pred_dicts(local: Dict[str, Dict], rally_dirs, group=None) -> Dict[str, Dict]:
        """All-gather each process's per-rally prediction dicts and merge
        them in the order of ``rally_dirs``: every process gets the same
        dict, ordered as a single process's run.

        The dicts are ragged, so they travel as JSON bytes (lists of Python
        ints and floats by construction, so the transport cannot change
        them) padded to the longest: an int32 all-gather of the sizes, then
        one uint8 all-gather of the payloads. The tensors stay on the host;
        ``group`` (``parallel.processes.host_group``) must be able to gather them."""
        import torch.distributed as dist

        payload = np.frombuffer(json.dumps(local).encode(), np.uint8)
        if payload.size >= 2**31:
            raise ValueError(
                f"per-process pred-dict payload is {payload.size} bytes, over the 2 GiB int32 "
                "all-gather limit - use more processes or fewer output fields "
                "(output_bbox/output_gt)")
        pc = dist.get_world_size(group)
        sizes = [torch.zeros(1, dtype=torch.int32) for _ in range(pc)]
        dist.all_gather(sizes, torch.tensor([payload.size], dtype=torch.int32), group=group)
        sizes = [int(n) for n in sizes]
        buf = torch.zeros(max(sizes), dtype=torch.uint8)
        buf[: payload.size] = torch.from_numpy(payload.copy())
        bufs = [torch.empty_like(buf) for _ in range(pc)]
        dist.all_gather(bufs, buf, group=group)
        merged: Dict[str, Dict] = {}
        for b, n in zip(bufs, sizes):
            merged.update(json.loads(b[:n].numpy().tobytes().decode()))
        return {_rally_key(rd): merged[_rally_key(rd)] for rd in rally_dirs}


def get_test_res(pred_dict: Dict, data_dir: str, drop: bool = False) -> Dict:
    """The 5-way confusion summed over rallies and its metrics; with
    ``drop`` only the frames inside each rally's ``drop_frame.json`` window."""
    res = {t: 0 for t in PRED_TYPES}
    drop_dict = None
    if drop:
        with open(os.path.join(data_dir, "drop_frame.json")) as f:
            drop_dict = json.load(f)
    for rally_key, pred in pred_dict.items():
        types = np.asarray(pred["Type"])
        if drop_dict is not None:
            types = types[drop_dict["start"][rally_key] : drop_dict["end"][rally_key]]
        for t in PRED_TYPES:
            res[t] += int((types == PRED_TYPES_MAP[t]).sum())
    return metrics_dict(np.asarray([res[t] for t in PRED_TYPES], np.float64))
