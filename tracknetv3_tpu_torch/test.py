"""Evaluation CLI of the PyTorch port: ``python -m tracknetv3_tpu_torch.test
--tracknet_file T [--inpaintnet_file I] --data_dir DATA``.

The flags of the JAX package's ``test.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels) and
``--conv_backend`` (as the predict CLI's). TrackNet runs in bfloat16, as
the JAX CLI does. Writes ``{split}_eval_res_{mode}.json`` (the metrics and
``eval_speed``), with ``--output_pred`` ``{split}_eval_analysis_{mode}.json``
(the prediction dicts), with ``--output_bbox`` ``{split}_coco_res_{mode}.json``
(COCO mAP at IoU 0.25 and 0.5) into ``--save_dir``. ``--video_file
{...}/match{N}/video/{rally}.mp4`` evaluates that one labelled rally (its
frames under ``match{N}/frame/{rally}``) and writes ``{rally}_ball.csv``
(``Frame, Visibility, X, Y``) and ``{rally}.mp4``, the video with the
predicted and the labelled trajectories drawn (cv2). ``--num_devices``
above 1 raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tracknet_file", type=str, help="TrackNet checkpoint path")
    p.add_argument("--inpaintnet_file", type=str, default="", help="InpaintNet checkpoint path")
    p.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--tolerance", type=float, default=4)
    p.add_argument("--eval_mode", type=str, default="weight",
                   choices=["nonoverlap", "average", "weight"])
    p.add_argument("--video_file", type=str, default="",
                   help="evaluate one labelled rally, {...}/video/{rally}.mp4, and write its "
                   "CSV and overlay video")
    p.add_argument("--output_pred", action="store_true", default=False)
    p.add_argument("--output_bbox", action="store_true", default=False)
    p.add_argument("--save_dir", type=str, default="output")
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--linear_interp", action="store_true", default=False)
    p.add_argument("--exact_decode", nargs="?", const="device", default="",
                   choices=["", "device", "host"],
                   help="the largest-bbox-area blob rule instead of the peak-blob decoder: "
                   "bare flag (= 'device') on the device, 'host' on the host")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data parallel over more than one device is not ported yet (raises)")
    p.add_argument("--input_hw", type=str, default="",
                   help="model input resolution 'H,W'; default: the TrackNet checkpoint's "
                   "(else the config's HEIGHT,WIDTH)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--conv_backend", type=str, default=None,
                   choices=["cudnn", "hand_k3c", "hand_9tap"],
                   help="who computes the folded forward's 3x3 convs (default: "
                   "models.fused_forward.DEFAULT_CONV_BACKEND)")
    return p


def _load_models(tracknet_file: str, inpaintnet_file: str, input_hw_flag: str = ""):
    """(TrackNet or None, InpaintNet or None, engine keyword arguments,
    param_dict entries): the models of the checkpoints and what they fix,
    seq_len, bg_mode and the model resolution (the flag, else the TrackNet
    checkpoint's, else the config's)."""
    import torch

    from .training.checkpoint import load_model_from_checkpoint

    tracknet = inpaintnet = None
    kw = dict(tracknet_seq_len=8, inpaintnet_seq_len=16, bg_mode="", input_hw=None)
    recorded = {}
    if input_hw_flag:
        kw["input_hw"] = tuple(int(v) for v in input_hw_flag.split(","))
    if tracknet_file:
        tracknet, pd = load_model_from_checkpoint(tracknet_file, dtype=torch.float32)
        kw["tracknet_seq_len"] = recorded["tracknet_seq_len"] = pd["seq_len"]
        kw["bg_mode"] = recorded["bg_mode"] = pd.get("bg_mode", "")
        if kw["input_hw"] is None and pd.get("input_hw"):
            kw["input_hw"] = tuple(int(v) for v in pd["input_hw"])
    if kw["input_hw"] is not None:
        recorded["input_hw"] = list(kw["input_hw"])
    if inpaintnet_file:
        inpaintnet, pd = load_model_from_checkpoint(inpaintnet_file)
        kw["inpaintnet_seq_len"] = recorded["inpaintnet_seq_len"] = pd.get("seq_len", 16)
    return tracknet, inpaintnet, kw, recorded


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if (args.num_devices or 1) > 1:
        raise NotImplementedError("not ported to PyTorch yet: --num_devices > 1")

    import torch

    from .evaluation.test_engine import RallyTestEngine, get_test_res
    from .device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: refuse before loading

    os.makedirs(args.save_dir, exist_ok=True)
    param_dict = vars(args)
    print("Loading checkpoint...")
    tracknet, inpaintnet, kw, recorded = _load_models(args.tracknet_file, args.inpaintnet_file,
                                                     args.input_hw)
    param_dict.update(recorded)
    if torch.device(args.device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick the fastest convs
    engine = RallyTestEngine(tracknet, inpaintnet, eval_mode=args.eval_mode,
                             batch_size=args.batch_size, tolerance=args.tolerance,
                             exact_decode=args.exact_decode, device=args.device,
                             conv_backend=args.conv_backend, **kw)

    if args.video_file:
        return _test_video(args, engine, kw)

    eval_analysis_file = os.path.join(args.save_dir,
                                      f"{args.split}_eval_analysis_{args.eval_mode}.json")
    eval_res_file = os.path.join(args.save_dir, f"{args.split}_eval_res_{args.eval_mode}.json")
    start = time.time()
    print(f"Split: {args.split}\nEvaluation mode: {args.eval_mode}\n"
          f"Tolerance Value: {args.tolerance}")
    pred_dict = engine.test(args.data_dir, args.split, use_linear_interp=args.linear_interp,
                            output_bbox=args.output_bbox, debug=args.debug,
                            verbose=args.verbose)
    res_dict = get_test_res(pred_dict, args.data_dir, drop=args.split == "test")
    if engine.last_eval_stats:
        res_dict["eval_speed"] = engine.last_eval_stats
        print(f"Eval wall-clock: {engine.last_eval_stats['frames']} frames in "
              f"{engine.last_eval_stats['seconds']}s = {engine.last_eval_stats['fps']} FPS")
    with open(eval_res_file, "w") as f:
        json.dump(res_dict, f, indent=2)
    print(json.dumps(res_dict, indent=2))

    if args.output_pred:
        serializable = {k: v for k, v in param_dict.items()
                        if isinstance(v, (str, int, float, bool))}
        with open(eval_analysis_file, "w") as f:
            json.dump(dict(param_dict=serializable, pred_dict=pred_dict), f, indent=2)

    mAP = None
    if args.output_bbox:
        from .evaluation.coco import (
            convert_gt_to_coco_json,
            evaluate_ap,
            get_coco_res,
            gt_coco_json_path,
        )

        coco_file = os.path.join(args.save_dir, f"{args.split}_coco_res_{args.eval_mode}.json")
        drop = args.split == "test"
        dect_list = get_coco_res(pred_dict, args.data_dir, drop=drop)
        gt_json = gt_coco_json_path(args.data_dir, args.split, drop=drop)
        if not os.path.exists(gt_json):
            gt_json = convert_gt_to_coco_json(args.data_dir, args.split, drop=drop)
        mAP = {iou: evaluate_ap(gt_json, dect_list, iou) for iou in (0.25, 0.5)}
        print(f"mAP: {mAP}")
        with open(coco_file, "w") as f:
            json.dump(dict(AP_25=mAP, detection=dect_list), f, indent=2)

    print(f"Elapsed {time.time() - start:.1f}s")
    return dict(pred_dict=pred_dict, res=res_dict, mAP=mAP)


def _test_video(args, engine, kw) -> dict:
    """``--video_file``: one labelled rally through ``engine.test_rally``,
    then ``{rally}.mp4`` and ``{rally}_ball.csv`` in ``--save_dir``."""
    from .data.dataset import FrameCache
    from .utils.io import (
        label_csv_path,
        parse_video_file,
        read_csv_columns,
        write_pred_csv,
        write_pred_video,
    )

    print(f"Test on video {args.video_file} ...")
    match_dir, rally_id = parse_video_file(args.video_file)
    rally_dir = os.path.join(match_dir, "frame", rally_id)
    label = read_csv_columns(label_csv_path(match_dir, rally_id), ("Visibility", "X", "Y"))
    cache = FrameCache(args.data_dir, kw["bg_mode"], input_hw=kw["input_hw"])
    pred = engine.test_rally(args.data_dir, rally_dir, cache)
    out_video = os.path.join(args.save_dir, f"{rally_id}.mp4")
    out_csv = os.path.join(args.save_dir, f"{rally_id}_ball.csv")
    write_pred_video(args.video_file, pred, out_video, label=label)
    write_pred_csv({k: pred[k] for k in ("Frame", "X", "Y", "Visibility")}, out_csv)
    print(f"Wrote {out_video} and {out_csv}")
    return dict(pred=pred, video=out_video, csv=out_csv)


if __name__ == "__main__":
    main()
