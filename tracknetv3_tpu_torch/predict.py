"""Video inference CLI of the PyTorch port:
``python -m tracknetv3_tpu_torch.predict --video_file V --tracknet_file T``
or ``--video_dir DIR`` for every ``.mp4`` / ``.avi`` / ``.mov`` / ``.mkv``
file of a directory.

The flags of the JAX package's ``predict.py``: ``--video_file`` /
``--video_dir`` (``predict_videos``: a failing video is skipped and the
run ends with ``Predicted n/N``; ``--fail_fast`` raises at the first),
``--tracknet_file``, ``--inpaintnet_file``, ``--batch_size``,
``--eval_mode``, ``--max_sample_num``, ``--video_range start,end``
(seconds of the streaming path's median), ``--save_dir``,
``--large_video`` (streaming), ``--output_video`` with ``--traj_len``,
``--device_resize`` (PIL-bicubic resize on the card), ``--cv2_decode``
(cv2 instead of the default native libav reader), ``--stage_format
{auto,yuv420,bgr}`` (the staged path's pixel format: ``auto``, the
default, stages planar YUV420 wherever the native reader serves the video,
half the bytes of packed BGR; a forced ``yuv420`` that cannot be honoured
raises), ``--profile DIR`` (a ``torch.profiler`` chrome trace of the run,
``DIR/trace.json``), ``--num_devices N`` (the staged path's window batches
sharded over N devices of ``--device``'s type, ``parallel/mesh.py``); plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels) and ``--conv_backend`` (``cudnn`` or the hand-written 3x3 conv
kernels ``hand_k3c`` / ``hand_9tap``; unset, the bfloat16 default of
``models.fused_forward.DEFAULT_CONV_BACKEND``).
TrackNet runs in bfloat16, as the JAX CLI does. Opening a video needs cv2
(its frame count and size; the native reader needs g++ and libav, else cv2
decodes too). The JAX CLI's ``--bucket_quantum`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

_UNPORTED = ("bucket_quantum",)
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_file", type=str, default="", help="file path of the video")
    p.add_argument("--video_dir", type=str, default="",
                   help="batch serving: predict every video in this directory with one "
                   "model load (inference.predict_videos)")
    p.add_argument("--fail_fast", action="store_true",
                   help="with --video_dir: raise at the first failing video instead of "
                   "skipping it")
    p.add_argument("--tracknet_file", type=str, required=True, help="TrackNet checkpoint path")
    p.add_argument("--inpaintnet_file", type=str, default="", help="InpaintNet checkpoint path")
    p.add_argument("--batch_size", type=int, default=16, help="batch size for inference")
    p.add_argument("--eval_mode", type=str, default="weight",
                   choices=["nonoverlap", "average", "weight"])
    p.add_argument("--max_sample_num", type=int, default=1800,
                   help="max frames sampled for the streaming path's median image")
    p.add_argument("--video_range", type=lambda s: [int(v) for v in s.split(",")],
                   default=None,
                   help="start,end seconds of the video used for the streaming path's "
                   "median image")
    p.add_argument("--save_dir", type=str, default="pred_result")
    p.add_argument("--large_video", action="store_true",
                   help="stream the video instead of loading it into memory")
    p.add_argument("--output_video", action="store_true",
                   help="write the video overlaid with the predicted trajectory")
    p.add_argument("--traj_len", type=int, default=8, help="length of the drawn trajectory comet")
    p.add_argument("--device_resize", action="store_true",
                   help="ship raw frames and resize on the card with PIL's bicubic instead "
                   "of the host INTER_LINEAR resize")
    p.add_argument("--cv2_decode", action="store_true",
                   help="decode with cv2 instead of the native libav reader (which scales "
                   "during decode and uses DCT-domain lowres on large sources)")
    p.add_argument("--stage_format", type=str, default="auto", choices=("auto", "yuv420", "bgr"),
                   help="staging pixel format: yuv420 uploads planar YUV420 (half the bytes; "
                   "converted to RGB on the card), bgr packed BGR; auto picks yuv420 wherever "
                   "the native reader serves the video")
    p.add_argument("--num_devices", type=int, default=None,
                   help="shard the staged path's window batches over a data-parallel mesh of "
                   "this many devices (default: one device)")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler chrome trace of the run to DIR/trace.json")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--conv_backend", type=str, default=None,
                   choices=["cudnn", "hand_k3c", "hand_9tap"],
                   help="who computes the folded forward's 3x3 convs (default: "
                   "models.fused_forward.DEFAULT_CONV_BACKEND)")
    for name in _UNPORTED:
        p.add_argument(f"--{name}", nargs="?", const=True, default=None,
                       help="not ported to PyTorch yet (raises)")
    return p


def main(argv: Optional[Sequence[str]] = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = [f"--{k}" for k in _UNPORTED if getattr(args, k) is not None]
    if bad:
        raise NotImplementedError(f"not ported to PyTorch yet: {', '.join(bad)}")
    if bool(args.video_file) == bool(args.video_dir):
        parser.error("exactly one of --video_file / --video_dir is required")
    if args.video_dir and (args.large_video or args.device_resize):
        parser.error("--video_dir uses the staged serving path; per-video "
                     "--large_video/--device_resize are not supported (oversized "
                     "videos fall back to streaming automatically)")

    import torch

    from .utils.profiling import trace

    if torch.device(args.device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick the fastest convs
    common = dict(tracknet_file=args.tracknet_file, inpaintnet_file=args.inpaintnet_file,
                  eval_mode=args.eval_mode, batch_size=args.batch_size,
                  max_sample_num=args.max_sample_num, save_dir=args.save_dir,
                  output_video=args.output_video, traj_len=args.traj_len,
                  device=args.device, conv_backend=args.conv_backend,
                  native_decode=not args.cv2_decode, stage_format=args.stage_format,
                  num_devices=args.num_devices)
    with trace(args.profile):
        out = _run(args, common)
    print("Done.")
    return out


def _run(args, common: dict):
    from . import inference

    if args.video_dir:
        files = sorted(f for f in glob.glob(os.path.join(args.video_dir, "*"))
                       if f.lower().endswith(VIDEO_EXTS))
        if not files:
            raise FileNotFoundError(f"no videos in {args.video_dir}")
        print(f"Batch predicting {len(files)} videos from {args.video_dir}")
        results = inference.predict_videos(
            files, on_error="raise" if args.fail_fast else "skip", **common)
        skipped = len(files) - len(results)
        print(f"Predicted {len(results)}/{len(files)} videos"
              + (f" ({skipped} skipped - see warnings above)" if skipped else ""))
        if not results:
            raise SystemExit(f"all {len(files)} videos failed; nothing was predicted")
        return results
    return inference.predict_video(
        video_file=args.video_file,
        video_range=tuple(args.video_range) if args.video_range else None,
        large_video=args.large_video,
        device_resize=args.device_resize,
        **common,
    )


if __name__ == "__main__":
    main()
