"""Video inference CLI of the PyTorch port:
``python -m tracknetv3_tpu_torch.predict --video_file V --tracknet_file T``.

The flags of the JAX package's ``predict.py`` for its default path
(``--video_file``, ``--tracknet_file``, ``--inpaintnet_file``,
``--batch_size``, ``--eval_mode``, ``--max_sample_num``, ``--save_dir``),
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of
the kernels) and ``--conv_backend`` (``cudnn`` or the hand-written 3x3
conv kernels ``hand_k3c`` / ``hand_9tap``; unset, the bfloat16 default of
``models.fused_forward.DEFAULT_CONV_BACKEND``). TrackNet runs in bfloat16,
as the JAX CLI does. Decoding needs cv2. The other flags of ``predict.py``
(batch serving, streaming, video output, device resize, the native
decoder's formats, meshes, profiling) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

_UNPORTED = ("video_dir", "fail_fast", "bucket_quantum", "video_range", "large_video",
             "output_video", "traj_len", "device_resize", "stage_format", "profile",
             "num_devices")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_file", type=str, default="", help="file path of the video")
    p.add_argument("--tracknet_file", type=str, required=True, help="TrackNet checkpoint path")
    p.add_argument("--inpaintnet_file", type=str, default="", help="InpaintNet checkpoint path")
    p.add_argument("--batch_size", type=int, default=16, help="batch size for inference")
    p.add_argument("--eval_mode", type=str, default="weight",
                   choices=["nonoverlap", "average", "weight"])
    p.add_argument("--max_sample_num", type=int, default=1800,
                   help="bounds the streaming path's median only (not ported); the "
                   "staged path takes the median over all frames")
    p.add_argument("--save_dir", type=str, default="pred_result")
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
    if not args.video_file:
        parser.error("--video_file is required")

    import torch

    from .inference import predict_video

    if torch.device(args.device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick the fastest convs
    pred = predict_video(
        video_file=args.video_file,
        tracknet_file=args.tracknet_file,
        inpaintnet_file=args.inpaintnet_file,
        eval_mode=args.eval_mode,
        batch_size=args.batch_size,
        max_sample_num=args.max_sample_num,
        save_dir=args.save_dir,
        device=args.device,
        conv_backend=args.conv_backend,
    )
    print("Done.")
    return pred


if __name__ == "__main__":
    main()
