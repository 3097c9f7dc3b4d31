"""Training CLI of the PyTorch port: ``python -m tracknetv3_tpu_torch.train``.

The flags of the JAX package's ``train.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels).
``--model_name InpaintNet`` trains the trajectory inpainting network on the
``predicted_csv`` files (``--mask_ratio``, ``--seq_len 16`` in the README).
``--segment_windows N`` ships each N-window segment's frames once,
``--frame_alpha A`` turns frame mixup on, ``--resident_frames`` keeps the
splits' frames on the device (TrackNet); ``--exact_decode [host]``
validates with the largest-bbox-area decode rule. ``--num_devices N``
trains data-parallel on a mesh of N cards (N CPU entries with ``--device
cpu``); ``--multihost`` joins the process group that ``torchrun``
describes (``torchrun --nproc_per_node N -m tracknetv3_tpu_torch.train
--multihost ...``: one process and card a rank, NCCL; gloo with ``--device
cpu``) and trains one share a process. Either way every BatchNorm takes
the global batch's statistics. ``--fast_bn`` is not ported and raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_name", type=str, default="TrackNet", choices=["TrackNet", "InpaintNet"])
    p.add_argument("--seq_len", type=int, default=8, help="sequence length of input")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--optim", type=str, default="Adam", choices=["Adam", "SGD", "Adadelta"])
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--lr_scheduler", type=str, default="", choices=["", "StepLR"])
    p.add_argument("--bg_mode", type=str, default="",
                   choices=["", "subtract", "subtract_concat", "concat"])
    p.add_argument("--alpha", type=float, default=-1, help="sample-mixup alpha, -1 disables")
    p.add_argument("--frame_alpha", type=float, default=-1, help="frame-mixup alpha, -1 disables")
    p.add_argument("--mask_ratio", type=float, default=0.3)
    p.add_argument("--tolerance", type=float, default=4)
    p.add_argument("--resume_training", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--save_dir", type=str, default="exp")
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--segment_windows", type=int, default=1)
    p.add_argument("--fast_bn", action="store_true", default=False)
    p.add_argument("--no_split_up_entry", dest="split_up_entry", action="store_false",
                   default=True, help="recorded in param_dict; the port's forward "
                   "always concatenates (same function)")
    p.add_argument("--resident_frames", action="store_true", default=False)
    p.add_argument("--exact_decode", nargs="?", const="device", default="",
                   choices=["", "device", "host"])
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler chrome trace of the run to this directory")
    p.add_argument("--multihost", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)

    from .config import TrainConfig
    from .parallel.processes import init_from_env
    from .training.loop import train
    from .utils.profiling import trace

    import torch

    skip = ("data_dir", "profile", "multihost", "device")
    cfg = TrainConfig(**{k: v for k, v in vars(args).items() if k not in skip})
    device = init_from_env(args.device) if args.multihost else args.device
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick the fastest convs
    try:
        with trace(args.profile):
            out = train(cfg, data_dir=args.data_dir, device=device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()
    print("Done......")
    return out


if __name__ == "__main__":
    main()
