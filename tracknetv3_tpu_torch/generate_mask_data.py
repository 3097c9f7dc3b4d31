"""InpaintNet training data from a TrackNet checkpoint:
``python -m tracknetv3_tpu_torch.generate_mask_data --tracknet_file T
--data_dir DATA``.

The flags of the JAX package's ``generate_mask_data.py`` plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels) and
``--conv_backend``. Runs the rally engine with TrackNet alone over each
split of ``--split_list`` and writes every rally's
``predicted_csv/{rally}_ball.csv``: the ground truth and the prediction in
model pixels and the ``Inpaint_Mask`` column. ``--num_devices N`` above 1
shards each chunk's windows over N devices of ``--device``'s type
(``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tracknet_file", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_mode", type=str, default="weight",
                   choices=["nonoverlap", "average", "weight"])
    p.add_argument("--split_list", type=lambda s: s.split(","), default=["train", "val", "test"])
    p.add_argument("--tolerance", type=float, default=4)
    p.add_argument("--exact_decode", nargs="?", const="device", default="",
                   choices=["", "device", "host"],
                   help="the largest-bbox-area blob rule instead of the peak-blob decoder: "
                   "bare flag (= 'device') on the device, 'host' on the host")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--num_devices", type=int, default=None,
                   help="shard window batches over a data-parallel mesh")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--conv_backend", type=str, default=None,
                   choices=["cudnn", "hand_k3c", "hand_9tap"],
                   help="who computes the folded forward's 3x3 convs")
    return p


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)

    import torch

    from .evaluation.test_engine import RallyTestEngine
    from .training.checkpoint import load_model_from_checkpoint
    from .device import resolve_device
    from .parallel.mesh import make_mesh

    resolve_device(args.device)  # no card and no --device cpu: refuse before loading

    if torch.device(args.device).type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick the fastest convs
    mesh = None
    if (args.num_devices or 0) > 1:
        mesh = make_mesh(args.num_devices, device=torch.device(args.device).type)
    model, pd = load_model_from_checkpoint(args.tracknet_file, dtype=torch.float32)
    engine = RallyTestEngine(model, None, mesh=mesh, tracknet_seq_len=pd["seq_len"],
                             bg_mode=pd.get("bg_mode", ""), eval_mode=args.eval_mode,
                             batch_size=args.batch_size, tolerance=args.tolerance,
                             exact_decode=args.exact_decode, device=args.device,
                             conv_backend=args.conv_backend)
    stats = {}
    for split in args.split_list:
        print(f"Generating predicted csv for {split} split...")
        engine.test(args.data_dir, split, save_inpaint_mask=True, debug=args.debug,
                    verbose=args.verbose)
        stats[split] = engine.last_eval_stats
    print("Done.")
    return stats


if __name__ == "__main__":
    main()
