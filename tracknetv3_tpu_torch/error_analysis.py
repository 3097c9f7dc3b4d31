"""Error-analysis web UI of the PyTorch port:
``python -m tracknetv3_tpu_torch.error_analysis``.

The flags of the JAX package's ``error_analysis.py`` (which replaces the
reference's Dash app, reference: error_analysis.py). Reads one or TWO
``{split}_eval_analysis_{mode}.json`` files written by ``test
--output_pred`` and serves an interactive per-rally view: 5-way type
strips for both results with drop-frame verticals, a diff lane marking
frames where only one result errs, an FP1/FP2 pixel-error histogram, and
a frame preview with GT + both predicted trajectories. Host only: it
does no device work and takes no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--analysis_file", type=str, required=True,
                    help="eval analysis JSON from test --output_pred")
    ap.add_argument("--analysis_file_2", type=str, default="",
                    help="second eval analysis JSON to compare against "
                    "(e.g. TrackNet-only vs +InpaintNet)")
    ap.add_argument("--data_dir", type=str, default="data")
    ap.add_argument("--port", type=int, default=8050)
    ap.add_argument("--host", type=str, default="127.0.0.1",
                    help="bind address (0.0.0.0 exposes the UI to the network)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from .tools.webui import serve

    serve(
        args.analysis_file,
        data_dir=args.data_dir,
        port=args.port,
        analysis_file_2=args.analysis_file_2 or None,
        host=args.host,
    )


if __name__ == "__main__":
    main()
