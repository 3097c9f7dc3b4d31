"""Label-correction web UI of the PyTorch port:
``python -m tracknetv3_tpu_torch.correct_label``.

The flags of the JAX package's ``correct_label.py`` (which replaces the
reference's Dash app). The same rally / frame browser as
``error_analysis``; click the frame image to set a corrected ball
coordinate, then "Write Result" saves ``corrected_csv/{rally}_ball.csv``
into the dataset (reference contract: correct_label.py:187-206). Host
only: it does no device work and takes no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--analysis_file", type=str, required=True,
                    help="eval analysis JSON from test --output_pred")
    ap.add_argument("--data_dir", type=str, default="data")
    ap.add_argument("--port", type=int, default=8051)
    ap.add_argument("--host", type=str, default="127.0.0.1",
                    help="bind address (0.0.0.0 exposes the label-write "
                    "endpoint to the network)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from .tools.webui import serve

    serve(args.analysis_file, data_dir=args.data_dir, port=args.port,
          correct_mode=True, host=args.host)


if __name__ == "__main__":
    main()
