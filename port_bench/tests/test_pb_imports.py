"""What the benchmark imports: nothing of JAX or of the JAX package,
compared by whole top-level names, and a reference that imports nothing of
the program."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tracknetv3_tpu"}


def _loaded(code: str):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _loaded(
        "import json, sys; sys.path[:0] = ['port_bench', '.']\n"
        "import run, calibrate\n"
        "import benchkit.serve_clips, benchkit.train_steps, benchkit.roofline\n"
        "import reference.serve, reference.train\n"
        "import tracknetv3_tpu_torch.inference, tracknetv3_tpu_torch.training.loop\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "tracknetv3_tpu_torch" in tops  # whole names: the port's starts with the JAX one's
    assert not tops & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded(
        "import json, sys; sys.path[:0] = ['port_bench']\n"
        "import reference.serve, reference.train, reference.tracknet\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "tracknetv3_tpu_torch" not in tops and not tops & FORBIDDEN
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"tracknetv3_tpu_torch",
                                                                        "benchkit"}), path


def test_the_benchmark_reads_no_file_of_the_jax_benchmark():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True):
        text = open(path).read()
        for name in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_r", "chip_smoke"):
            for line in text.splitlines():
                if name in line:
                    # a frozen copy may name its origin in prose, never open or import it
                    assert "open(" not in line and "import" not in line, (path, line)
