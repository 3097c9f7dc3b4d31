"""Data-parallel training in two processes of a gloo group on the CPU, run
as ``tests/test_torch_multiprocess_val.py`` runs its children (each under a
120 s limit, its rendezvous at most 60 s), against one process.

Each child calls ``train()`` under its group: the loaders give it its half
of each global batch (resident frames, held whole by each process), sample
mixup (``alpha`` 0.5) takes partner rows from the other process through an
all-gather, every BatchNorm reduces its sums over the group, one all-reduce
sums the gradients and the loss, and validation merges the ranks' shares.
Two epochs in float64 (the factory patched, for the reason
``test_torch_dp_train.py`` gives) on that file's data: every rank's history
within 1e-10 relative of one process's (val metrics equal), the same best
epoch, the parameters within 1e-10 relative L2 of one process's and bit-equal
between the ranks. Rank 0 alone writes ``TrackNet_best.pt`` /
``TrackNet_cur.pt`` and logs to ``logs``; rank 1 logs to ``logs_p1``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from test_torch_dp_train import _cfg, _rel, data_dir, float64_models  # noqa: E402,F401
from tracknetv3_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from tracknetv3_tpu_torch.training import loop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 120
OPTIONS = dict(resident_frames=True, alpha=0.5)
CHILD = r"""
import datetime, json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from test_torch_dp_train import _cfg, float64_models
from tracknetv3_tpu_torch.training import loop

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
with float64_models():
    out = loop.train(_cfg({save!r}, **{options!r}), {data!r}, device="cpu", verbose_print=str)
np.savez({save!r} + "/params.npz", **{{k: v.numpy() for k, v in out["model"].state_dict().items()}})
print("RESULT " + json.dumps(dict(step=out["step"], history=[
    dict(train_loss=h["train_loss"], val_loss=h["val_loss"], val_res=h["val_res"])
    for h in out["history"]])), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks_and_one(data_dir, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("dp_processes")
    port = _free_port()
    procs = []
    for r in (0, 1):
        (d / f"rank{r}").mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                                                port=port, rank=r, save=str(d / f"rank{r}"),
                                                options=OPTIONS, data=data_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        with float64_models():  # one process, while the children train
            one = loop.train(_cfg(d / "one", **OPTIONS), data_dir, device="cpu",
                             verbose_print=str)
        results = []
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_S)
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
            (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    yield d, results, one
    shutil.rmtree(d, ignore_errors=True)  # the full-width checkpoints, 130 MB each


def test_ranks_train_as_one_process(two_ranks_and_one):
    d, results, one = two_ranks_and_one
    for r in results:
        assert r["step"] == one["step"]
        for g, w in zip(r["history"], one["history"]):
            assert _rel(g["train_loss"], w["train_loss"]) <= 1e-10
            assert _rel(g["val_loss"], w["val_loss"]) <= 1e-10
            assert g["val_res"] == w["val_res"]
    best = ckpt.load_checkpoint(str(d / "rank0" / "TrackNet_best.pt"))
    want = ckpt.load_checkpoint(str(d / "one" / "TrackNet_best.pt"))
    assert best["epoch"] == want["epoch"] and best["max_val_acc"] == want["max_val_acc"]
    ranks = [np.load(d / f"rank{r}" / "params.npz") for r in (0, 1)]
    sd = one["model"].state_dict()
    for k, v in sd.items():
        assert np.array_equal(ranks[0][k], ranks[1][k]), k  # bit-equal between the ranks
        w = v.numpy()
        assert np.linalg.norm(ranks[0][k] - w) <= 1e-10 * max(np.linalg.norm(w), 1e-30), k


def test_rank_0_alone_writes_checkpoints_and_rank_1_logs_apart(two_ranks_and_one):
    d, _, _ = two_ranks_and_one
    for name in ("TrackNet_best.pt", "TrackNet_cur.pt"):
        assert (d / "rank0" / name).exists()
        assert not (d / "rank1" / name).exists()
    assert (d / "rank0" / "logs" / "scalars.jsonl").exists()
    assert (d / "rank1" / "logs_p1" / "scalars.jsonl").exists()
    assert not (d / "rank1" / "logs").exists() and not (d / "rank0" / "logs_p1").exists()
