"""Resident frames sharded over two processes of a gloo group on the CPU
(``frame_sharding="shard"``: each process holds half the rows of the padded
split and the step exchanges the windows' rows through one all-to-all), run
as ``tests/test_torch_dp_processes.py`` runs its children (each under a
120 s limit, its rendezvous at most 60 s), on that file's data at 32x64,
seq_len 3, batch 4 (two windows a process).

Each child takes its first float32 Adam step from the same weights on the
first batch of its ``"shard"`` loader and of its ``"replicate"`` loader:
loss, every gradient and the parameters bit-equal between the two, between
the ranks, and to the same step over a one-process mesh of two CPU entries
with the frames sharded over them. Then each child trains one epoch (float64)
under the group with the loader's budget below the train split: its log
says ``shard over 2 devices``, and its history and parameters equal, bit for
bit, those of the same epoch with the frames replicated.
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

from test_torch_dp_train import data_dir  # noqa: E402,F401
from torch_dp_data import tracknet_model  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh, shard_train_batch  # noqa: E402
from tracknetv3_tpu_torch.training import optim, steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 120
KW = dict(batch_size=4, shuffle=True, drop_last=True, seed=3)
CHILD = r"""
import datetime, functools, hashlib, json, sys
from unittest import mock
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from test_torch_dp_shard_processes import first_step
from test_torch_dp_train import _cfg, float64_models
from tracknetv3_tpu_torch.data import dataset as ds
from tracknetv3_tpu_torch.parallel.processes import device_group
from tracknetv3_tpu_torch.training import loop

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
group = device_group("cpu")
res = {{mode: first_step({data!r}, mode, dict(process_id={rank}, process_count=2), group)
       for mode in ("shard", "replicate")}}
runs = {{}}
for mode, budget in (("replicate", 6e9), ("shard", {budget})):
    logs = []
    placed = functools.partial(ds.ResidentHeatmapLoader, budget_bytes=budget)
    with float64_models(), mock.patch.object(loop, "ResidentHeatmapLoader", placed):
        out = loop.train(_cfg({save!r} + "/" + mode, epochs=1, resident_frames=True),
                         {data!r}, device="cpu", verbose_print=logs.append)
    placed_lines = [str(m) for m in logs if str(m).startswith(("Resident", "resident"))]
    runs[mode] = dict(logs=placed_lines,
                      history=[(h["train_loss"], h["val_loss"], h["val_res"])
                               for h in out["history"]],
                      params=hashlib.sha256(b"".join(
                          v.numpy().tobytes() for v in out["model"].state_dict().values())
                      ).hexdigest())
print("RESULT " + json.dumps(dict(steps=res, train=runs)), flush=True)
dist.destroy_process_group()
"""


def first_step(data_dir, mode, where, group=None):  # noqa: F811
    """One float32 Adam step of a seeded TrackNet on the first batch of a
    resident loader placed by ``mode``, over ``group`` (this process's
    share; ``where``: its ``process_id`` / ``process_count``) or over the
    ``mesh`` in ``where``: the loss and the SHA-256 of every gradient and
    parameter."""
    import hashlib

    idx = ds.build_split_index(data_dir, "train", 3, 1, input_hw=(32, 64))
    mesh = where.get("mesh")
    loader = ds.ResidentHeatmapLoader(idx, "concat", data_dir=data_dir, frame_sharding=mode,
                                      device="cpu", **KW, **where)
    assert loader.frame_sharding == mode
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in next(iter(loader)).items()}
    model = tracknet_model(seed=4, dtype=torch.float32)
    opt, sched = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    step = steps.make_tracknet_shares_train_step(
        model, opt, "concat", 0.0, sched, mesh=mesh or make_mesh(1, device="cpu"), group=group)
    loss = step(shard_train_batch(batch, mesh) if mesh else [batch], 0)
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.grad.numpy().tobytes() + p.detach().numpy().tobytes())
    return {"loss": float(loss), "sha256": digest.hexdigest()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(data_dir, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("dp_shard_processes")
    idx = ds.build_split_index(data_dir, "train", 3, 1, input_hw=(32, 64))
    total = ds.ResidentHeatmapLoader(idx, "concat", 4, data_dir=data_dir,
                                     device="cpu").rgb_buf.numel()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                                            port=port, rank=r, save=str(d / f"rank{r}"),
                                            data=data_dir, budget=0.75 * total)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        mesh = {m: first_step(data_dir, m, dict(mesh=make_mesh(2, device="cpu")))
                for m in ("shard", "replicate")}
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
    yield results, mesh
    shutil.rmtree(d, ignore_errors=True)  # the full-width checkpoints, 130 MB each


def test_each_rank_s_sharded_step_is_its_replicated_step(two_ranks):
    results, mesh = two_ranks
    assert mesh["shard"] == mesh["replicate"]
    for r in results:
        assert r["steps"]["shard"] == r["steps"]["replicate"] == mesh["shard"]


def test_the_loop_shards_over_the_group_above_the_budget(two_ranks):
    results, _ = two_ranks
    for r in results:
        runs = r["train"]
        assert runs["shard"]["logs"] == [
            "Resident frames: split staged to device memory (shard over 2 devices)"]
        assert runs["replicate"]["logs"] == [
            "Resident frames: split staged to device memory (replicate over 2 devices)"]
        assert runs["shard"]["history"] == runs["replicate"]["history"]
        assert runs["shard"]["params"] == runs["replicate"]["params"]
    assert results[0]["train"] == results[1]["train"]
