"""Rally evaluation in several processes on the CPU (the JAX package's
``tests/test_multihost_engine.py``, over a ``torch.distributed`` gloo group
instead of ``jax.distributed``), on the data of ``tests/torch_rally_data.py``
with a TrackNet checkpoint that the port writes in the JAX npz format:

- two processes of a gloo group each evaluate their round-robin share of
  the test split (one rally each), end with the identical merged
  prediction dict, equal to one process's and to the JAX engine's
  single-process dict on the same checkpoint, and each writes the full
  ``predicted_csv`` set from it, byte-equal to one process's;
- the ``test`` CLI run in two such processes: every process returns the
  merged dict, and only rank 0 writes the result files;
- a group of one process merges nothing; the merge orders the dicts as the
  split and refuses a payload of 2 GiB or more.

Every child process and every rendezvous has a time limit, so that a hang
fails one test.
"""

import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch.distributed as dist  # noqa: E402

import torch_rally_data as rd  # noqa: E402
from tracknetv3_tpu_torch.evaluation import test_engine as te  # noqa: E402
from tracknetv3_tpu_torch.training.checkpoint import (  # noqa: E402
    load_model_from_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 120  # each child's time limit; its rendezvous waits at most 60 s
CHILD = r"""
import datetime, glob, json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from tracknetv3_tpu_torch.evaluation import test_engine as te
from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size={world},
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
evaluated = []
real_rally = te.RallyTestEngine.test_rally

def test_rally(self, data_dir, rally_dir, *args, **kwargs):
    evaluated.append(os.path.basename(rally_dir))
    return real_rally(self, data_dir, rally_dir, *args, **kwargs)

te.RallyTestEngine.test_rally = test_rally
real_engine = te.RallyTestEngine
engines = []

def engine_f32(*args, compute_dtype=None, **kwargs):
    engines.append(real_engine(*args, compute_dtype=torch.float32, **kwargs))
    return engines[-1]

if {cli!r}:
    from tracknetv3_tpu_torch import test as test_cli
    te.RallyTestEngine = engine_f32
    out = test_cli.main(["--tracknet_file", {tn!r}, "--data_dir", {data!r}, "--batch_size",
                         "4", "--device", "cpu", "--save_dir", {save!r}, "--output_pred",
                         "--output_bbox"])
    pred = out["pred_dict"]
else:
    model = load_model_from_checkpoint({tn!r}, dtype=torch.float32)[0]
    engine_f32(model, device="cpu", tracknet_seq_len=3, bg_mode="concat", batch_size=4,
               input_hw=(32, 64))
    pred = engines[0].test({data!r}, "test", save_inpaint_mask=True)
csvs = sorted(glob.glob(os.path.join({data!r}, "test", "match1", "predicted_csv", "*.csv")))
print("RESULT " + json.dumps(dict(
    pred=pred, evaluated=evaluated, frames=engines[0].last_eval_stats["frames"],
    merge_s=engines[0].last_merge_s, csvs=[open(c).read() for c in csvs])), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(dirs, tn: str, cli: bool = False, saves=None):
    """Each rank's RESULT, from one child per entry of ``dirs`` in a gloo
    group of that many processes."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(repo=REPO, port=port, world=len(dirs), rank=r,
                                            tn=tn, data=d, cli=cli,
                                            save=saves[r] if saves else "")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r, d in enumerate(dirs)]
    results = []
    try:
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
    return results


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset and a TrackNet checkpoint written by the port (from the
    JAX random init of ``torch_rally_data``)."""
    d = tmp_path_factory.mktemp("multiprocess")
    data = rd.write_dataset(str(d / "data"))
    jax_tn, _ = rd.write_checkpoints(str(d))
    tn = str(d / "TrackNet_port.pt")
    save_checkpoint(tn, epoch=0, max_val_acc=0.0,
                    model=load_model_from_checkpoint(jax_tn, dtype=torch.float32)[0],
                    param_dict=dict(model_name="TrackNet", seq_len=rd.L, bg_mode="concat",
                                    input_hw=[rd.H, rd.W]))
    yield data, tn
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _copies(data: str, root, tags):
    out = []
    for tag in tags:
        dst = str(root / tag)
        shutil.copytree(data, dst, ignore=shutil.ignore_patterns("predicted_csv"))
        out.append(dst)
    return out


def _csvs(data: str):
    d = os.path.join(data, "test", "match1", "predicted_csv")
    out = []
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out.append(f.read())
    return out


def test_two_processes_merge_into_one_process_dict_and_jax(setup, tmp_path):
    data, tn = setup
    rank0, rank1, solo, jdir = _copies(data, tmp_path, ("rank0", "rank1", "solo", "jax"))
    results = _run_group([rank0, rank1], tn)
    model = load_model_from_checkpoint(tn, dtype=torch.float32)[0]
    engine = te.RallyTestEngine(model, device="cpu", compute_dtype=torch.float32,
                                tracknet_seq_len=rd.L, bg_mode="concat", batch_size=rd.B,
                                input_hw=(rd.H, rd.W))
    one = engine.test(solo, "test", save_inpaint_mask=True)
    assert engine.last_merge_s is None
    mp = rd.jax_f32()
    try:
        want = rd.engines(tn)[0].test(jdir, "test", save_inpaint_mask=True)
    finally:
        mp.undo()
    assert one == want and list(one) == ["1_1_01_00", "1_1_02_00"]
    frames = sum(T for _, T in rd.RALLIES["test"])
    for r, res in enumerate(results):
        assert res["pred"] == one, f"rank {r}"
        assert list(res["pred"]) == list(one)
        assert res["evaluated"] == [rd.RALLIES["test"][r][0]]  # rally_dirs[r::2]
        assert res["frames"] == frames and res["merge_s"] >= 0
        assert res["csvs"] == _csvs(solo) == _csvs(jdir)  # the full set, on each copy
    assert sum(sum(p["Visibility"]) for p in one.values()) > 0


def test_test_cli_writes_its_files_from_rank_0_only(setup, tmp_path):
    data, tn = setup
    dirs = _copies(data, tmp_path, ("rank0", "rank1"))
    saves = [str(tmp_path / "out0"), str(tmp_path / "out1")]
    results = _run_group(dirs, tn, cli=True, saves=saves)
    assert results[0]["pred"] == results[1]["pred"]
    assert [r["evaluated"] for r in results] == [[rally] for rally, _ in rd.RALLIES["test"]]
    names = ["test_eval_res_weight.json", "test_eval_analysis_weight.json",
             "test_coco_res_weight.json"]
    assert sorted(os.listdir(saves[0])) == sorted(names)
    assert os.listdir(saves[1]) == []
    with open(os.path.join(saves[0], names[1])) as f:
        assert json.load(f)["pred_dict"] == results[0]["pred"]
    with open(os.path.join(saves[0], names[0])) as f:
        assert json.load(f)["eval_speed"]["frames"] == sum(T for _, T in rd.RALLIES["test"])


def test_a_group_of_one_merges_nothing_and_the_merge_keeps_split_order(setup, tmp_path,
                                                                        monkeypatch):
    data, tn = setup
    model = load_model_from_checkpoint(tn, dtype=torch.float32)[0]
    engine = te.RallyTestEngine(model, device="cpu", compute_dtype=torch.float32,
                                tracknet_seq_len=rd.L, bg_mode="concat", batch_size=rd.B,
                                input_hw=(rd.H, rd.W))
    want = engine.test(data, "test")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        assert te.process_count_index() == (1, 0) and te.host_group() is None
        assert engine.test(data, "test") == want and engine.last_merge_s is None
        rally_dirs = [rd.rally_dir(data, rally) for rally, _ in rd.RALLIES["test"]]
        shuffled = dict(reversed(list(want.items())))
        merged = te.RallyTestEngine._merge_pred_dicts(shuffled, rally_dirs)
        assert list(merged) == list(want) and merged == want
        monkeypatch.setattr(te, "np", types.SimpleNamespace(
            uint8=np.uint8, frombuffer=lambda *a: types.SimpleNamespace(size=2**31)))
        with pytest.raises(ValueError, match="over the 2 GiB int32 all-gather limit"):
            te.RallyTestEngine._merge_pred_dicts(want, rally_dirs)
    finally:
        dist.destroy_process_group()
