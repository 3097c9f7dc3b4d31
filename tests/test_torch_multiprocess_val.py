"""The merged validation (``evaluation/loops.py`` with ``process_id`` /
``process_count``) in two processes of a gloo group on the CPU, run as
``tests/test_torch_multiprocess_eval.py`` runs its children, against one
process and against the JAX loops.

Each child evaluates its round-robin share of five batches through a fixed
eval step (stored probabilities or coordinates and a stored loss):
``eval_tracknet`` with the serving decode and both exact decodes, and
``eval_inpaintnet``. Both ranks end with the same loss and confusions, bit
for bit those of the port's one-process run, which equal the JAX package's
one-process ``eval_tracknet`` / ``eval_inpaintnet`` on the same batches (at
``tests/test_torch_eval.py``'s tolerance). Each child's train loop accepts
its group of two processes (``test_torch_dp_processes.py`` trains in one),
refuses ``fast_bn`` and a ``num_devices`` other than the process count;
under a group of one it accepts the defaults.
Every child and every rendezvous has a time limit, so that a hang fails one
test.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch.distributed as dist  # noqa: E402

from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.evaluation import loops  # noqa: E402
from tracknetv3_tpu_torch.training.loop import check_supported  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 120  # each child's time limit; its rendezvous waits at most 60 s
N_BATCHES, B, L, H, W = 5, 3, 4, 40, 72
DECODES = [False, "device", "host"]
CHILD = r"""
import datetime, json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from tracknetv3_tpu_torch.config import TrainConfig
from tracknetv3_tpu_torch.evaluation import loops
from tracknetv3_tpu_torch.training.loop import check_supported

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
with np.load({data!r}) as z:
    tn = [{{k: z[f"tn{{i}}_{{k}}"] for k in ("cxcy", "id", "probs", "loss")}}
          for i in range({n})]
    ip = [{{k: z[f"ip{{i}}_{{k}}"] for k in ("id", "coor", "coor_pred", "out", "loss")}}
          for i in range({n})]
evaluated = []

def tn_step(b):
    evaluated.append(int(b["id"][0, 0, 0]))
    return torch.tensor(b["loss"]), torch.from_numpy(b["probs"])

out = {{"tracknet": {{}}}}
for decode in {decodes!r}:
    loss, res = loops.eval_tracknet(tn_step, tn, 4.0, exact_decode=decode, process_id={rank},
                                    process_count=2)
    out["tracknet"][str(decode)] = [loss.hex(), res]
loss, res = loops.eval_inpaintnet(lambda b: (torch.tensor(b["loss"]), torch.from_numpy(b["out"])),
                                  ip, 4.0, input_hw=({h}, {w}), process_id={rank},
                                  process_count=2)
out["inpaintnet"] = [loss.hex(), res]
out["evaluated"] = evaluated
check_supported(TrainConfig(save_dir={save!r}))
out["train_accepted"] = True
for kw, err in ((dict(fast_bn=True), NotImplementedError), (dict(num_devices=4), ValueError)):
    try:
        check_supported(TrainConfig(**kw))
    except err as e:
        out["refused_" + next(iter(kw))] = str(e)
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def tracknet_batches(seed=0):
    """Batches of ``tests/test_torch_eval.py``'s kind: blobs on, near, far
    from or without the label, a padded window's repeated frame ids, and in
    half the frames a larger, dimmer blob beside the bright one (where the
    exact decodes differ from the peak blob)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(N_BATCHES):
        cx = rng.integers(3, W - 3, (B, L))
        cy = rng.integers(3, H - 3, (B, L))
        no_ball = rng.random((B, L)) < 0.25
        cx[no_ball] = cy[no_ball] = 0
        probs = (rng.random((B, H, W, L)) * 0.4).astype(np.float32)
        for b in range(B):
            for t in range(L):
                shift = rng.choice([0, 2, 9, -1])  # -1: no blob
                if shift < 0:
                    continue
                bx = int(cx[b, t] or rng.integers(3, W - 3)) + shift
                by = int(cy[b, t] or rng.integers(3, H - 3))
                probs[b, (yy - by) ** 2 + (xx - bx) ** 2 <= 6, t] = 0.9
        if i % 2:
            probs[:, 30:36, 2:14, ::2] = 0.6
        ids = np.stack([np.full((B, L), i), np.tile(np.arange(L), (B, 1))], -1)
        ids[-1, -2:] = ids[-1, -3]
        out.append({"cxcy": np.stack([cx, cy], -1).astype(np.int32),
                    "id": ids.astype(np.int32), "probs": probs,
                    "loss": np.float32(rng.random())})
    return out


def inpaintnet_batches(seed=1):
    """Coordinates in [0, 1], a prediction near or far from them or missing,
    and the network's output near either."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_BATCHES):
        coor = rng.uniform(0, 1, (B, L, 2)).astype(np.float32)
        coor[rng.random((B, L)) < 0.2] = 0
        pred = (coor + rng.normal(0, rng.choice([0.01, 0.2]), coor.shape)).astype(np.float32)
        pred[rng.random((B, L)) < 0.2] = 0
        pick = rng.random((B, L, 1)) < 0.5
        res = np.where(pick, coor, pred) + rng.normal(0, 0.02, coor.shape)
        ids = np.stack([np.full((B, L), i), np.tile(np.arange(L), (B, 1))], -1)
        ids[0, -1] = ids[0, -2]
        out.append({"id": ids.astype(np.int32), "coor": coor, "coor_pred": pred,
                    "out": np.clip(res, 0, 1).astype(np.float32),
                    "loss": np.float32(rng.random())})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tn_step(b):
    return torch.tensor(b["loss"]), torch.from_numpy(b["probs"])


def _ip_step(b):
    return torch.tensor(b["loss"]), torch.from_numpy(b["out"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiprocess_val")
    tn, ip = tracknet_batches(), inpaintnet_batches()
    data = str(d / "batches.npz")
    np.savez(data, **{f"tn{i}_{k}": v for i, b in enumerate(tn) for k, v in b.items()},
             **{f"ip{i}_{k}": v for i, b in enumerate(ip) for k, v in b.items()})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(repo=REPO, port=port, rank=r, data=data,
                                            n=N_BATCHES, decodes=DECODES, h=H, w=W,
                                            save=str(d / f"exp{r}"))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
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
    return results, tn, ip


@pytest.mark.parametrize("decode", DECODES)
def test_tracknet_ranks_merge_to_one_process_bit_for_bit_and_to_jax(two_ranks, decode):
    import jax.numpy as jnp

    from tracknetv3_tpu.evaluation.loops import eval_tracknet as jax_eval_tracknet

    results, tn, _ = two_ranks
    loss, res = loops.eval_tracknet(_tn_step, tn, 4.0, exact_decode=decode)
    for r in results:
        assert r["tracknet"][str(decode)] == [loss.hex(), res]
    want_loss, want = jax_eval_tracknet(
        None, lambda state, b: (b["loss"], jnp.asarray(b["probs"])), tn, 4.0,
        exact_decode=decode)
    assert loss == pytest.approx(want_loss, rel=1e-12)
    assert res == want
    assert min(res[k] for k in ("TP", "TN", "FP1", "FP2", "FN")) > 0


def test_inpaintnet_ranks_merge_to_one_process_bit_for_bit_and_to_jax(two_ranks):
    from tracknetv3_tpu.evaluation.loops import eval_inpaintnet as jax_eval_inpaintnet

    results, _, ip = two_ranks
    loss, res = loops.eval_inpaintnet(_ip_step, ip, 4.0, input_hw=(H, W))
    for r in results:
        assert r["inpaintnet"] == [loss.hex(), res]
    want_loss, want = jax_eval_inpaintnet(
        None, lambda state, b: (b["loss"], b["out"]), ip, 4.0, input_hw=(H, W))
    assert loss == pytest.approx(want_loss, rel=1e-12)
    assert res == want
    assert all(res[t]["TP"] > 0 and res[t]["FP1"] + res[t]["FP2"] + res[t]["FN"] > 0
               for t in res)


def test_each_rank_evaluated_its_round_robin_share(two_ranks):
    results, _, _ = two_ranks
    for rank, r in enumerate(results):
        # three TrackNet runs over the batches i with i % 2 == rank
        assert r["evaluated"] == [i for i in range(N_BATCHES) if i % 2 == rank] * len(DECODES)


def test_the_train_loop_accepts_a_group_of_two_and_of_one(two_ranks):
    results, _, _ = two_ranks
    for r in results:
        assert r["train_accepted"]
        assert "fast_bn" in r["refused_fast_bn"]
        assert "num_devices 4 is not supported" in r["refused_num_devices"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        check_supported(TrainConfig())
        with pytest.raises(ValueError, match="is rank 0 of a group of 1"):
            loops.eval_tracknet(_tn_step, tracknet_batches()[:2], process_id=1, process_count=2)
    finally:
        dist.destroy_process_group()
