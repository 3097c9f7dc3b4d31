"""The port's data-parallel mesh (``tracknetv3_tpu_torch/parallel/mesh.py``)
on the CPU against the JAX package's (``tracknetv3_tpu/parallel/mesh.py``,
whose tests run on the 8 virtual CPU devices of ``tests/conftest.py``):

- ``pad_batch_to`` equal to the JAX function on the same seeded trees,
  numpy and torch leaves alike;
- ``make_mesh``: CPU entries, explicit devices with repeats (the card stood
  in twice), the JAX message when more devices are asked for than there are
  (cards counted by a monkeypatched ``torch.cuda.device_count``);
- ``shard_batch`` equal to the shards of the JAX batch sharding, and
  ``gather_batch`` / ``replicate_tree`` / ``split_batch`` around it;
- ``RallyTestEngine(mesh=)`` against the JAX engine on an 8-device mesh
  (``tests/test_engine_prestage.py``'s check): ``cx``, ``cy``, ``bbox``
  equal, ``conf`` within 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402

import torch_rally_data as rd  # noqa: E402
from tracknetv3_tpu.parallel import mesh as jmesh  # noqa: E402
from tracknetv3_tpu_torch.data.dataset import FrameCache  # noqa: E402
from tracknetv3_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint  # noqa: E402


def _tree(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "ids": rng.integers(0, 100, (n,)).astype(np.int32),
            "nested": [rng.integers(0, 255, (n, 2), dtype=np.uint8)]}


@pytest.mark.parametrize("n,target", [(5, 8), (8, 8), (1, 4), (3, 16)])
def test_pad_batch_to_matches_jax(n, target):
    tree = _tree(n, n)
    want = jmesh.pad_batch_to(tree, target)
    got = pmesh.pad_batch_to(tree, target)
    flat_w, flat_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g) == 3
    for w, g in zip(flat_w, flat_g):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape[0] == target
    as_torch = pmesh.pad_batch_to({k: torch.from_numpy(v) for k, v in tree.items()
                                   if k != "nested"}, target)
    for k in ("x", "ids"):
        np.testing.assert_array_equal(as_torch[k].numpy(), np.asarray(want[k]))


def test_make_mesh_entries():
    m = pmesh.make_mesh(4, device="cpu")
    assert m.size == 4 and m.devices == (torch.device("cpu"),) * 4
    assert m.axis_names == jmesh.make_mesh(4).axis_names == ("data",)
    assert pmesh.make_mesh(device="cpu").size == 1
    twice = pmesh.make_mesh(devices=["cuda:0", "cuda:0"])  # no card needed to name one
    assert twice.devices == (torch.device("cuda", 0),) * 2
    assert pmesh.make_mesh(1, devices=["cpu", "cpu", "cpu"]).size == 1
    assert pmesh.make_mesh(devices=["cpu:0"]).devices == (torch.device("cpu"),)


@pytest.mark.parametrize("cards", [0, 1, 2])
def test_make_mesh_refuses_more_devices_than_there_are(cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=f"Requested {cards + 1} devices, only {cards} "
                                         f"available"):
        pmesh.make_mesh(cards + 1)
    if cards:
        m = pmesh.make_mesh(cards)
        assert m.devices == tuple(torch.device("cuda", i) for i in range(cards))
        assert pmesh.make_mesh().size == cards
    else:
        with pytest.raises(ValueError, match="only 0 available"):
            pmesh.make_mesh()
    with pytest.raises(ValueError, match="at least 1"):
        pmesh.make_mesh(0, device="cpu")
    # the JAX function's words, on its 8 virtual devices
    with pytest.raises(ValueError, match="Requested 9 devices, only 8 available"):
        jmesh.make_mesh(9)
    with pytest.raises(ValueError, match="Requested 9 devices, only 8 available"):
        pmesh.make_mesh(9, devices=["cpu"] * 8)


def test_shards_match_the_jax_batch_sharding():
    x = np.random.default_rng(2).normal(size=(8, 5)).astype(np.float32)
    jm = jmesh.make_mesh(4)
    arr = jax.device_put(x, jmesh.batch_sharding(jm))
    want = [np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                               key=lambda s: s.index[0].start)]
    m = pmesh.make_mesh(4, device="cpu")
    got = pmesh.shard_batch({"x": x, "keep": "a string"}, m)
    assert len(got) == 4 and all(g["keep"] == "a string" for g in got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["x"].numpy(), w)
    back = pmesh.gather_batch([g["x"] for g in got], m)
    np.testing.assert_array_equal(back.numpy(), x)
    assert [s.shape[0] for s in pmesh.split_batch(torch.arange(8), 4)] == [2, 2, 2, 2]
    assert [s.tolist() for s in pmesh.split_batch(np.arange(4), 2)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        pmesh.split_batch(torch.arange(8), 3)


def test_replicate_tree_shares_what_is_already_there():
    t = torch.arange(6.0)
    reps = pmesh.replicate_tree({"t": t, "n": np.ones(2), "k": 3}, pmesh.make_mesh(3,
                                                                                 device="cpu"))
    assert len(reps) == 3
    for r in reps:
        assert r["t"] is t and r["k"] == 3
        assert isinstance(r["n"], torch.Tensor) and r["n"].tolist() == [1.0, 1.0]


@pytest.fixture(scope="module")
def rally(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_rally")
    data = rd.write_dataset(str(d / "data"))
    tn, _ = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    yield data, tn
    mp.undo()


@pytest.mark.parametrize("eval_mode", ["weight", "nonoverlap"])
def test_sharded_engine_matches_the_jax_sharded_engine(rally, eval_mode):
    """Batch 8 over 8 JAX devices and over 8 / 2 CPU entries of the port."""
    data, tn = rally
    jm, jv, _ = rd.jax_load(tn)
    kw = dict(tracknet_seq_len=rd.L, bg_mode="concat", batch_size=8, input_hw=(rd.H, rd.W),
              eval_mode=eval_mode)
    jax_engine = rd.JaxEngine((jm, jv), mesh=jmesh.make_mesh(8), **kw)
    model = load_model_from_checkpoint(tn, dtype=torch.float32)[0]
    ports = {n: rd.RallyTestEngine(model, device="cpu", compute_dtype=torch.float32,
                                   mesh=pmesh.make_mesh(n, device="cpu") if n else None, **kw)
             for n in (0, 2, 8)}
    visible = 0
    for rally_name, T in rd.RALLIES["test"]:
        want = rd.predict(jax_engine, data, rally_name, T)
        one = ports[0].predict_rally_heatmap(FrameCache(data, "concat", input_hw=(rd.H, rd.W)),
                                             rd.rally_dir(data, rally_name), np.arange(T))
        for n in (2, 8):
            got = rd.predict(ports[n], data, rally_name, T)
            for k in ("cx", "cy", "bbox"):
                np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
                np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            # a share's convolutions may sum in another order than the whole
            # batch's (CPU kernels block by batch): conf within JAX's bound
            np.testing.assert_allclose(got["conf"], np.asarray(want["conf"]), atol=1e-3)
            np.testing.assert_allclose(got["conf"], one["conf"], atol=1e-3)
        visible += int((one["cx"] > 0).sum())
    assert visible >= 5  # the rows hold detections
