"""The port's ``RallyTestEngine`` staging and window gather on the CPU, on
the data and checkpoint of ``tests/torch_rally_data.py`` (as
``tests/test_torch_test_engine.py``):

- windows past the last real one (the last chunk's padding, their starts
  clamped on the host) filled with garbage leave the rows unchanged;
- staging pads with the last frame (uint8 frames, float32 median),
  prestaged equals lazy, and window starts are checked on the host;
- a mesh on a 2-entry CPU mesh gives the rows of one device, each entry
  holding a copy of the staged rally; what is not a mesh, a mesh that does
  not divide the batch and an unknown eval mode are refused.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
from tracknetv3_tpu_torch.data.dataset import FrameCache  # noqa: E402
from tracknetv3_tpu_torch.evaluation.test_engine import RallyTestEngine  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint  # noqa: E402

H, W, L, B = rd.H, rd.W, rd.L, rd.B
RALLIES = [(rally, T) for rally, T in rd.RALLIES["test"]]
MODES = ["nonoverlap", "average", "weight"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("rally")
    data = rd.write_dataset(str(d / "data"))
    tn, _ = rd.write_checkpoints(str(d))
    return data, tn


def _port(tn, **kw):
    model, _ = load_model_from_checkpoint(tn, dtype=torch.float32)
    return RallyTestEngine(model, device="cpu", compute_dtype=torch.float32,
                           tracknet_seq_len=L, bg_mode="concat", batch_size=B,
                           input_hw=(H, W), **kw)


@pytest.mark.parametrize("exact_decode", [False, True])
@pytest.mark.parametrize("eval_mode", MODES)
def test_padded_windows_reach_no_row(setup, eval_mode, exact_decode):
    """The last chunk's windows past the last real one (their starts clamped
    to it on the host) hold garbage here: NaN, inf and a bright level. The
    ensemble masks them by ``n_valid`` and ``nonoverlap`` drops their rows,
    so the rows do not change."""
    data, tn = setup
    rally, T = RALLIES[1]  # 9 frames: 7 windows (3 in nonoverlap) in chunks of 4
    te = _port(tn, eval_mode=eval_mode, exact_decode=exact_decode)
    want = rd.predict(te, data, rally, T)
    real = te._forward_cached
    padded = []

    def garbage(staged, starts):
        out = real(staged, starts).clone()
        pad = np.zeros(len(starts), bool)
        pad[1:] = starts[1:] == starts[:-1]  # clamped: a repeat of the last real start
        padded.append(int(pad.sum()))
        for i in np.flatnonzero(pad):
            out[i] = (float("nan"), float("inf"), 0.9)[i % 3]
        return out

    te._forward_cached = garbage
    got = rd.predict(te, data, rally, T)
    assert sum(padded) >= 1
    for k in ("cx", "cy", "bbox", "conf"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_staging_pads_with_the_last_frame_and_prestage_equals_lazy(setup):
    data, tn = setup
    rally, T = RALLIES[1]
    te = _port(tn, eval_mode="weight")
    cache = FrameCache(data, "concat", input_hw=(H, W))
    staged = te._stage_rally(cache, rd.rally_dir(data, rally), np.arange(T))
    rgb, _, med = cache.load(rd.rally_dir(data, rally))
    assert staged.T == T and staged.diff is None
    assert staged.rgb.dtype == torch.uint8 and staged.rgb.shape == (T + L - 1, H, W, 3)
    np.testing.assert_array_equal(staged.rgb[:T].numpy(), rgb)
    np.testing.assert_array_equal(staged.rgb[T:].numpy(), np.repeat(rgb[-1:], L - 1, axis=0))
    assert staged.median.dtype == torch.float32
    np.testing.assert_array_equal(staged.median.numpy(), med.astype(np.float32))

    lazy = te.predict_rally_heatmap(cache, rd.rally_dir(data, rally), np.arange(T))
    rally_dirs = [rd.rally_dir(data, r) for r, _ in RALLIES]
    assert te.prestage(data, rally_dirs, cache) == 2
    assert set(te._staged_rallies) == set(rally_dirs)
    again = te.predict_rally_heatmap(cache, rd.rally_dir(data, rally), np.arange(T))
    for k in lazy:
        np.testing.assert_array_equal(again[k], lazy[k])


def test_window_starts_are_checked_on_the_host(setup):
    data, tn = setup
    rally, T = RALLIES[1]
    te = _port(tn)
    staged = te._stage_rally(FrameCache(data, "concat", input_hw=(H, W)),
                             rd.rally_dir(data, rally), np.arange(T))
    te._forward_cached(staged, np.array([0, T - 1]))  # the last window fits the padding
    with pytest.raises(IndexError):
        te._forward_cached(staged, np.array([0, T]))
    with pytest.raises(IndexError):
        te._forward_cached(staged, np.array([-1]))


def test_engine_refuses_what_is_not_ported(setup):
    _, tn = setup
    with pytest.raises(TypeError, match="Mesh"):
        _port(tn, mesh=object())
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        _port(tn, mesh=make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="eval_mode"):
        _port(tn, eval_mode="median")


@pytest.mark.parametrize("eval_mode", MODES)
def test_a_mesh_gives_the_rows_of_one_device(setup, eval_mode):
    """Each chunk's windows split over a 2-entry CPU mesh: the rows of the
    engine without one, and a copy of the staged rally per entry."""
    data, tn = setup
    one, two = _port(tn, eval_mode=eval_mode), _port(tn, eval_mode=eval_mode,
                                                      mesh=make_mesh(2, device="cpu"))
    for rally, T in RALLIES:
        want, got = rd.predict(one, data, rally, T), rd.predict(two, data, rally, T)
        for k in ("cx", "cy", "bbox", "conf"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rally} {k}")
    staged = two._stage_rally(FrameCache(data, "concat", input_hw=(H, W)),
                              rd.rally_dir(data, RALLIES[1][0]), np.arange(RALLIES[1][1]))
    assert len(staged.replicas) == 2 and staged.replicas[0].rgb is staged.rgb
    assert one._stage_rally(FrameCache(data, "concat", input_hw=(H, W)),
                            rd.rally_dir(data, RALLIES[1][0]), np.arange(3)).replicas == ()
