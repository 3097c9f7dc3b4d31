"""The port's dataset preparation (``python -m tracknetv3_tpu_torch.preprocess
--device cpu``) against the JAX package's root ``preprocess.py`` on two
copies of one seeded dataset: 64x36 mp4v videos of 12-20 frames written
with cv2, label CSVs (one rally with fewer labels than frames, one with
more), corrected labels in both layouts, a match of a single rally.

- Both trees hold the same files afterwards; the PNG frames and median
  previews, the CSVs, the JSON and the videos are equal byte for byte, and
  every ``median.npz`` array is equal bit for bit (dtype, shape, bytes).
- The same after ``--regenerate_medians`` (medians over every frame of
  each video, which differ from the extraction-time ones on the rally with
  fewer labels than frames).
- The port takes each rally median over the uint8 frames (no float32
  stack on the host), and ``get_match_median`` raises on a match with no
  rally dirs.
"""

import csv
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores
cv2 = pytest.importorskip("cv2")

from tracknetv3_tpu_torch import preprocess as port_preprocess  # noqa: E402
from tracknetv3_tpu_torch.ops import preprocess as port_ops  # noqa: E402
from tracknetv3_tpu_torch.utils import io as port_io  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 36

# (split, match, rally, frames in the video, label rows)
RALLIES = [
    ("train", 1, "1_01_00", 16, 16),
    ("train", 1, "1_02_00", 20, 14),  # fewer labels than frames: capped
    ("train", 1, "1_03_00", 12, 12),
    ("train", 2, "1_01_00", 14, 18),  # more labels than frames; a single rally
    ("test", 1, "1_01_00", 12, 12),
    ("test", 3, "1_01_00", 13, 13),
]


def _write_rally(root, split, match, rally, n_frames, n_labels, rng):
    match_dir = os.path.join(root, split, f"match{match}")
    for sub in ("video", "csv"):
        os.makedirs(os.path.join(match_dir, sub), exist_ok=True)
    bg = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    vw = cv2.VideoWriter(os.path.join(match_dir, "video", f"{rally}.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for t in range(n_frames):
        frame = bg.copy()
        x, y = 4 + 3 * t, 6 + (t * 7) % 24
        cv2.circle(frame, (x, y), 3, (255, 255, 255), -1)
        vw.write(frame)
    vw.release()
    with open(os.path.join(match_dir, "csv", f"{rally}_ball.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Frame", "Visibility", "X", "Y"])
        w.writerows([t, 1, 4 + 3 * t, 6 + (t * 7) % 24] for t in range(n_labels))


def _write_corrected(cl_dir, rng):
    """Corrected labels in the reference layout (``match1/corrected_csv``)
    and flat (``3_1_01_00_ball.csv`` -> test/match3), and drop_frame.json."""
    os.makedirs(os.path.join(cl_dir, "match1", "corrected_csv"))
    rows = [[t, 1, int(rng.integers(0, W)), int(rng.integers(0, H))] for t in range(12)]
    for path in (os.path.join(cl_dir, "match1", "corrected_csv", "1_01_00_ball.csv"),
                 os.path.join(cl_dir, "3_1_01_00_ball.csv")):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Frame", "Visibility", "X", "Y"])
            w.writerows(rows)
    with open(os.path.join(cl_dir, "drop_frame.json"), "w") as f:
        f.write('{"start": {"1_1_01_00": 2}, "end": {"1_1_01_00": 10}}')


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep")
    rng = np.random.default_rng(0)
    for split, match, rally, n_frames, n_labels in RALLIES:
        _write_rally(str(root / "data"), split, match, rally, n_frames, n_labels, rng)
    _write_corrected(str(root / "corrected"), rng)
    return root


def _run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["preprocess.py"] + list(argv))
    runpy.run_path(os.path.join(ROOT, "preprocess.py"), run_name="__main__")


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return out


def _assert_trees_equal(got_root, want_root):
    got, want = _files(got_root), _files(want_root)
    assert got == want, (sorted(got - want), sorted(want - got))
    assert any(f.endswith(".png") for f in want) and any(f.endswith(".npz") for f in want)
    for rel in sorted(want):
        g, w = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith(".npz"):
            with np.load(g) as zg, np.load(w) as zw:
                assert sorted(zg.files) == sorted(zw.files), rel
                for k in zw.files:
                    a, b = zg[k], zw[k]
                    assert a.dtype == b.dtype and a.shape == b.shape, (rel, k)
                    assert np.ascontiguousarray(a).tobytes() == \
                        np.ascontiguousarray(b).tobytes(), (rel, k)
        else:
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read(), rel


def test_preprocess_tree_matches_jax(dataset, tmp_path, monkeypatch):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(str(dataset / "data"), jax_dir)
    shutil.copytree(str(dataset / "data"), port_dir)
    cl = str(dataset / "corrected")

    seen = []
    real = port_ops.median_of_host_frames
    monkeypatch.setattr(port_ops, "median_of_host_frames",
                        lambda frames, dev: seen.append(frames.dtype) or real(frames, dev))

    _run_jax(["--data_dir", jax_dir, "--corrected_label_dir", cl], monkeypatch)
    port_preprocess.main(["--data_dir", port_dir, "--corrected_label_dir", cl,
                          "--device", "cpu"])
    _assert_trees_equal(port_dir, jax_dir)
    assert seen == [np.uint8] * len(RALLIES)
    # the steps ran: capped extraction, corrected labels in both layouts,
    # the val carve (the single-rally match stays), the previews
    frames = os.path.join(port_dir, "train", "match1", "frame", "1_02_00")
    assert len([f for f in os.listdir(frames) if f.endswith(".png")]) == 14
    assert os.path.isdir(os.path.join(port_dir, "val", "match1", "frame", "1_03_00"))
    assert not os.path.exists(os.path.join(port_dir, "val", "match2"))
    for m in (1, 3):
        assert os.path.exists(os.path.join(port_dir, "test", f"match{m}", "corrected_csv",
                                           "1_01_00_ball.csv"))
    assert os.path.exists(os.path.join(port_dir, "drop_frame.json"))
    assert os.path.exists(os.path.join(port_dir, "median_preview", "val_match1.png"))

    # --regenerate_medians: every rally and match median from the videos
    before = np.load(os.path.join(frames, "median.npz"))["median"]
    seen.clear()
    _run_jax(["--data_dir", jax_dir, "--regenerate_medians"], monkeypatch)
    port_preprocess.main(["--data_dir", port_dir, "--regenerate_medians", "--device", "cpu"])
    _assert_trees_equal(port_dir, jax_dir)
    assert seen == [np.uint8] * len(RALLIES)
    after = np.load(os.path.join(frames, "median.npz"))["median"]
    assert not np.array_equal(before, after)  # 20 frames now, not the 14 labelled


def test_get_match_median_empty_match_raises(tmp_path):
    match = tmp_path / "train" / "match1"
    os.makedirs(match / "frame")
    with pytest.raises(ValueError, match="no rally frame dirs"):
        port_io.get_match_median(str(match), device="cpu")
