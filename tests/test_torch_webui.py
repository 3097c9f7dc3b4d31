"""The port's error-analysis / label-correction web UI
(``tracknetv3_tpu_torch.tools.webui``): the five cases of
``tests/test_webui.py`` against the port's ``make_handler``, and the port's
and the JAX package's handlers serving the same analysis files side by side
(port 0): every GET body equal byte for byte (the page, the JSON endpoints,
the FP1/FP2 histogram PNG, a frame, the 404s), and the ``corrected_csv``
that a POST writes equal byte for byte."""

import csv
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest

from tracknetv3_tpu.tools.webui import make_handler as jax_make_handler
from tracknetv3_tpu_torch.tools.webui import make_handler


def _analysis(seed, gt=True):
    rng = np.random.default_rng(seed)
    n = 12
    rally = {
        "Frame": list(range(n)),
        "X": rng.integers(0, 100, n).tolist(),
        "Y": rng.integers(0, 100, n).tolist(),
        "Visibility": [1] * n,
        "Type": rng.integers(0, 5, n).tolist(),
    }
    if gt:
        rally.update(X_GT=rng.integers(0, 100, n).tolist(),
                     Y_GT=rng.integers(0, 100, n).tolist(), Visibility_GT=[1] * n)
    return {"pred_dict": {"1_1_00_00": rally}}


def _write_label_csv(path, rows, note=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Frame", "Visibility", "X", "Y"] + (["Note"] if note else []))
        for i, r in enumerate(rows):
            w.writerow(list(r) + ([note[i]] if note else []))


def _serve(handler):
    srv = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


@pytest.fixture()
def server(tmp_path):
    a1 = tmp_path / "a1.json"
    a2 = tmp_path / "a2.json"
    a1.write_text(json.dumps(_analysis(1)))
    a2.write_text(json.dumps(_analysis(2)))
    data_dir = tmp_path / "data"
    os.makedirs(data_dir)
    (data_dir / "drop_frame.json").write_text(
        json.dumps({"start": {"1_1_00_00": 2}, "end": {"1_1_00_00": 9}})
    )
    srv, base = _serve(make_handler(str(a1), str(a2), data_dir=str(data_dir)))
    yield base
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req) as r:
        return r.status, r.read()


def test_two_result_endpoints(server):
    status, body = _get(f"{server}/")
    assert status == 200 and b"strip2" in body and b"diff" in body
    for ep in ("analysis.json", "analysis2.json", "labels.json", "dropframe.json"):
        status, body = _get(f"{server}/{ep}")
        assert status == 200, ep
        json.loads(body)
    _, drop = _get(f"{server}/dropframe.json")
    assert json.loads(drop)["start"]["1_1_00_00"] == 2
    _, lbls = _get(f"{server}/labels.json")
    assert json.loads(lbls) == ["a1.json", "a2.json"]


def test_diff_hist_renders_png(server):
    status, body = _get(f"{server}/diff_hist.png")
    assert status == 200
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


def test_single_result_404s_second(tmp_path):
    a1 = tmp_path / "a1.json"
    a1.write_text(json.dumps(_analysis(1)))
    srv, base = _serve(make_handler(str(a1), None, data_dir=str(tmp_path)))
    try:
        assert _get(f"{base}/analysis.json")[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            _get(f"{base}/analysis2.json")
    finally:
        srv.shutdown()


def _corrected_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_correct_label_write_path(tmp_path):
    """Label-correction POST applies clicked corrections to the rally CSV
    (reference contract: correct_label.py:187-206)."""
    a1 = tmp_path / "a1.json"
    a1.write_text(json.dumps(_analysis(1)))
    data_dir = tmp_path / "data"
    os.makedirs(data_dir / "test" / "match1" / "frame" / "1_00_00")
    _write_label_csv(str(data_dir / "test" / "match1" / "csv" / "1_00_00_ball.csv"),
                     [(i, 1, 9, 9) for i in range(5)])
    srv, base = _serve(make_handler(str(a1), None, data_dir=str(data_dir), correct_mode=True))
    try:
        status, _ = _post(f"{base}/write", {"rally": "1_1_00_00", "corrections": {"2": [42, 17]}})
        assert status == 200
        rows = _corrected_rows(data_dir / "test" / "match1" / "corrected_csv" / "1_00_00_ball.csv")
        row = next(r for r in rows if r["Frame"] == "2")
        assert (row["X"], row["Y"], row["Visibility"]) == ("42", "17", "1")
        assert next(r for r in rows if r["Frame"] == "1")["X"] == "9"  # untouched rows intact
    finally:
        srv.shutdown()


def test_correct_label_preserves_extra_columns(tmp_path):
    """Corrections must not destroy non-numeric annotation columns: the
    pandas-free CSV path keeps unparseable cells verbatim."""
    a1 = tmp_path / "a1.json"
    a1.write_text(json.dumps(_analysis(1)))
    data_dir = tmp_path / "data"
    os.makedirs(data_dir / "test" / "match1" / "frame" / "1_00_00")
    _write_label_csv(str(data_dir / "test" / "match1" / "csv" / "1_00_00_ball.csv"),
                     [(i, 1, 9, 9) for i in range(4)], note=["serve", "rally", "", "smash"])
    srv, base = _serve(make_handler(str(a1), None, data_dir=str(data_dir), correct_mode=True))
    try:
        status, _ = _post(f"{base}/write", {"rally": "1_1_00_00", "corrections": {"1": [50, 60]}})
        assert status == 200
        rows = _corrected_rows(data_dir / "test" / "match1" / "corrected_csv" / "1_00_00_ball.csv")
        # blank -> 0 mirrors the pandas reader's fillna(0)
        assert [r["Note"] for r in rows] == ["serve", "rally", "0", "smash"]
        row = next(r for r in rows if r["Frame"] == "1")
        assert (row["X"], row["Y"]) == ("50", "60")
    finally:
        srv.shutdown()


def _dataset(root, rng):
    """A test match with a rally's frames, label CSV (rows out of order,
    a blank cell and a note column) and drop_frame.json."""
    import cv2

    frame_dir = os.path.join(root, "test", "match1", "frame", "1_00_00")
    os.makedirs(frame_dir)
    for i in range(3):
        cv2.imwrite(os.path.join(frame_dir, f"{i}.png"),
                    rng.integers(0, 256, (18, 32, 3), dtype=np.uint8))
    rows = [(i, 1, int(rng.integers(0, 100)), int(rng.integers(0, 100))) for i in range(12)]
    rows = rows[6:] + rows[:6]
    rows[2] = (rows[2][0], 1, "", rows[2][3])
    _write_label_csv(os.path.join(root, "test", "match1", "csv", "1_00_00_ball.csv"), rows,
                     note=["n%d" % i for i in range(12)])
    with open(os.path.join(root, "drop_frame.json"), "w") as f:
        json.dump({"start": {"1_1_00_00": 1}, "end": {"1_1_00_00": 10}}, f)


GETS = ["/", "/index.html", "/analysis.json", "/analysis2.json", "/labels.json",
        "/dropframe.json", "/diff_hist.png", "/frame?rally=1_1_00_00&i=1",
        "/frame?rally=1_1_00_00&i=7", "/frame?rally=1_..%2F..&i=0", "/nope"]


def _body(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("correct_mode", [False, True])
def test_port_and_jax_handlers_serve_the_same_bytes(tmp_path, correct_mode):
    a1 = tmp_path / "a1.json"
    a2 = tmp_path / "a2.json"
    a1.write_text(json.dumps(_analysis(3)))
    a2.write_text(json.dumps(_analysis(4, gt=False)))  # its GT comes from the label CSV
    _dataset(str(tmp_path / "data"), np.random.default_rng(7))
    shutil.copytree(tmp_path / "data", tmp_path / "data_jax")
    a2_arg = None if correct_mode else str(a2)
    servers = [
        _serve(make_handler(str(a1), a2_arg, data_dir=str(tmp_path / "data"),
                            correct_mode=correct_mode)),
        _serve(jax_make_handler(str(a1), a2_arg, data_dir=str(tmp_path / "data_jax"),
                                correct_mode=correct_mode)),
    ]
    try:
        (_, got_base), (_, want_base) = servers
        for path in GETS:
            got, want = _body(got_base + path), _body(want_base + path)
            assert got == want, path
        assert _body(got_base + "/diff_hist.png")[0] == (404 if correct_mode else 200)
        if correct_mode:
            payload = {"rally": "1_1_00_00", "corrections": {"3": [12, 34], "99": [1, 1]}}
            got, want = _post(got_base + "/write", payload), _post(want_base + "/write", payload)
            assert got[0] == want[0] == 200
            assert got[1].replace(b"data/", b"data_jax/") == want[1]
            rel = os.path.join("test", "match1", "corrected_csv", "1_00_00_ball.csv")
            with open(tmp_path / "data" / rel, "rb") as g, \
                    open(tmp_path / "data_jax" / rel, "rb") as w:
                got_csv = g.read()
                assert got_csv == w.read()
            assert b"12,34" in got_csv
    finally:
        for srv, _ in servers:
            srv.shutdown()
