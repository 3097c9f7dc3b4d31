"""The port stands alone: importing every module of ``tracknetv3_tpu_torch``
(the serving and kernel modules included) loads neither ``jax`` nor the JAX package,
no source of the port (nor ``chip_smoke.py``) imports them, and its entry
points (training, the predictor, ``predict_video``, ``predict_videos``, the
predict CLI with ``--video_file`` and ``--video_dir``, the rally engine and
the ``test``, ``generate_mask_data`` and ``preprocess`` CLIs, the rally
median) refuse to run without a card unless the CPU is asked for. The host
tools (dataset preparation, training's logs and samples, the web UIs, the
reference-checkpoint converter, which does no device work and so needs no
card) are among the modules checked."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tracknetv3_tpu_torch")


def _modules():
    names = ["tracknetv3_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="tracknetv3_tpu_torch."):
        names.append(info.name)
    return names


SERVING_MODULES = {
    "tracknetv3_tpu_torch.inference",
    "tracknetv3_tpu_torch.predict",
    "tracknetv3_tpu_torch.models.fused_forward",
    "tracknetv3_tpu_torch.models.inpaintnet",
    "tracknetv3_tpu_torch.ops.ensemble",
    "tracknetv3_tpu_torch.ops.pool_up2x",
    "tracknetv3_tpu_torch.ops.postprocess",
    # device resize, streaming, batch serving, the overlay video
    "tracknetv3_tpu_torch.ops.preprocess",
    "tracknetv3_tpu_torch.utils.io",
    "tracknetv3_tpu_torch.device",
    # the native libav decoder and the g++ build of the host libraries
    "tracknetv3_tpu_torch.native_video",
    "tracknetv3_tpu_torch.native_build",
}
KERNEL_MODULES = {
    "tracknetv3_tpu_torch.ops.batchnorm",
    "tracknetv3_tpu_torch.ops.conv3x3",
    "tracknetv3_tpu_torch.ops.pool_up2x",
    "tracknetv3_tpu_torch.ops.shift_copy",
    "tracknetv3_tpu_torch.ops.wbce_disk",
}
EVAL_MODULES = {  # rally evaluation
    "tracknetv3_tpu_torch.evaluation.test_engine",
    "tracknetv3_tpu_torch.evaluation.coco",
    "tracknetv3_tpu_torch.native_ccl",
    "tracknetv3_tpu_torch.test",
    "tracknetv3_tpu_torch.generate_mask_data",
}
INPUT_PATH_MODULES = {  # segmented, frame-mixup and device-resident batches
    "tracknetv3_tpu_torch.data.dataset",
    "tracknetv3_tpu_torch.data.frame_mixup",
    "tracknetv3_tpu_torch.training.steps",
}


HOST_TOOL_MODULES = {  # dataset preparation, training's logs and samples, the web UIs
    "tracknetv3_tpu_torch.preprocess",
    "tracknetv3_tpu_torch.convert_reference_checkpoint",
    "tracknetv3_tpu_torch.error_analysis",
    "tracknetv3_tpu_torch.correct_label",
    "tracknetv3_tpu_torch.tools",
    "tracknetv3_tpu_torch.tools.webui",
    "tracknetv3_tpu_torch.utils.visualize",
    "tracknetv3_tpu_torch.utils.images",
    "tracknetv3_tpu_torch.utils.profiling",
    "tracknetv3_tpu_torch.training.loop",
}


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) > 20
    assert (SERVING_MODULES | KERNEL_MODULES | INPUT_PATH_MODULES | EVAL_MODULES
            | HOST_TOOL_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tracknetv3_tpu' or m.startswith('tracknetv3_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+tracknetv3_tpu\b(?!_)|"
    r"from\s+tracknetv3_tpu(\.|\s)|.*\btracknetv3_tpu\.)", re.M
)


def test_no_source_refers_to_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu"))]
    offenders = []
    for f in files:
        with open(f, encoding="utf8") as fh:
            text = fh.read()
        code = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("#"))
        for m in _FORBIDDEN.finditer(code):
            line = m.group(0).strip()
            # docstrings may name the JAX sources the port mirrors; imports may not
            if line.startswith(("import", "from")):
                offenders.append((os.path.relpath(f, ROOT), line))
    assert not offenders, offenders


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from tracknetv3_tpu_torch.config import TrainConfig
    from tracknetv3_tpu_torch.device import resolve_device
    from tracknetv3_tpu_torch.training.loop import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(TrainConfig(save_dir=str(tmp_path)), str(tmp_path), verbose_print=str)
    assert resolve_device("cpu") == torch.device("cpu")

    from tracknetv3_tpu_torch import predict
    from tracknetv3_tpu_torch.inference import TrackNetPredictor, predict_video, predict_videos

    ckpt = str(tmp_path / "TrackNet_best.pt")  # the device is checked first
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrackNetPredictor(ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_video(str(tmp_path / "v.mp4"), ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--video_file", "v.mp4", "--tracknet_file", ckpt])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_video(str(tmp_path / "v.mp4"), ckpt, large_video=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_videos([str(tmp_path / "v.mp4")], ckpt)
    (tmp_path / "videos").mkdir()
    (tmp_path / "videos" / "v.mp4").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--video_dir", str(tmp_path / "videos"), "--tracknet_file", ckpt])

    from tracknetv3_tpu_torch import generate_mask_data, test
    from tracknetv3_tpu_torch.evaluation.test_engine import RallyTestEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RallyTestEngine(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test.main(["--tracknet_file", ckpt, "--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_mask_data.main(["--tracknet_file", ckpt, "--data_dir", str(tmp_path)])

    from tracknetv3_tpu_torch import preprocess
    from tracknetv3_tpu_torch.utils.io import get_rally_median

    data = tmp_path / "prep"
    data.mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.main(["--data_dir", str(data)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.main(["--data_dir", str(data), "--regenerate_medians"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_rally_median(str(data / "train" / "match1" / "video" / "1_01_00.mp4"))
    assert not os.listdir(data)  # refused before any step
    preprocess.main(["--data_dir", str(data), "--device", "cpu",  # an empty dataset
                     "--corrected_label_dir", str(tmp_path / "none")])
    assert os.listdir(data) == ["median_preview"]
