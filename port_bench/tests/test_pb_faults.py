"""A run with the timed path broken underneath comes out not correct: the
runners run on the CPU at a tiny size (no look for a card) with one fault
planted in the program, for each fault a cell can have; one chip, so no
exchange between chips to leave out."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell

SEED = 2**31 + 99


def _correct(rec) -> bool:
    return rec.failed == 0 and bool(rec.checks) and all(c.ok for c in rec.checks)


def _serve(tmp_path, config="tracknetv3"):
    from benchkit import serve_clips

    # a short window still serves and checks every sampled clip
    rec = serve_clips.run(tiny_cell(config, "rally_clips"), SEED, 0.5, False, "cpu",
                          str(tmp_path), time.perf_counter())
    assert rec.notes["checked_clips"] == rec.notes["sampled_clips"] >= 1
    return rec


def _failed(rec, name) -> bool:
    """``name`` read a number, and the number fails its limit."""
    c = {c.name: c for c in rec.checks}[name]
    return c.value != float("inf") and not c.ok


def _train(tmp_path, traffic="train_readme"):
    from benchkit import train_steps

    cell = tiny_cell("tracknetv3", traffic, head_grad_diff=0.1)
    return train_steps.run(cell, SEED, 1.0, False, "cpu", str(tmp_path), time.perf_counter(),
                           data_root=str(tmp_path))


def test_sound_runs_are_correct(tmp_path):
    assert _correct(_serve(tmp_path)) and _correct(_train(tmp_path))


def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    """The decode moves one frame's detection by 10 pixels."""
    import tracknetv3_tpu_torch.inference as inference

    decode = inference.decode_heatmaps

    def altered(probs, *a, **k):
        out = decode(probs, *a, **k)
        out["cx"] = out["cx"].clone()
        out["cx"].view(-1)[0] += 10
        return out

    monkeypatch.setattr(inference, "decode_heatmaps", altered)
    rec = _serve(tmp_path)
    assert not _correct(rec)
    assert dict((c.name, c.value) for c in rec.checks)["rows_off"] >= 1


@pytest.mark.parametrize("config", ["tracknetv3", "tracknetv2"])
def test_half_of_each_batch_left_out(tmp_path, monkeypatch, config):
    """The forward's second half of each chunk's windows comes back empty."""
    import tracknetv3_tpu_torch.inference as inference

    forward = inference.tracknet_fused_forward

    def halved(params, x, **k):
        out = forward(params, x, **k).clone()
        out[x.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(inference, "tracknet_fused_forward", halved)
    rec = _serve(tmp_path, config)
    assert not _correct(rec) and _failed(rec, "prob_gap"), rec.checks


def test_the_ensemble_in_a_lower_precision(tmp_path, monkeypatch):
    """The ensembled frame maps rounded to bfloat16 where they are made."""
    import tracknetv3_tpu_torch.inference as inference

    update = inference.ensemble_update_fn

    def rounded(*a, **k):
        state, frames = update(*a, **k)
        return state, frames.to(torch.bfloat16).to(frames.dtype)

    monkeypatch.setattr(inference, "ensemble_update_fn", rounded)
    rec = _serve(tmp_path)
    assert not _correct(rec) and _failed(rec, "frame_gap"), rec.checks


def test_inpaintnet_in_a_lower_precision(tmp_path, monkeypatch):
    """InpaintNet's output rounded to bfloat16 where it is made."""
    from tracknetv3_tpu_torch.models.inpaintnet import InpaintNet

    forward = InpaintNet.forward
    monkeypatch.setattr(InpaintNet, "forward",
                        lambda self, *a: forward(self, *a).to(torch.bfloat16).float())
    rec = _serve(tmp_path)
    assert not _correct(rec) and _failed(rec, "inpaint_gap"), rec.checks


def test_a_step_that_leaves_the_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    rec = _train(tmp_path)
    nums = {c.name: c.value for c in rec.checks}
    assert not _correct(rec) and nums["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("traffic", ["train_readme", "train_resident"])
def test_half_of_the_batch_left_out_of_the_loss(tmp_path, monkeypatch, traffic):
    """The loss is the mean over the batch's first half."""
    import tracknetv3_tpu_torch.training.steps as steps

    loss = steps.wbce_disk_loss

    def half(logits, cxcy2, w, *a):
        b = logits.shape[0] // 2
        return loss(logits[:b], cxcy2[:b], w[:b], *a)

    monkeypatch.setattr(steps, "wbce_disk_loss", half)
    rec = _train(tmp_path, traffic)
    assert not _correct(rec), rec.checks
