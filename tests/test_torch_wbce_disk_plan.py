"""What the WBCE forward kernel (K1) in ``tracknetv3_tpu_torch/csrc/wbce_disk.cu``
does that the card alone can run, rehearsed on the CPU.

- ``loss_plan``'s partition: one work item per row of every (sample, frame)
  plane, every item in exactly one warp's share, the shares within one row
  of each other, at the README shape (10, 8, 288, 512) and at odd ones;
  shapes no launch fits raise.
- The kernel's sum, modelled in numpy: the plain version's per-element
  terms, four of one float4 added in order, each lane's float4s of the row
  in order, the warp-shuffle tree in float per row, then the partials in
  double by the last block (thread t takes rows t, t + 256, ...; the block
  tree) and one division. It matches ``wbce_disk_loss_plain`` to 1e-6
  relative, and the model of the wrong forward that drops the last row's
  partial does not.
- The row-skip predicate (``label_row``: within sigma of a visible center's
  row, in float) never skips a row that holds a label pixel: centers on the
  plane's edges and corners, a (0, 0) "no ball" center, (0, y) and (x, 0)
  centers that are visible, both disks on one row, weights 0 and 1.
- The plan's field order and the kernel's constants agree with the source.

Nothing here runs JAX: the loss itself is held to the JAX package in
``tests/test_torch_wbce_disk.py``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu_torch.ops import cuda_build, losses  # noqa: E402
from tracknetv3_tpu_torch.ops import wbce_disk as wd  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tracknetv3_tpu_torch", "csrc", "wbce_disk.cu")
SMS = 132
SIGMA = 2.5
SHAPES = {"readme": (10, 8, 288, 512), "odd": (2, 3, 37, 20), "wide": (1, 2, 9, 2048),
          "fewer_rows_than_warps": (1, 1, 3, 8)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_partition_covers_every_row_once(name):
    B, L, H, W = SHAPES[name]
    plan = wd.loss_plan(B, L, H, W, SMS)
    assert plan.items == B * L * H and plan.threads == wd.THREADS
    shares = [plan.warp_items(gw) for gw in range(plan.grid * wd.WARPS)]
    np.testing.assert_array_equal(np.concatenate([np.array(r) for r in shares]),
                                  np.arange(plan.items))
    sizes = [len(r) for r in shares]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) >= 1
    assert plan.grid == min(SMS * wd.BLOCKS_PER_SM, -(-plan.items // wd.WARPS))
    # the partition depends on the shape alone; the cached plan is loss_plan's
    assert wd.loss_plan(B, L, H, W, 7).items == plan.items
    cached, arr = wd._plan_array(B, L, H, W, SMS)
    assert cached == plan and arr.tolist() == [plan.items, plan.grid, wd.THREADS]


def test_shapes_no_launch_fits_raise():
    for bad in ((1, 1, 8, 10), (0, 1, 8, 8), (1, 1, 0, 8)):
        with pytest.raises(ValueError):
            wd.loss_plan(*bad, SMS)
    assert wd.loss_plan(1, 1, 8, 4096, SMS).items == 8  # any row length that is a multiple of 4


# ------------------------------------------------------------ the kernel's sum


def _terms(z_bhwl, y_bhwl):
    """The plain version's per-element terms (``wbce_from_logits`` unreduced)."""
    p = torch.sigmoid(z_bhwl)
    log_p = torch.nn.functional.logsigmoid(z_bhwl).clamp_min(losses.LOG_FLOOR)
    log_1mp = torch.nn.functional.logsigmoid(-z_bhwl).clamp_min(losses.LOG_FLOOR)
    return -((1.0 - p).square() * y_bhwl * log_p + p.square() * (1.0 - y_bhwl) * log_1mp)


def _shfl_tree(v):
    """The fixed warp-shuffle tree on the last axis (32 lanes); lane 0's sum.
    __shfl_down_sync past the last lane returns the lane's own value."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        shifted = np.concatenate([v[..., o:], v[..., 32 - o:]], axis=-1)
        v = v + shifted
    return v[..., 0]


def _block_sum(v):
    """block_sum over the last axis (THREADS): per-warp trees, then warp 0's."""
    warps = _shfl_tree(v.reshape(v.shape[:-1] + (wd.THREADS // 32, 32)))
    lanes = np.zeros(v.shape[:-1] + (32,), v.dtype)
    lanes[..., :wd.THREADS // 32] = warps
    return _shfl_tree(lanes)


def _k1_model(terms_blhw, drop_last=False):
    """K1's per-row partials and loss from per-element terms (B, L, H, W)."""
    B, L, H, W = terms_blhw.shape
    W4 = W // 4
    t = terms_blhw.reshape(B * L * H, W4, 4)  # row, float4 q, lane of the float4
    s4 = t[..., 0].copy()
    for k in (1, 2, 3):
        s4 = s4 + t[..., k]
    steps = -(-W4 // 32)  # lane l takes q = l, l + 32, ... in order
    s4 = np.concatenate([s4, np.zeros((B * L * H, steps * 32 - W4), np.float32)], axis=1)
    s4 = s4.reshape(B * L * H, steps, 32)
    acc = np.zeros((B * L * H, 32), np.float32)
    for k in range(steps):
        acc = acc + s4[:, k]
    partials = _shfl_tree(acc).astype(np.float32)
    if drop_last:
        partials[-1] = 0.0
    n_strided = -(-partials.size // wd.THREADS) * wd.THREADS
    p64 = np.zeros(n_strided, np.float64)
    p64[:partials.size] = partials
    per_thread = np.zeros(wd.THREADS, np.float64)
    for k in range(n_strided // wd.THREADS):  # thread t: rows t, t + 256, ... in order
        per_thread = per_thread + p64[k * wd.THREADS:(k + 1) * wd.THREADS]
    total = _block_sum(per_thread[None])[0]
    return partials, np.float32(total / (B * L * H * W))


def _targets(B, L, H, W, seed):
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, W, (B, 2, L))
    cy = rng.integers(0, H, (B, 2, L))
    cx[0, :, 0] = cy[0, :, 0] = 0  # no ball
    cxcy2 = torch.from_numpy(np.stack([cx, cy], axis=2).astype(np.int32))  # (B, 2, 2, L)
    w = torch.from_numpy(rng.uniform(0.0, 1.0, (B, 1, L)).astype(np.float32))
    return cxcy2, w


def _label_row_np(cxcy2, H, sigma=SIGMA):
    """label_row for every (b, l, row): (B, L, H) bool, in float32 as the kernel."""
    c = cxcy2.numpy().astype(np.float32)
    r = np.arange(H, dtype=np.float32)
    s2 = np.float32(sigma) * np.float32(sigma)
    near = np.zeros((c.shape[0], c.shape[-1], H), bool)
    for k in (0, 1):
        cx, cy = c[:, k, 0], c[:, k, 1]
        d = (r[None, None, :] - cy[..., None]).astype(np.float32)
        near |= (((cx != 0) | (cy != 0))[..., None]) & (d * d <= s2)
    return near


@pytest.mark.parametrize("name", ["readme", "odd", "wide"])
def test_model_of_the_sum_matches_plain(name):
    B, L, H, W = SHAPES[name]
    rng = np.random.default_rng(3)
    z = torch.from_numpy((rng.standard_normal((B, H, W, L)) * 8).astype(np.float32))
    cxcy2, w = _targets(B, L, H, W, seed=4)
    y = wd.disk_labels_plain(cxcy2, w, H, W, SIGMA)  # (B, H, W, L)
    want = float(wd.wbce_disk_loss_plain(z, cxcy2, w, SIGMA))
    # skipped rows take y = 0, as the kernel's loss_term_y0
    keep = torch.from_numpy(_label_row_np(cxcy2, H)).permute(0, 2, 1)[:, :, None, :]  # (B,H,1,L)
    assert float((y * ~keep).abs().sum()) == 0.0
    terms = _terms(z, y * keep).permute(0, 3, 1, 2).contiguous().numpy()  # (B, L, H, W)
    assert float(torch.from_numpy(terms).double().mean()) == pytest.approx(want, rel=1e-6)
    partials, got = _k1_model(terms)
    assert partials.shape == (wd.loss_plan(B, L, H, W, SMS).items,)
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    if name == "readme":  # a row's partial dropped is outside the bound
        _, wrong = _k1_model(terms, drop_last=True)
        assert abs(float(wrong) - want) > 1e-5 * abs(want)


# ------------------------------------------------------------ the row skip

_H, _W = 36, 64
PREDICATE_CASES = {
    "top_left_corner_visible": ((0, 1), (0, 1), 1.0),
    "left_edge": ((0, 17), (63, 17), 0.5),
    "top_edge": ((30, 0), (5, 0), 0.25),
    "bottom_right_corner": ((63, 35), (63, 35), 1.0),
    "bottom_edge_both_disks_one_row": ((10, 35), (50, 35), 0.5),
    "no_ball_a": ((0, 0), (20, 10), 0.5),
    "no_ball_both": ((0, 0), (0, 0), 1.0),
    "wa_zero": ((20, 3), (40, 30), 0.0),
    "wa_one": ((20, 3), (40, 30), 1.0),
    "same_row_overlapping": ((30, 20), (32, 20), 0.3),
}


@pytest.mark.parametrize("name", sorted(PREDICATE_CASES))
def test_row_skip_never_skips_a_label_row(name):
    (ax, ay), (bx, by), wa = PREDICATE_CASES[name]
    cxcy2 = torch.tensor([[[[ax], [ay]], [[bx], [by]]]], dtype=torch.int32)  # (1, 2, 2, 1)
    w = torch.tensor([[[wa]]], dtype=torch.float32)
    y = wd.disk_labels_plain(cxcy2, w, _H, _W, SIGMA)[0, :, :, 0].numpy()  # (H, W)
    keep = _label_row_np(cxcy2, _H)[0, 0]
    holds = (y != 0).any(axis=1)
    assert not (holds & ~keep).any(), f"rows {np.nonzero(holds & ~keep)[0]} skipped"
    # and it skips: at most 2 * (2 * 2 + 1) rows of 36 can be kept
    visible = [(x, yy) != (0, 0) for x, yy in ((ax, ay), (bx, by))]
    assert keep.sum() <= 5 * sum(visible)
    if any(visible):
        assert keep.any()


def test_constants_and_plan_fields_match_the_source():
    with open(SOURCE) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] == wd.THREADS and consts["kBlocksPerSM"] == wd.BLOCKS_PER_SM
    assert "__launch_bounds__(kThreads, kBlocksPerSM)" in src
    enum = re.search(r"enum Plan \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == ["P_" + f.upper() for f in wd.PLAN_FIELDS] + ["P_LEN"]
