"""The synchronised BatchNorm + ReLU over shares (``ops/batchnorm.py``
``split_bn_relu_train``) against the unsplit op on the CPU, where both run
their plain versions (``chip_smoke.py`` holds the split kernels to the same
plain versions on the card), and the traps of data-parallel BatchNorm.

- The split plain versions (sums, then a finalize) compose to the unsplit
  ones bit for bit, in bfloat16, float32 and float64; the split normalise
  (``bn_relu_fwd_split``) is the forward's finalize and normalise in one
  op.
- The op over 1, 2 and 4 shares of one batch against ``bn_relu_train`` on
  the whole batch, in float64, with a constant channel (variance 0, so
  ``z == 0``: the ReLU's tie passes half the gradient): at one share of a
  one-entry mesh every bit equal (output, input gradient, ``dgamma``,
  ``dbeta``, running statistics); over 2 and 4 shares of a CPU mesh within
  1e-12 relative, the running statistics updated once from the global
  moments.
- The layer's op, ``sync_bn_relu_train``, runs the unsplit op where one
  share of one process is the whole batch (the one-device train step), and
  the split op over several shares or processes.
- Wrong versions fail those bounds: a split normalise with each share's own
  statistics (its own sums over its own rows; the running statistics then
  move with the first share's moments), ``dgamma`` / ``dbeta`` from the
  summed sums (counted W times once autograd sums the shares), and, in the
  whole float64 train step of ``test_torch_dp_steps.py``, those two and a
  mixup partner drawn inside the share.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from unittest import mock  # noqa: E402

from torch_dp_data import (  # noqa: E402
    crossing_mixup,
    run_tracknet,
    tracknet_batch,
    tracknet_model,
    worst,
)
from tracknetv3_tpu_torch.ops import batchnorm as bnm  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import Reducer, make_mesh, mesh_reducer  # noqa: E402
from tracknetv3_tpu_torch.training import steps  # noqa: E402

N, H, W, C = 8, 8, 16, 16  # 1024 rows; shares of 4, 2 images
CONST = 5  # a channel of one value: variance 0 and a ReLU tie


def _data(seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, H, W, C)) * rng.uniform(0.5, 2.0, C) + rng.uniform(-3, 3, C)
    y[..., CONST] = 3.0
    g = rng.standard_normal((N, H, W, C))
    gamma, beta = rng.uniform(0.5, 1.5, C), rng.uniform(-0.5, 0.5, C)
    beta[CONST] = 0.0
    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype).contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    vec = lambda a: torch.from_numpy(a).to(torch.promote_types(dtype, torch.float32))  # noqa: E731
    return cl(y), cl(g), vec(gamma), vec(beta)


def _unsplit(y, g, gamma, beta):
    y, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    out = bnm.bn_relu_train(y, w, b, rm, rv)
    dy, dw, db = torch.autograd.grad(out, (y, w, b), g)
    return dict(out=out.detach(), dy=dy, dgamma=dw, dbeta=db, rm=rm, rv=rv)


def _over_shares(y, g, gamma, beta, shares, reducer, op=None, ops=None):
    op = op or bnm.split_bn_relu_train
    y, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    ys = list(y.split(N // shares))
    outs = op(ys, [w] * shares, [b] * shares, rm, rv, reducer, ops=ops)
    # autograd sums the shares' dgamma and dbeta on the one weight and bias
    dy, dw, db = torch.autograd.grad(outs, (y, w, b), list(g.split(N // shares)))
    return dict(out=torch.cat([o.detach() for o in outs]), dy=dy, dgamma=dw, dbeta=db, rm=rm,
                rv=rv)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_split_plain_versions_compose_to_the_unsplit_ones(dtype):
    y, g, gamma, beta = _data(1, dtype)
    rm1, rv1 = torch.zeros(C), torch.ones(C)
    rm2, rv2 = torch.zeros(C), torch.ones(C)
    if dtype == torch.float64:
        rm1, rv1, rm2, rv2 = (t.double() for t in (rm1, rv1, rm2, rv2))
    st = bnm.bn_stats_plain(y, gamma, rm1, rv1)
    sums = bnm.bn_stats_sums_plain(y)
    assert sums.dtype == torch.float64 and sums.shape == (2, C)
    sd = torch.promote_types(dtype, torch.float32)
    assert torch.equal(bnm.bn_stats_finalize_plain(sums, N * H * W, gamma, rm2, rv2, sd), st)
    assert torch.equal(rm1, rm2) and torch.equal(rv1, rv2)
    want = bnm.bn_relu_bwd_reduce_plain(g, y, st, beta, True)
    bsums = bnm.bn_relu_bwd_sums_plain(g, y, st, beta)
    got = bnm.bn_relu_bwd_finalize_plain(bsums, bsums, N * H * W, st, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shares", [1, 2, 4])
def test_sync_op_over_shares_matches_the_unsplit_op(shares):
    y, g, gamma, beta = _data()
    want = _unsplit(y, g, gamma, beta)
    got = _over_shares(y, g, gamma, beta, shares, mesh_reducer(make_mesh(shares, device="cpu")))
    # the tie is there: z == 0 on the constant channel, half the gradient passes
    assert torch.all(want["out"][:, CONST] == 0)
    assert torch.all(want["dy"][:, CONST] != 0)
    for k in want:
        if shares == 1:
            assert torch.equal(got[k], want[k]), k
        else:
            assert _rel(got[k], want[k]) <= 1e-12, (k, _rel(got[k], want[k]))


def _each_share_its_own(y, weight, bias, total, n, running_mean=None, running_var=None):
    """The wrong split normalise: the share's own sums over its own rows."""
    return bnm.bn_relu_fwd_split(y, weight, bias, bnm.bn_stats_sums(y), bnm._rows(y),
                                 running_mean, running_var)


def _dgamma_from_the_total(g, y, st, bias, local, total, n):
    return bnm.bn_relu_bwd_apply_split_plain(g, y, st, bias, total, total, n)


def test_wrong_sync_ops_fail_the_bound():
    y, g, gamma, beta = _data()
    want = _unsplit(y, g, gamma, beta)
    reducer = mesh_reducer(make_mesh(2, device="cpu"))
    own = _over_shares(y, g, gamma, beta, 2, reducer,
                       ops=bnm.SPLIT_PLAIN_OPS._replace(fwd=_each_share_its_own))
    assert _rel(own["out"], want["out"]) > 1e-3
    assert _rel(own["rm"], want["rm"]) > 1e-3  # moved from the first share's mean
    total = _over_shares(y, g, gamma, beta, 2, reducer,
                         ops=bnm.SPLIT_PLAIN_OPS._replace(bwd_apply=_dgamma_from_the_total))
    assert torch.equal(total["out"], want["out"]) or _rel(total["out"], want["out"]) <= 1e-12
    assert _rel(total["dgamma"], 2 * want["dgamma"]) <= 1e-12  # counted twice
    assert _rel(total["dbeta"], 2 * want["dbeta"]) <= 1e-12


def test_mesh_reducer_sums_in_share_order_on_each_entry():
    parts = [torch.full((2, 3), v, dtype=torch.float64) for v in (1e16, 1.0, -1e16)]
    totals = mesh_reducer(make_mesh(3, device="cpu")).sum(parts)
    assert len(totals) == 3 and all(t is totals[0] for t in totals)
    # ((1e16 + 1) - 1e16) in float64: the order of the shares
    assert torch.equal(totals[0], (parts[0] + parts[1]) + parts[2])
    one = mesh_reducer(make_mesh(1, device="cpu"))
    assert one.sum(parts[:1])[0] is parts[0] and one.processes == 1


@pytest.mark.parametrize("shares,processes,split", [(1, 1, False), (2, 1, True), (1, 2, True)])
def test_the_layer_op_splits_only_across_shares_or_processes(shares, processes, split):
    y, g, gamma, beta = _data()
    calls = []

    def record(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    total = Reducer(lambda parts: [p.clone() for p in parts], processes)
    with mock.patch.object(bnm, "bn_relu_train", record("unsplit", bnm.bn_relu_train)), \
            mock.patch.object(bnm, "split_bn_relu_train",
                              record("split", bnm.split_bn_relu_train)):
        outs = bnm.sync_bn_relu_train(list(y.split(N // shares)), [gamma] * shares,
                                      [beta] * shares, torch.zeros(C, dtype=y.dtype),
                                      torch.ones(C, dtype=y.dtype), total)
    assert calls == (["split"] if split else ["unsplit"]) and len(outs) == shares


def test_split_kernel_wrappers_check_their_sums():
    for bad in (torch.zeros(2, C), torch.zeros(3, C, dtype=torch.float64),
                torch.zeros(2, C + 1, dtype=torch.float64)):
        with pytest.raises(ValueError, match="sums must be"):
            bnm._check_sums(bad, C, torch.device("cpu"))
    bnm._check_sums(torch.zeros(2, C, dtype=torch.float64), C, torch.device("cpu"))
    assert {"bn_stats_sums", "bn_relu_fwd_split", "bn_relu_bwd_sums",
            "bn_relu_bwd_apply_split"} <= set(bnm.LAUNCHES)
    assert "bn_relu_bwd_finalize" not in bnm.LAUNCHES  # folded into the split apply
    assert "bn_stats_finalize" not in bnm.LAUNCHES  # folded into the split normalise
    assert not hasattr(bnm, "bn_stats_finalize")


def _partner_inside_the_share(shares, ts):
    """A gather that hands each share its own rows W times over: ``every[perm]``
    then takes the partner ``perm % b`` of the share itself."""
    return [torch.cat([t] * shares.size) for t in ts]


WRONG_STEPS = {
    "per_share_statistics": lambda: mock.patch.object(
        bnm, "SPLIT_KERNEL_OPS", bnm.SPLIT_KERNEL_OPS._replace(fwd=_each_share_its_own)),
    "dgamma_from_the_summed_sums": lambda: mock.patch.object(
        bnm, "SPLIT_KERNEL_OPS",
        bnm.SPLIT_KERNEL_OPS._replace(bwd_apply=_dgamma_from_the_total)),
    "partner_inside_the_share": lambda: mock.patch.object(steps._Shares, "gather",
                                                          _partner_inside_the_share),
}


@pytest.mark.parametrize("wrong", sorted(WRONG_STEPS))
def test_wrong_steps_fail_the_shares_bound(wrong):
    """The float64 step of ``test_torch_dp_steps.py`` (sample mixup, 2
    shares): each wrong version off the one-device step by far more than its
    1e-10."""
    perm, lam = crossing_mixup(4)
    want = run_tracknet(tracknet_model(), tracknet_batch("plain"), None, 0.5, perm, lam)
    with WRONG_STEPS[wrong]():
        got = run_tracknet(tracknet_model(), tracknet_batch("plain"), 2, 0.5, perm, lam)
    errs = worst(got, want)
    assert max(e for e, _ in errs.values()) > 1e-4, errs
