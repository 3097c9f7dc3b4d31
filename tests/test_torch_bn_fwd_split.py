"""The split normalise of data-parallel training's synchronised BatchNorm
(``ops/batchnorm.py`` ``bn_relu_fwd_split``: the forward's finalize from the
summed sums and the normalise in one op) on the CPU, where its wrapper runs
its plain version (``chip_smoke.py`` ``split_vs_plain`` holds the kernel to
the same plain version on the card, and to the old finalize + normalise
pair, bit for bit).

- The fused plain op is ``bn_stats_finalize_plain`` then
  ``bn_relu_fwd_plain`` bit for bit: output, statistics and running
  statistics, in bfloat16, float32 and float64; without running statistics
  it computes the same output and statistics and updates nothing.
- Through ``SyncBNRelu`` over 2 and 4 shares with ``SPLIT_PLAIN_OPS``: the
  output, every gradient and the running statistics equal the unsplit
  ``bn_relu_train_plain`` within 1e-12 (float64), each share's saved
  statistics equal the first share's, and only the first share updates the
  running statistics. Two wrong fused ops fail: one that updates them on
  every share, one that normalises with the share's own sums.
- The wrapper refuses what its kernel does not take.
- The data-parallel train step of ``tests/test_torch_dp_jax_steps.py`` (held
  there to the JAX package's sharded step) goes through the fused op: one
  call a layer and share, and its result bit-equal with a counting op
  patched in.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from unittest import mock  # noqa: E402

from torch_dp_data import run_tracknet, tracknet_batch, tracknet_model  # noqa: E402
from tracknetv3_tpu_torch.ops import batchnorm as bnm  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh, mesh_reducer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tracknetv3_tpu_torch", "csrc", "batchnorm.cu")
N, H, W, C = 4, 4, 8, 16  # 128 rows
CONST = 5  # a channel of one value: variance 0 and a ReLU tie


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, H, W, C)) * rng.uniform(0.5, 2.0, C) + rng.uniform(-3, 3, C)
    y[..., CONST] = 3.0
    g = rng.standard_normal((N, H, W, C))
    sd = torch.promote_types(dtype, torch.float32)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, C)).to(sd)
    beta = torch.from_numpy(rng.uniform(-0.5, 0.5, C)).to(sd)
    beta[CONST] = 0.0
    rm = torch.from_numpy(rng.uniform(-1, 1, C)).to(sd)
    rv = torch.from_numpy(rng.uniform(0.5, 2, C)).to(sd)
    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype).contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    return cl(y), cl(g), gamma, beta, rm, rv


def _total(y, seed=1):
    """The sums of ``y`` plus those of two other shares of other values, and
    the rows of all three."""
    rng = np.random.default_rng(seed)
    other = torch.from_numpy(rng.standard_normal((2, C)) * [[40.0], [300.0]] + [[0.0], [600.0]])
    return bnm.bn_stats_sums_plain(y) + other, 3 * bnm._rows(y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_fused_plain_is_the_finalize_then_the_normalise(dtype):
    y, _, gamma, beta, rm, rv = _data(dtype)
    total, n = _total(y)
    rm1, rv1, rm2, rv2 = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    st = bnm.bn_stats_finalize_plain(total, n, gamma, rm1, rv1, torch.promote_types(
        dtype, torch.float32))
    want = (bnm.bn_relu_fwd_plain(y, st, beta), st, rm1, rv1)
    out, st2 = bnm.bn_relu_fwd_split_plain(y, gamma, beta, total, n, rm2, rv2)
    for a, b in zip((out, st2, rm2, rv2), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out.dtype == y.dtype and out.is_contiguous(memory_format=torch.channels_last)
    assert not torch.equal(rm2, rm)  # the update happened
    # on CPU tensors the wrapper is the plain version
    rm3, rv3 = rm.clone(), rv.clone()
    for a, b in zip((*bnm.bn_relu_fwd_split(y, gamma, beta, total, n, rm3, rv3), rm3, rv3),
                    want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_fused_plain_without_running_stats_updates_nothing(dtype):
    y, _, gamma, beta, rm, rv = _data(dtype, seed=3)
    total, n = _total(y, seed=4)
    want = bnm.bn_relu_fwd_split_plain(y, gamma, beta, total, n, rm.clone(), rv.clone())
    rm0, rv0 = rm.clone(), rv.clone()
    got = bnm.bn_relu_fwd_split_plain(y, gamma, beta, total, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = bnm.bn_stats_finalize_plain(total, n, gamma, None, None, want[1].dtype)
    assert torch.equal(st, want[1])
    assert torch.equal(rm, rm0) and torch.equal(rv, rv0)


def _over_shares(shares, ops):
    y, g, gamma, beta, _, _ = _data(torch.float64, seed=5)
    y, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    outs = bnm.split_bn_relu_train(list(y.split(N // shares)), [w] * shares, [b] * shares, rm,
                                   rv, mesh_reducer(make_mesh(shares, device="cpu")),
                                   ops=ops(rm, rv))
    grads = torch.autograd.grad(outs, (y, w, b), list(g.split(N // shares)))
    return [torch.cat([o.detach() for o in outs]), *grads, rm, rv]


def _unsplit():
    y, g, gamma, beta, _, _ = _data(torch.float64, seed=5)
    y, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    out = bnm.bn_relu_train_plain(y, w, b, rm, rv)
    return [out.detach(), *torch.autograd.grad(out, (y, w, b), g), rm, rv]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shares", [2, 4])
def test_sync_op_normalises_each_share_with_the_global_statistics(shares):
    sts, updates = [], []

    def recorded(rm, rv):
        def fwd(y, weight, bias, total, n, running_mean=None, running_var=None):
            out, st = bnm.bn_relu_fwd_split_plain(y, weight, bias, total, n, running_mean,
                                                  running_var)
            sts.append(st)
            updates.append(running_mean is not None)
            assert running_mean is None or (running_mean is rm and running_var is rv)
            return out, st
        return bnm.SPLIT_PLAIN_OPS._replace(fwd=fwd)

    got = _over_shares(shares, recorded)
    want = _unsplit()
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-12, _rel(a, b)
    assert len(sts) == shares and updates == [True] + [False] * (shares - 1)
    assert all(torch.equal(st, sts[0]) for st in sts[1:])
    # the tie is there: z == 0 on the constant channel, half the gradient passes
    assert torch.all(want[0][:, CONST] == 0) and torch.all(want[1][:, CONST] != 0)


def _updating_every_share(rm, rv):
    def fwd(y, weight, bias, total, n, running_mean=None, running_var=None):
        return bnm.bn_relu_fwd_split_plain(y, weight, bias, total, n, rm, rv)
    return bnm.SPLIT_PLAIN_OPS._replace(fwd=fwd)


def _own_sums(rm, rv):
    def fwd(y, weight, bias, total, n, running_mean=None, running_var=None):
        return bnm.bn_relu_fwd_split_plain(y, weight, bias, bnm.bn_stats_sums_plain(y),
                                           bnm._rows(y), running_mean, running_var)
    return bnm.SPLIT_PLAIN_OPS._replace(fwd=fwd)


@pytest.mark.parametrize("wrong", ["updating_every_share", "own_sums"])
@pytest.mark.parametrize("shares", [2, 4])
def test_wrong_fused_ops_fail(wrong, shares):
    got = _over_shares(shares, {"updating_every_share": _updating_every_share,
                                "own_sums": _own_sums}[wrong])
    want = _unsplit()
    names = ["out", "dy", "dgamma", "dbeta", "running_mean", "running_var"]
    errs = {k: _rel(a, b) for k, a, b in zip(names, got, want)}
    assert errs["running_mean"] > 1e-3 and errs["running_var"] > 1e-3, errs
    if wrong == "own_sums":
        assert errs["out"] > 1e-3 and errs["dy"] > 1e-3, errs
    else:  # the output is right; only the running statistics moved too often
        assert errs["out"] <= 1e-12 and errs["dy"] <= 1e-12, errs


def test_fused_wrapper_refuses_what_its_kernel_does_not_take():
    y, _, gamma, beta, rm, rv = _data(torch.float32)
    total = torch.zeros(2, C, dtype=torch.float64)
    bnm._check_fwd_split(y, gamma, beta, total, rm, rv)
    bnm._check_fwd_split(y, gamma, beta, total, None, None)
    meta = torch.empty(2, C, dtype=torch.float64, device="meta")
    bad = {
        "float64 activations": (y.double(), gamma, beta, total, rm, rv),
        "NCHW memory": (y.contiguous(), gamma, beta, total, rm, rv),
        "float32 sums": (y, gamma, beta, total.float(), rm, rv),
        "sums of three rows": (y, gamma, beta, torch.zeros(3, C, dtype=torch.float64), rm, rv),
        "sums of another width": (y, gamma, beta, torch.zeros(2, C + 1, dtype=torch.float64),
                                  rm, rv),
        "sums on another device": (y, gamma, beta, meta, rm, rv),
        "float64 weight": (y, gamma.double(), beta, total, rm, rv),
        "bias of another width": (y, gamma, beta[:-1].contiguous(), total, rm, rv),
        "one running statistic": (y, gamma, beta, total, rm, None),
        "float64 running statistics": (y, gamma, beta, total, rm.double(), rv.double()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            bnm._check_fwd_split(*args)
            pytest.fail(name)


def test_the_split_forward_has_no_finalize_of_its_own():
    src = open(SOURCE).read()
    assert "bn_stats_finalize(" not in src and "bn_relu_fwd_split_kernel<T><<<" in src
    # the unsplit statistics keep their finalize kernel, whose body the
    # split normalise shares
    assert src.count("fwd_finalize_channel(c, C,") == 2
    assert "bn_stats_finalize" not in bnm.LAUNCHES and "bn_relu_fwd_split" in bnm.LAUNCHES
    assert bnm.SplitBNOps._fields == ("sums", "fwd", "bwd_sums", "bwd_apply")


@pytest.mark.parametrize("kind,shares", [("plain", 2), ("segmented", 2), ("resident", 4),
                                         ("resident_shard", 4)])
def test_the_shares_step_goes_through_the_fused_op(kind, shares):
    """The step of ``test_shares_step_matches_the_jax_sharded_step``, with the
    fused op counted: one call a BatchNorm layer and share, and every bit of
    the result that of the uncounted step."""
    batch = tracknet_batch(kind, 4, seed=11)
    shard = kind == "resident_shard"
    want = run_tracknet(tracknet_model(), batch, shares, shard=shard)
    calls, fused = [], bnm.SPLIT_KERNEL_OPS.fwd
    assert fused is bnm.bn_relu_fwd_split

    def counted(*args):
        calls.append(args[0].shape[0])
        return fused(*args)

    model = tracknet_model()
    layers = sum(1 for k, _ in model.named_buffers() if k.endswith("running_mean"))
    with mock.patch.object(bnm, "SPLIT_KERNEL_OPS", bnm.SPLIT_KERNEL_OPS._replace(fwd=counted)):
        got = run_tracknet(model, batch, shares, shard=shard)
    assert layers == 17 and len(calls) == layers * shares
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
