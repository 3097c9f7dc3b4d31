"""What the split BatchNorm kernels of ``tracknetv3_tpu_torch/csrc/batchnorm.cu``
do that the card alone can run, rehearsed on the CPU.

- ``sums_plan``: the grid of ``bn_stats_sums`` (clusters of SUMS_CLUSTER
  blocks, the rows split evenly over the blocks) covers every row once, at
  the data-parallel train step's four shapes at a share of 5 and at small
  ones; a plan no launch fits raises.
- The sums' order: ``bn_stats_sums_in_order`` (the numpy model that the card's
  check holds the kernel to) equals a walk of the kernel's code thread by
  thread (its loads in batches, the shuffle-xor tree, the in-place block
  combine, the cluster's ranks, the last block's threads over the
  clusters) bit for bit, repeats its bits, and stays within 1e-12 of
  ``bn_stats_sums_plain`` at a C of 64 and 512 in bfloat16 and float32.
- The split backward's fused apply: its plain version is the old finalize
  then the old apply, bit for bit; the synchronised op through
  ``SPLIT_PLAIN_OPS`` still equals the unsplit op and calls it once a share;
  its wrapper refuses wrong dtypes, shapes and devices.
- The kernel's constants agree with the wrapper's.

Nothing here runs JAX: the op itself is held to the JAX package in
``tests/test_torch_batchnorm.py`` and ``tests/test_torch_dp_steps.py``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu_torch.ops import batchnorm as bnm  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh, mesh_reducer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tracknetv3_tpu_torch", "csrc", "batchnorm.cu")
THREADS, BATCH = 256, 8  # kThreads, kBatch
# (rows, C) of the data-parallel train step's BatchNorm layers at a share of 5
STEP_SHAPES = [(5 * 288 * 512, 64), (5 * 144 * 256, 128), (5 * 72 * 128, 256),
               (5 * 36 * 64, 512)]


def _y(rows, C, dtype, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((rows, C)) * rng.uniform(0.5, 2.0, C) + rng.uniform(-8, 8, C)
    y[rng.uniform(size=(rows, C)) < 0.05] = 0.0
    return torch.from_numpy(y).to(dtype)


def _plain(y):
    """``bn_stats_sums_plain`` of (rows, C) rows as the (1, C, rows, 1) NCHW view."""
    return bnm.bn_stats_sums_plain(y.T.reshape(1, y.shape[1], y.shape[0], 1)).numpy()


@pytest.mark.parametrize("rows,C", STEP_SHAPES + [(300, 8), (4097, 64), (9, 512), (1, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_clusters", [1, 33, 48])
def test_plan_covers_every_row_once(rows, C, dtype, max_clusters):
    plan = bnm.sums_plan(rows, C, dtype.itemsize, max_clusters)
    G = C * dtype.itemsize // 16
    assert plan.groups == G and 1 <= plan.clusters <= max_clusters
    blocks = plan.clusters * bnm.SUMS_CLUSTER
    starts = np.arange(blocks) * plan.rows_per_block
    ends = np.minimum(starts + plan.rows_per_block, rows)
    covered = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends) if e > s])
    np.testing.assert_array_equal(covered, np.arange(rows))
    # no more blocks than the rows fill at _MIN_ROWS a thread, unless one cluster
    want = -(-rows // (THREADS // G * bnm._MIN_ROWS))
    assert plan.clusters == min(max_clusters, -(-want // bnm.SUMS_CLUSTER))
    if (rows, C) in STEP_SHAPES[:2] and max_clusters > 1:
        assert plan.clusters == max_clusters  # the widest layers fill a wave


def test_plans_no_launch_fits_raise():
    for rows, clusters in ((0, 8), (10, 0)):
        with pytest.raises(ValueError):
            bnm.sums_plan(rows, 64, 2, clusters)


# ------------------------------------------------------------ the kernel's order


def _kernel_walk(y: np.ndarray, plan, P: int) -> np.ndarray:
    """``bn_stats_sums_kernel`` transcribed statement by statement: every
    block's threads, its shared memory, the cluster's reads of it, and each
    slice's last block (which block arrives last does not enter)."""
    rows, C = y.shape
    G, K_CL = plan.groups, bnm.SUMS_CLUSTER
    R, per = THREADS // G, plan.rows_per_block
    nblk = plan.clusters * K_CL
    shs = []
    for b in range(nblk):
        r0 = b * per
        r1 = min(r0 + per, rows)
        ds, dq = np.zeros((THREADS, P)), np.zeros((THREADS, P))
        for tid in range(THREADS):
            g, lr = tid % G, tid // G
            r = r0 + lr
            while r < r1:
                for u in range(BATCH):
                    if r + u * R < r1:
                        d = y[r + u * R, g * P:(g + 1) * P]
                        ds[tid] = ds[tid] + d
                        dq[tid] = dq[tid] + d * d
                r += BATCH * R
        sh = np.zeros(2 * THREADS * P)
        lane = np.arange(THREADS) & 31
        if G < 32:
            off = G
            while off < 32:
                partner = (np.arange(THREADS) & ~31) | (lane ^ off)
                ds, dq = ds + ds[partner], dq + dq[partner]
                off <<= 1
            K, ks, writes = THREADS // 32, np.arange(THREADS) >> 5, lane < G
        else:
            K, ks, writes = R, np.arange(THREADS) // G, np.ones(THREADS, bool)
        for tid in np.nonzero(writes)[0]:
            g, k = tid % G, ks[tid]
            sh[k * C + g * P:k * C + (g + 1) * P] = ds[tid]
            sh[K * C + k * C + g * P:K * C + k * C + (g + 1) * P] = dq[tid]
        for o in range(2 * C):
            base = (o // C) * K * C + o % C
            acc = sh[base]
            for kk in range(1, K):
                acc = acc + sh[base + kk * C]
            sh[base] = acc
        shs.append(sh)
    O = 2 * C // K_CL
    cpart = np.zeros(plan.clusters * 2 * C)
    for b in range(nblk):
        rank, cl = b % K_CL, b // K_CL
        for i in range(O):
            o = rank * O + i
            at = (o // C) * K * C + o % C
            v = [shs[cl * K_CL + q][at] for q in range(K_CL)]
            acc = v[0]
            for q in range(1, K_CL):
                acc = acc + v[q]
            cpart[cl * 2 * C + o] = acc
    sums = np.zeros(2 * C)
    Oc = min(O, THREADS)
    S = THREADS // Oc
    for rank in range(K_CL):
        for base in range(0, O, Oc):
            fin = np.zeros(THREADS)
            for tid in range(THREADS):
                io, t = tid % Oc, tid // Oc
                o = rank * O + base + io
                acc, c0 = 0.0, t
                while c0 < plan.clusters:
                    for u in range(BATCH):
                        c = c0 + u * S
                        acc = acc + (cpart[c * 2 * C + o] if c < plan.clusters else 0.0)
                    c0 += BATCH * S
                fin[t * Oc + io] = acc
            for io in range(Oc):
                tot = fin[io]
                for tt in range(1, S):
                    tot = tot + fin[tt * Oc + io]
                sums[rank * O + base + io] = tot
    return sums.reshape(2, C)


# (rows, C, dtype, max_clusters): every path of the kernel's combine: G = 1
# (a warp holds 32 rows), G = 8 and 16 (4 and 2 rows), G = 64 and 128 (a row
# over 2 and 4 warps), one cluster and several, a slice of 1 output and of 128
WALKS = [(300, 8, torch.bfloat16, 4), (4200, 64, torch.bfloat16, 2),
         (2100, 64, torch.float32, 3), (600, 512, torch.bfloat16, 2),
         (700, 512, torch.float32, 2), (70, 4, torch.float32, 1)]


@pytest.mark.parametrize("rows,C,dtype,max_clusters", WALKS)
def test_model_is_the_kernels_walk_bit_for_bit(rows, C, dtype, max_clusters):
    y = _y(rows, C, dtype, seed=C + rows)
    plan = bnm.sums_plan(rows, C, dtype.itemsize, max_clusters)
    yn = y.float().numpy()
    walk = _kernel_walk(yn.astype(np.float64), plan, 16 // dtype.itemsize)
    model = bnm.bn_stats_sums_in_order(yn, plan)
    assert walk.tobytes() == model.tobytes()
    np.testing.assert_allclose(model, _plain(y), rtol=1e-12, atol=0)


@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_clusters", [1, 5])
def test_model_repeats_its_bits_within_1e12_of_plain(C, dtype, max_clusters):
    rows = 40_000 if C == 64 else 6_000
    y = _y(rows, C, dtype, seed=C)
    plan = bnm.sums_plan(rows, C, dtype.itemsize, max_clusters)
    assert plan.clusters == max_clusters  # several blocks and clusters add
    yn = y.float().numpy()
    got = [bnm.bn_stats_sums_in_order(yn, plan) for _ in range(2)]
    assert got[0].tobytes() == got[1].tobytes()
    want = _plain(y)
    rel = np.abs(got[0] - want).max(axis=1) / np.abs(want).max(axis=1)
    assert rel.max() <= 1e-12, rel


# ------------------------------------------------------------ the fused apply


def _bn_inputs(dtype, seed=0, N=2, H=4, W=8, C=16):
    rng = np.random.default_rng(seed)
    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype).contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    y = cl(rng.standard_normal((N, H, W, C)) * 2 + 1)
    g = cl(rng.standard_normal((N, H, W, C)))
    sd = torch.promote_types(dtype, torch.float32)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, C)).to(sd)
    beta = torch.from_numpy(rng.uniform(-0.5, 0.5, C)).to(sd)
    rm, rv = torch.zeros(C, dtype=sd), torch.ones(C, dtype=sd)
    st = bnm.bn_stats_plain(y, gamma, rm, rv)
    return y, g, st, beta


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_fused_apply_plain_is_the_finalize_then_the_apply(dtype):
    y, g, st, beta = _bn_inputs(dtype)
    local = bnm.bn_relu_bwd_sums_plain(g, y, st, beta)
    total = local * 3 + 0.25  # other shares' sums added
    n = 3 * bnm._rows(y)
    dgamma, dbeta, coef = bnm.bn_relu_bwd_finalize_plain(local, total, n, st, True)
    dy = bnm.bn_relu_bwd_apply_plain(g, y, st, beta, coef)
    got = bnm.bn_relu_bwd_apply_split_plain(g, y, st, beta, local, total, n)
    for a, b in zip(got, (dy, dgamma, dbeta)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # on CPU tensors the wrapper is the plain version
    for a, b in zip(bnm.bn_relu_bwd_apply_split(g, y, st, beta, local, total, n), got):
        assert torch.equal(a, b)


def _split_op(y, g, gamma, beta, shares, ops):
    y, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    N = y.shape[0]
    outs = bnm.split_bn_relu_train(list(y.split(N // shares)), [w] * shares, [b] * shares, rm,
                                   rv, mesh_reducer(make_mesh(shares, device="cpu")), ops=ops)
    grads = torch.autograd.grad(outs, (y, w, b), list(g.split(N // shares)))
    return [torch.cat([o.detach() for o in outs]), *grads, rm, rv]


@pytest.mark.parametrize("shares", [2, 4])
def test_split_plain_ops_match_the_unsplit_op_and_apply_once_a_share(shares):
    y, g, _, beta = _bn_inputs(torch.float64, seed=2, N=4)
    gamma = torch.linspace(0.5, 1.5, y.shape[1], dtype=torch.float64)
    yy, w, b = (t.detach().clone().requires_grad_() for t in (y, gamma, beta))
    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    out = bnm.bn_relu_train(yy, w, b, rm, rv)
    want = [out.detach(), *torch.autograd.grad(out, (yy, w, b), g), rm, rv]
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return bnm.bn_relu_bwd_apply_split_plain(*args)

    got = _split_op(y, g, gamma, beta, shares,
                    bnm.SPLIT_PLAIN_OPS._replace(bwd_apply=counted))
    assert len(calls) == shares
    for a, b_ in zip(got, want):
        assert float((a - b_).abs().max() / b_.abs().max()) <= 1e-12


def test_fused_apply_wrapper_refuses_what_its_kernel_does_not_take():
    y, g, st, beta = _bn_inputs(torch.float32)
    C = y.shape[1]
    local = torch.zeros(2, C, dtype=torch.float64)
    bnm._check_apply_split(g, y, st, beta, local, local)
    meta = torch.empty(2, C, dtype=torch.float64, device="meta")
    bad = {
        "float64 activations": (g.double(), y.double(), st, beta, local, local),
        "gradient of another dtype": (g.bfloat16(), y, st, beta, local, local),
        "NCHW memory": (g, y.contiguous(), st, beta, local, local),
        "float32 sums": (g, y, st, beta, local.float(), local),
        "sums of three rows": (g, y, st, beta, local, torch.zeros(3, C, dtype=torch.float64)),
        "sums of another width": (g, y, st, beta, local, torch.zeros(2, C + 1,
                                                                      dtype=torch.float64)),
        "sums on another device": (g, y, st, beta, meta, local),
        "statistics of another width": (g, y, st[:, :-1].contiguous(), beta, local, local),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            bnm._check_apply_split(*args)
            pytest.fail(name)


def test_kernel_constants_agree_with_the_wrapper():
    src = open(SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kCluster") == bnm.SUMS_CLUSTER
    assert const("kMinRows") == bnm._MIN_ROWS
    assert const("kThreads") == THREADS == bnm._THREADS
    assert const("kBatch") == BATCH
    # one kernel a dtype behind the sums' entry point, and the old finalize gone
    assert "cudaLaunchKernelEx(&cfg, bn_stats_sums_kernel<T>" in src
    assert "bn_relu_bwd_finalize(" not in src and "bn_sums_kernel<<<" in src
