"""BatchNorm + ReLU of the TrackNet train and eval steps (hand-written CUDA
kernels, forward and backward).

The JAX train forward (``tracknetv3_tpu/models/fused_forward.py:285-332``)
follows each conv with ``batch_moments`` (mean and ``E[y^2] - mean^2``
clamped at 0), ``record_stats`` (the running update) and ``bn_relu``
(``max((y - mean) * inv + bias, 0)`` cast to the working dtype);
``tools/probe_bn_pool.py``'s Pallas kernels ``stats_pl`` (P4) and
``norm_pl`` (P5) were written for that epilogue. Here it is four kernels of
``csrc/batchnorm.cu``, one ``torch.autograd.Function`` around them:

- ``bn_stats`` (P4): per-channel statistics ``st`` (4, C) = mean, diff
  (``E[y^2] - mean^2`` before the clamp), ``r = 1 / sqrt(var + eps)``,
  ``inv = r * gamma``, and the running update ``0.9 * old + 0.1 * batch``
  (biased variance) in place;
- ``bn_relu_fwd`` (P5): ``cast(max((y - mean) * inv + beta, 0))``;
- ``bn_relu_bwd_reduce``: ``dgamma``, ``dbeta`` and the two per-channel
  coefficients of the input gradient;
- ``bn_relu_bwd_apply``: the input gradient ``dy``.

The gradient is JAX's: ``jnp.maximum`` passes half the gradient where its
arguments tie, so the ReLU passes ``g / 2`` where ``z == 0`` exactly and the
variance clamp passes half its term where ``diff == 0`` (``jax.nn.relu``
and ``torch.relu`` would pass 0).

The sums behind the statistics and the gradient add every element in
float64, so 1.47 M rows of a channel do not cancel in ``E[y^2] - mean^2``
and a gradient sum that cancels keeps its digits; the rest is float32 (float64 for a
float64 ``y``, which only the plain versions take), each operation
rounded as written, so the plain versions and the kernels compute the same
``z`` and the backward's masks agree with the forward.

Tensors are NCHW views with channels_last memory, as the port's
convolutions produce them, in bfloat16 (training) or float32 (parity
runs). On a CPU tensor each wrapper returns its plain version (``*_plain``,
torch ops); on a CUDA tensor it launches its kernel or raises (float64, or
memory that is not channels_last, is refused). ``LAUNCHES`` counts the
launches of each kernel.

``bn_relu_train`` / ``bn_relu_eval`` are the layer's op; ``*_plain`` are
the same ``Function`` over the plain versions, so a caller can swap one
for the other with ``unittest.mock.patch.object``.

Data-parallel training normalises every share of a global batch with the
statistics of the whole batch, as the JAX step does under GSPMD (the batch
mean of a sharded array is an all-reduce). For it the two reductions are
split at their float64 sums, four more kernels:

- ``bn_stats_sums``: one share's (2, C) sums (Σy, Σy²), one launch of a grid
  of thread block clusters (``sums_plan``) that adds the blocks' partials
  in the same launch, in a fixed order of its own
  (``bn_stats_sums_in_order`` models it in numpy);
- ``bn_relu_fwd_split``: ``st`` from sums that a ``Reducer`` has summed
  over the shares and the global row count, computed in every block with the
  unsplit finalize's roundings, and the normalise, in one launch; block 0
  writes ``st`` and, where it is given running statistics, their update. Its
  plain version is ``bn_stats_finalize_plain`` then ``bn_relu_fwd_plain``;
- ``bn_relu_bwd_sums``: one share's (2, C) sums (Σgz, Σgz·(y - mean));
- ``bn_relu_bwd_apply_split``: ``dgamma`` and ``dbeta`` from the share's own
  sums (the shares' parameter gradients are summed afterwards, by autograd
  on a mesh or an all-reduce over processes), the coefficients from the
  summed ones, computed in every block, and ``dy``, in one launch; its plain
  version is ``bn_relu_bwd_finalize_plain`` then ``bn_relu_bwd_apply_plain``.

``split_bn_relu_train`` is the synchronised op over a list of shares: sums
per share, one reduction by the caller's reducer (``parallel/mesh.py``,
``parallel/processes.py``), ``bn_relu_fwd_split`` per share on its own copy
of the summed sums (the first share of a process also updates the running
statistics); the backward alike, ending in ``bn_relu_bwd_apply_split`` per
share. Over one share whose reducer returns its sums it computes
``bn_relu_train``'s every bit given equal forward sums (the kernels' forward
sums may differ from the unsplit statistics' in the last bits of float64;
the plain versions' are equal). ``sync_bn_relu_train``, the layer's op,
runs ``bn_relu_train`` itself where one share of one process is the whole
batch, and the split op otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

SOURCE = "batchnorm.cu"
MOMENTUM = 0.9
EPS = 1e-5
LAUNCHES = {"bn_stats": 0, "bn_relu_fwd": 0, "bn_relu_bwd_reduce": 0, "bn_relu_bwd_apply": 0,
            "bn_stats_sums": 0, "bn_relu_fwd_split": 0, "bn_relu_bwd_sums": 0,
            "bn_relu_bwd_apply_split": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# the kernels' C entry points per dtype: bfloat16 on the train path,
# float32 for parity runs
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_THREADS = 256  # a block of csrc/batchnorm.cu; the 16-byte groups of a row must divide it
SUMS_CLUSTER = 8  # blocks of a cluster of bn_stats_sums (kCluster)
_MIN_ROWS = 16  # rows a thread of a reduction walks at least (kMinRows)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    lib.bn_max_blocks.argtypes = []
    lib.bn_max_blocks.restype = _I
    sigs = {
        "bn_stats": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _F, _F, _P],
        "bn_relu_fwd": [_P, _P, _P, _P, _LL, _I, _P],
        "bn_relu_bwd_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
        "bn_relu_bwd_apply": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
        "bn_stats_sums": [_P, _P, _P, _P, _LL, _I, _I, _LL, _P],
        "bn_relu_fwd_split": [_P, _P, _P, _D, _P, _P, _P, _P, _P, _LL, _I, _F, _F, _F, _P],
        "bn_relu_bwd_sums": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
        "bn_relu_bwd_apply_split": [_P, _P, _P, _P, _P, _P, _P, _D, _P, _P, _LL, _I, _P],
        "bn_stats_sums_clusters": [_P],
    }
    for kind, sig in sigs.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{kind}_{suffix}")
            fn.argtypes = sig
            fn.restype = _I
    return lib


# ---------------------------------------------------------------- plain versions


def _c(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over (N, C, H, W)."""
    return v[:, None, None]


def _rows(y: torch.Tensor) -> int:
    return y.numel() // y.shape[1]


def _relu_grad(z: torch.Tensor) -> torch.Tensor:
    """d max(z, 0) / dz as ``jnp.maximum`` differentiates it: 1, 1/2 at a tie, 0."""
    return torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0)).to(z.dtype)


def _stats_dtype(y: torch.Tensor) -> torch.dtype:
    """float32 statistics, float64 for a float64 ``y``."""
    return torch.promote_types(y.dtype, torch.float32)


def bn_stats_sums_plain(y) -> torch.Tensor:
    """(2, C) float64 sums (Σy, Σy²) of ``y`` over (N, H, W) (the kernel
    ``bn_stats_sums``)."""
    yd = y.to(torch.float64)
    return torch.stack([yd.sum((0, 2, 3)), yd.square().sum((0, 2, 3))])


@torch.no_grad()
def bn_stats_finalize_plain(sums, n, weight, running_mean, running_var, dtype=torch.float32,
                            momentum=MOMENTUM, eps=EPS):
    """``st`` (4, C) in ``dtype`` from (2, C) sums over ``n`` rows, and the
    running update in place where ``running_mean`` is not None (the second
    launch of the kernel ``bn_stats``; the first half of
    ``bn_relu_fwd_split``)."""
    mean = sums[0] / n
    diff = (sums[1] / n - mean * mean).to(dtype)
    mean = mean.to(dtype)
    var = diff.clamp_min(0.0)
    r = 1.0 / torch.sqrt(var + eps)
    if running_mean is not None:
        running_mean.mul_(momentum).add_(mean * (1.0 - momentum))
        running_var.mul_(momentum).add_(var * (1.0 - momentum))
    return torch.stack([mean, diff, r, r * weight])


@torch.no_grad()
def bn_stats_plain(y, weight, running_mean, running_var, momentum=MOMENTUM, eps=EPS):
    """Statistics ``st`` (4, C) of ``y`` over (N, H, W) and the running
    update in place (the kernel ``bn_stats``'s function)."""
    return bn_stats_finalize_plain(bn_stats_sums_plain(y), _rows(y), weight, running_mean,
                                   running_var, _stats_dtype(y), momentum, eps)


def _z(y, st, bias):
    """``(y - mean) * inv + bias`` in the statistics' dtype."""
    return (y.to(st.dtype) - _c(st[0])) * _c(st[3]) + _c(bias)


def bn_relu_fwd_plain(y, st, bias):
    """``cast(max((y - mean) * inv + bias, 0))`` (the kernel ``bn_relu_fwd``)."""
    return _z(y, st, bias).clamp_min(0.0).to(y.dtype)


def bn_relu_fwd_split_plain(y, weight, bias, total, n, running_mean=None, running_var=None):
    """(out, st) of one share: ``bn_stats_finalize_plain`` on the sums
    ``total`` of all shares over ``n`` rows (the running update only where
    running statistics are given), then ``bn_relu_fwd_plain`` (the kernel
    ``bn_relu_fwd_split``)."""
    st = bn_stats_finalize_plain(total, n, weight, running_mean, running_var, _stats_dtype(y))
    return bn_relu_fwd_plain(y, st, bias), st


def bn_relu_bwd_sums_plain(g, y, st, bias) -> torch.Tensor:
    """(2, C) float64 sums (Σgz, Σgz·(y - mean)) of the output gradient
    ``g`` (the kernel ``bn_relu_bwd_sums``)."""
    sd = st.dtype
    gz = g.to(sd) * _relu_grad(_z(y, st, bias))
    yc = y.to(sd) - _c(st[0])
    return torch.stack([gz.sum((0, 2, 3), dtype=torch.float64),
                        (gz * yc).sum((0, 2, 3), dtype=torch.float64)])


def bn_relu_bwd_finalize_plain(local, total, n, st, train: bool):
    """(dgamma, dbeta) from one share's sums ``local``, ``coef`` (2, C) =
    (c1, c2) from the sums ``total`` of all shares over ``n`` rows (0 in eval
    mode): the second half of ``bn_relu_bwd_reduce_plain``, the first of
    ``bn_relu_bwd_apply_split_plain``."""
    sd = st.dtype
    diff, r = st[1], st[2]
    coef = torch.zeros((2, st.shape[1]), dtype=sd, device=st.device)
    if train:
        k = _relu_grad(diff)  # the clamp max(diff, 0), differentiated alike
        coef[0] = (total[0] / n).to(sd)
        coef[1] = k * (r * r) * (total[1] / n).to(sd)
    return local[1].to(sd) * r, local[0].to(sd), coef


def bn_relu_bwd_reduce_plain(g, y, st, bias, train: bool):
    """(dgamma, dbeta, coef (2, C)) from the output gradient ``g`` (the
    kernel ``bn_relu_bwd_reduce``); ``coef`` = (c1, c2) is 0 in eval mode."""
    sums = bn_relu_bwd_sums_plain(g, y, st, bias)
    return bn_relu_bwd_finalize_plain(sums, sums, _rows(y), st, train)


def bn_relu_bwd_apply_plain(g, y, st, bias, coef):
    """``dy = cast(inv * ((gz - c1) - (y - mean) * c2))`` (the kernel
    ``bn_relu_bwd_apply``)."""
    sd = st.dtype
    gz = g.to(sd) * _relu_grad(_z(y, st, bias))
    yc = y.to(sd) - _c(st[0])
    return (_c(st[3]) * ((gz - _c(coef[0])) - yc * _c(coef[1]))).to(y.dtype)


def bn_relu_bwd_apply_split_plain(g, y, st, bias, local, total, n):
    """(dy, dgamma, dbeta) of one share: ``bn_relu_bwd_finalize_plain`` in
    train mode on its own sums ``local`` and the summed sums ``total`` over
    ``n`` rows, then ``bn_relu_bwd_apply_plain`` (the kernel
    ``bn_relu_bwd_apply_split``)."""
    dgamma, dbeta, coef = bn_relu_bwd_finalize_plain(local, total, n, st, True)
    return bn_relu_bwd_apply_plain(g, y, st, bias, coef), dgamma, dbeta


# ---------------------------------------------------------------- the sums' launch plan


class SumsPlan(NamedTuple):
    """One launch of ``bn_stats_sums``: ``clusters`` clusters of SUMS_CLUSTER
    blocks, block b over rows [b * rows_per_block, (b + 1) * rows_per_block),
    ``groups`` 16-byte groups a row."""

    clusters: int
    rows_per_block: int
    groups: int


def sums_plan(rows: int, C: int, element_size: int, max_clusters: int) -> SumsPlan:
    """The grid of ``bn_stats_sums`` over ``rows`` rows of C channels: one
    wave of at most ``max_clusters`` clusters (the card's resident ones),
    fewer where a thread would walk less than _MIN_ROWS rows; the rows split
    evenly over the blocks."""
    if rows < 1 or max_clusters < 1:
        raise ValueError(f"need rows and clusters, got {rows} rows, {max_clusters} clusters")
    G = C * element_size // 16
    want = -(-rows // (_THREADS // G * _MIN_ROWS))  # blocks
    clusters = min(max_clusters, -(-want // SUMS_CLUSTER))
    return SumsPlan(clusters, -(-rows // (clusters * SUMS_CLUSTER)), G)


def bn_stats_sums_in_order(y: np.ndarray, plan: SumsPlan) -> np.ndarray:
    """(2, C) float64 sums (Σy, Σy²) of ``y`` (rows, C; float32 values) added
    in the order of the kernel ``bn_stats_sums`` under ``plan``: each thread's
    rows in order, the rows of a warp by a pairwise (shuffle-xor) tree, the
    warps (or, where a row spans warps, the rows) of a block in order, the
    blocks of a cluster in order, then for each output S threads over every
    S-th cluster in order and the S in order. Bit for bit what the kernel
    computes; a model for the CPU tests and the card's check."""
    y = np.asarray(y, dtype=np.float64)
    rows, C = y.shape
    G = plan.groups
    R = _THREADS // G
    nblk, per = plan.clusters * SUMS_CLUSTER, plan.rows_per_block
    m = -(-per // R)  # rows a thread walks at most; zero rows add nothing
    v = np.zeros((nblk, m * R, C))
    for b in range(nblk):
        got = y[b * per:min((b + 1) * per, rows)]
        v[b, :len(got)] = got
    v = v.reshape(nblk, m, R, C)
    s, q = np.zeros((nblk, R, C)), np.zeros((nblk, R, C))
    for i in range(m):
        s = s + v[:, i]
        q = q + v[:, i] * v[:, i]  # exact products: fma(d, d, q)
    t = np.concatenate([s, q], axis=2)  # (nblk, R, 2C)
    if G < 32:  # each warp's 32 / G rows by the shuffle-xor tree
        t = t.reshape(nblk, _THREADS // 32, 32 // G, 2 * C)
        while t.shape[2] > 1:
            t = t[:, :, 0::2] + t[:, :, 1::2]
        t = t[:, :, 0]
    block = t[:, 0]
    for k in range(1, t.shape[1]):
        block = block + t[:, k]
    block = block.reshape(plan.clusters, SUMS_CLUSTER, 2 * C)
    cpart = block[:, 0]
    for r in range(1, SUMS_CLUSTER):
        cpart = cpart + block[:, r]
    S = _THREADS // min(2 * C // SUMS_CLUSTER, _THREADS)  # threads an output
    share = [np.zeros(2 * C) for _ in range(S)]
    for t_ in range(S):
        for cl in range(t_, plan.clusters, S):
            share[t_] = share[t_] + cpart[cl]
    total = share[0]
    for t_ in range(1, S):
        total = total + share[t_]
    return total.reshape(2, C)


# ---------------------------------------------------------------- kernel wrappers


def check_kernel_input(y: torch.Tensor) -> None:
    """Raise unless ``y`` is what the kernels take: a non-empty 4-D
    bfloat16 or float32 NCHW view in channels_last memory whose channel
    row splits into 16-byte groups that divide a block, on a 16-byte
    aligned base."""
    if y.dim() != 4 or y.dtype not in _SUFFIX:
        raise ValueError(f"need a 4-D bfloat16 or float32 tensor, got {y.dtype} "
                         f"{tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("need channels_last (NHWC) memory")
    row = y.shape[1] * y.element_size()
    if y.numel() == 0 or row % 16 or _THREADS % (row // 16) or y.data_ptr() % 16:
        raise ValueError(f"need C whose 16-byte groups divide {_THREADS}, a 16-byte aligned "
                         f"non-empty tensor, got C={y.shape[1]} of {y.dtype}")


def _check_vectors(y: torch.Tensor, *vs: torch.Tensor) -> None:
    C = y.shape[1]
    for v in vs:
        if v.dtype != torch.float32 or v.device != y.device or not v.is_contiguous() \
                or v.shape[-1] != C:
            raise ValueError(f"per-channel tensors must be contiguous float32 (..., {C}) on "
                             f"{y.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def _check_grad(g: torch.Tensor, y: torch.Tensor) -> None:
    check_kernel_input(g)
    if g.dtype != y.dtype or g.shape != y.shape or g.device != y.device:
        raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} does not match y "
                         f"{y.dtype} {tuple(y.shape)}")


def _launch(kind: str, y: torch.Tensor, *args) -> None:
    fn = getattr(_lib(), f"{kind}_{_SUFFIX[y.dtype]}")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kind} failed to launch: cudaError {err}")
    LAUNCHES[kind] += 1


def _partials(y: torch.Tensor) -> torch.Tensor:
    """Scratch of the two-pass reductions: 2 doubles per channel per row block."""
    C = y.shape[1]
    return torch.empty((_lib().bn_max_blocks(), 2, C), dtype=torch.float64, device=y.device)


@torch.no_grad()
def bn_stats(y, weight, running_mean, running_var, momentum=MOMENTUM, eps=EPS):
    """Kernel P4: statistics ``st`` (4, C) float32 and the running update."""
    if y.device.type == "cpu":
        return bn_stats_plain(y, weight, running_mean, running_var, momentum, eps)
    check_kernel_input(y)
    _check_vectors(y, weight, running_mean, running_var)
    st = torch.empty((4, y.shape[1]), dtype=torch.float32, device=y.device)
    part = _partials(y)
    _launch("bn_stats", y, y.data_ptr(), part.data_ptr(), weight.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), st.data_ptr(), _rows(y),
            y.shape[1], float(eps), float(momentum), float(1.0 - momentum))
    return st


def bn_relu_fwd(y, st, bias):
    """Kernel P5: ``cast(max((y - mean) * inv + bias, 0))``, channels_last."""
    if y.device.type == "cpu":
        return bn_relu_fwd_plain(y, st, bias)
    check_kernel_input(y)
    _check_vectors(y, st, bias)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    _launch("bn_relu_fwd", y, y.data_ptr(), out.data_ptr(), st.data_ptr(), bias.data_ptr(),
            _rows(y), y.shape[1])
    return out


def bn_relu_bwd_reduce(g, y, st, bias, train: bool):
    """(dgamma, dbeta, coef (2, C)) float32 from ``g`` and ``y``."""
    if y.device.type == "cpu":
        return bn_relu_bwd_reduce_plain(g, y, st, bias, train)
    check_kernel_input(y)
    _check_grad(g, y)
    _check_vectors(y, st, bias)
    C = y.shape[1]
    dgamma, dbeta = (torch.empty(C, dtype=torch.float32, device=y.device) for _ in range(2))
    coef = torch.empty((2, C), dtype=torch.float32, device=y.device)
    part = _partials(y)
    _launch("bn_relu_bwd_reduce", y, g.data_ptr(), y.data_ptr(), part.data_ptr(),
            st.data_ptr(), bias.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            coef.data_ptr(), _rows(y), C, int(bool(train)))
    return dgamma, dbeta, coef


def bn_relu_bwd_apply(g, y, st, bias, coef):
    """The input gradient ``dy`` (channels_last, ``y``'s dtype)."""
    if y.device.type == "cpu":
        return bn_relu_bwd_apply_plain(g, y, st, bias, coef)
    check_kernel_input(y)
    _check_grad(g, y)
    _check_vectors(y, st, bias, coef)
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    _launch("bn_relu_bwd_apply", y, g.data_ptr(), y.data_ptr(), dy.data_ptr(), st.data_ptr(),
            bias.data_ptr(), coef.data_ptr(), _rows(y), y.shape[1])
    return dy


def _check_sums(sums: torch.Tensor, C: int, device) -> None:
    if sums.dtype != torch.float64 or sums.shape != (2, C) or not sums.is_contiguous() \
            or sums.device != device:
        raise ValueError(f"sums must be contiguous float64 (2, {C}) on {device}, got "
                         f"{sums.dtype} {tuple(sums.shape)} on {sums.device}")


# (device index, stream) -> the kCluster slice tickets of bn_stats_sums: 0
# between launches (each slice's last block resets its own); launches on one
# stream run in order, so they may share them, and two streams never do.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(SUMS_CLUSTER, dtype=torch.int32, device=device)
    return _TICKETS[key]


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, dtype: torch.dtype) -> int:
    """Clusters of ``bn_stats_sums`` the card ``index`` keeps resident."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(_lib(), f"bn_stats_sums_clusters_{_SUFFIX[dtype]}")(ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"bn_stats_sums: no resident cluster (cudaError {err}, {out.value})")
    return out.value


def bn_stats_sums(y) -> torch.Tensor:
    """The forward's (2, C) float64 sums of one share (P4's first half), in
    one launch."""
    if y.device.type == "cpu":
        return bn_stats_sums_plain(y)
    check_kernel_input(y)
    C = y.shape[1]
    plan = sums_plan(_rows(y), C, y.element_size(), _max_clusters(y.device.index, y.dtype))
    sums = torch.empty((2, C), dtype=torch.float64, device=y.device)
    cpart = torch.empty((plan.clusters, 2, C), dtype=torch.float64, device=y.device)
    fn = getattr(_lib(), f"bn_stats_sums_{_SUFFIX[y.dtype]}")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), cpart.data_ptr(), _tickets(y.device, stream).data_ptr(),
                 sums.data_ptr(), _rows(y), C, plan.clusters, plan.rows_per_block, stream)
    if err != 0:
        raise RuntimeError(f"bn_stats_sums failed to launch: cudaError {err}")
    LAUNCHES["bn_stats_sums"] += 1
    return sums


def _check_fwd_split(y, weight, bias, total, running_mean, running_var) -> None:
    """Raise unless the split normalise's kernel takes these tensors."""
    check_kernel_input(y)
    if (running_mean is None) != (running_var is None):
        raise ValueError("give both running statistics or neither")
    _check_vectors(y, weight, bias, *(v for v in (running_mean, running_var) if v is not None))
    _check_sums(total, y.shape[1], y.device)


@torch.no_grad()
def bn_relu_fwd_split(y, weight, bias, total, n, running_mean=None, running_var=None):
    """(out, st) of one share in one launch: P4's finalize on the sums
    ``total`` of all shares over ``n`` rows (``st`` (4, C) float32, and the
    running update where running statistics are given), then P5's normalise
    (``out`` channels_last in ``y``'s dtype)."""
    if y.device.type == "cpu":
        return bn_relu_fwd_split_plain(y, weight, bias, total, n, running_mean, running_var)
    _check_fwd_split(y, weight, bias, total, running_mean, running_var)
    C = y.shape[1]
    out = torch.empty_like(y, memory_format=torch.channels_last)
    st = torch.empty((4, C), dtype=torch.float32, device=y.device)
    running = [None if v is None else v.data_ptr() for v in (running_mean, running_var)]
    _launch("bn_relu_fwd_split", y, y.data_ptr(), out.data_ptr(), total.data_ptr(), float(n),
            weight.data_ptr(), bias.data_ptr(), *running, st.data_ptr(), _rows(y), C, float(EPS),
            float(MOMENTUM), float(1.0 - MOMENTUM))
    return out, st


def bn_relu_bwd_sums(g, y, st, bias) -> torch.Tensor:
    """The backward's (2, C) float64 sums of one share."""
    if y.device.type == "cpu":
        return bn_relu_bwd_sums_plain(g, y, st, bias)
    check_kernel_input(y)
    _check_grad(g, y)
    _check_vectors(y, st, bias)
    sums = torch.empty((2, y.shape[1]), dtype=torch.float64, device=y.device)
    _launch("bn_relu_bwd_sums", y, g.data_ptr(), y.data_ptr(), _partials(y).data_ptr(),
            st.data_ptr(), bias.data_ptr(), sums.data_ptr(), _rows(y), y.shape[1])
    return sums


def _check_apply_split(g, y, st, bias, local, total) -> None:
    """Raise unless the split apply's kernel takes these tensors."""
    check_kernel_input(y)
    _check_grad(g, y)
    _check_vectors(y, st, bias)
    for sums in (local, total):
        _check_sums(sums, y.shape[1], y.device)


def bn_relu_bwd_apply_split(g, y, st, bias, local, total, n):
    """(dy, dgamma, dbeta) of one share in one launch: dgamma and dbeta
    float32 from its own sums ``local``, the coefficients from the sums
    ``total`` of all shares over ``n`` rows, ``dy`` channels_last in ``y``'s
    dtype."""
    if y.device.type == "cpu":
        return bn_relu_bwd_apply_split_plain(g, y, st, bias, local, total, n)
    _check_apply_split(g, y, st, bias, local, total)
    C = y.shape[1]
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    dgamma, dbeta = (torch.empty(C, dtype=torch.float32, device=y.device) for _ in range(2))
    _launch("bn_relu_bwd_apply_split", y, g.data_ptr(), y.data_ptr(), dy.data_ptr(),
            st.data_ptr(), bias.data_ptr(), local.data_ptr(), total.data_ptr(), float(n),
            dgamma.data_ptr(), dbeta.data_ptr(), _rows(y), C)
    return dy, dgamma, dbeta


# ---------------------------------------------------------------- the op


class BNOps(NamedTuple):
    """The four functions one BatchNorm + ReLU goes through."""

    stats: Callable
    fwd: Callable
    bwd_reduce: Callable
    bwd_apply: Callable


KERNEL_OPS = BNOps(bn_stats, bn_relu_fwd, bn_relu_bwd_reduce, bn_relu_bwd_apply)
PLAIN_OPS = BNOps(bn_stats_plain, bn_relu_fwd_plain, bn_relu_bwd_reduce_plain,
                  bn_relu_bwd_apply_plain)


def eval_stats(weight, running_mean, running_var, eps=EPS) -> torch.Tensor:
    """``st`` of eval mode: the running statistics (C-vectors, torch ops)."""
    r = 1.0 / torch.sqrt(running_var + eps)
    return torch.stack([running_mean, running_var, r, r * weight])


class BNRelu(torch.autograd.Function):
    """``max(BatchNorm(y), 0)`` in ``y``'s dtype. Saves ``y``, the (4, C)
    statistics and ``bias``: nothing of activation size but ``y``."""

    @staticmethod
    def forward(ctx, y, weight, bias, running_mean, running_var, training: bool, ops: BNOps):
        if training:
            st = ops.stats(y, weight, running_mean, running_var)
        else:
            st = eval_stats(weight, running_mean, running_var)
        ctx.save_for_backward(y, st, bias)
        ctx.training, ctx.ops = training, ops
        return ops.fwd(y, st, bias)

    @staticmethod
    def backward(ctx, g):
        y, st, bias = ctx.saved_tensors
        # autograd sums the gradients of a skip connection in whatever
        # layout they come; the kernels read channels_last
        g = g.contiguous(memory_format=torch.channels_last)
        dgamma, dbeta, coef = ctx.ops.bwd_reduce(g, y, st, bias, ctx.training)
        dy = ctx.ops.bwd_apply(g, y, st, bias, coef)
        return dy, dgamma, dbeta, None, None, None, None


def bn_relu(y, weight, bias, running_mean, running_var, training: bool,
            ops: BNOps = KERNEL_OPS) -> torch.Tensor:
    return BNRelu.apply(y, weight, bias, running_mean, running_var, training, ops)


def bn_relu_train(y, weight, bias, running_mean, running_var) -> torch.Tensor:
    """Train mode: batch statistics, running update, JAX's gradient."""
    return bn_relu(y, weight, bias, running_mean, running_var, True)


def bn_relu_eval(y, weight, bias, running_mean, running_var) -> torch.Tensor:
    """Eval mode: normalise with the running statistics."""
    return bn_relu(y, weight, bias, running_mean, running_var, False)


def bn_relu_train_plain(y, weight, bias, running_mean, running_var) -> torch.Tensor:
    return bn_relu(y, weight, bias, running_mean, running_var, True, PLAIN_OPS)


def bn_relu_eval_plain(y, weight, bias, running_mean, running_var) -> torch.Tensor:
    return bn_relu(y, weight, bias, running_mean, running_var, False, PLAIN_OPS)



# ---------------------------------------------------------------- over shares


class SplitBNOps(NamedTuple):
    """The functions the synchronised op goes through."""

    sums: Callable
    fwd: Callable  # (y, weight, bias, total, n, running_mean, running_var) -> (out, st)
    bwd_sums: Callable
    bwd_apply: Callable  # (g, y, st, bias, local, total, n) -> (dy, dgamma, dbeta)


SPLIT_KERNEL_OPS = SplitBNOps(bn_stats_sums, bn_relu_fwd_split, bn_relu_bwd_sums,
                              bn_relu_bwd_apply_split)
SPLIT_PLAIN_OPS = SplitBNOps(bn_stats_sums_plain, bn_relu_fwd_split_plain, bn_relu_bwd_sums_plain,
                             bn_relu_bwd_apply_split_plain)


class SyncBNRelu(torch.autograd.Function):
    """Train-mode ``max(BatchNorm(y), 0)`` of W shares ``y_w`` with the
    statistics of all of them (and of other processes' shares, through the
    reducer: ``reducer.sum(parts)`` gives each share of this process the sum
    of every share's (2, C) float64 sums on that share's device;
    ``reducer.processes`` is the number of processes whose shares take
    part, the shares being equal). Inputs: ``ys``, the shares' weights, the
    shares' biases (each a copy of the layer's on its share's device), then
    the running mean and variance, updated once, by the first share. Saves
    each ``y_w``, the statistics its own normalise wrote, and its bias."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        reducer, ops = meta
        W = (len(tensors) - 2) // 3
        ys, weights, biases = tensors[:W], tensors[W:2 * W], tensors[2 * W:3 * W]
        running_mean, running_var = tensors[3 * W:]
        n = sum(_rows(y) for y in ys) * reducer.processes
        totals = reducer.sum([ops.sums(y) for y in ys])
        outs, sts = [], []
        for i, (y, w, b, total) in enumerate(zip(ys, weights, biases, totals)):
            running = (running_mean, running_var) if i == 0 else (None, None)
            out, st = ops.fwd(y, w, b, total, n, *running)
            outs.append(out)
            sts.append(st)
        ctx.save_for_backward(*ys, *sts, *biases)
        ctx.meta, ctx.n, ctx.W = meta, n, W
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        (reducer, ops), W = ctx.meta, ctx.W
        saved = ctx.saved_tensors
        ys, sts, biases = saved[:W], saved[W:2 * W], saved[2 * W:]
        # autograd sums the gradients of a skip connection in whatever
        # layout they come; the kernels read channels_last
        gs = [g.contiguous(memory_format=torch.channels_last) for g in gs]
        local = [ops.bwd_sums(g, y, st, b) for g, y, st, b in zip(gs, ys, sts, biases)]
        totals = reducer.sum(local)
        dgamma, dbeta, dys = [], [], []
        for g, y, st, b, own, total in zip(gs, ys, sts, biases, local, totals):
            dy, dg, db = ops.bwd_apply(g, y, st, b, own, total, ctx.n)
            dys.append(dy)
            dgamma.append(dg)
            dbeta.append(db)
        return (None, *dys, *dgamma, *dbeta, None, None)


def split_bn_relu_train(ys: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor], running_mean, running_var, reducer,
                        ops: Optional[SplitBNOps] = None) -> List[torch.Tensor]:
    """Train-mode BatchNorm + ReLU of the shares ``ys`` (one per mesh entry of
    this process) through the split kernels, synchronised by ``reducer``;
    one output per share. ``ops`` defaults to ``SPLIT_KERNEL_OPS`` (the
    kernels, whose wrappers run their plain versions on CPU tensors)."""
    ops = SPLIT_KERNEL_OPS if ops is None else ops
    return list(SyncBNRelu.apply((reducer, ops), *ys, *weights, *biases, running_mean,
                                 running_var))


def sync_bn_relu_train(ys: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], running_mean, running_var,
                       reducer) -> List[torch.Tensor]:
    """The layer's train-mode op over shares: ``bn_relu_train`` where one
    share of one process holds the whole batch, else
    ``split_bn_relu_train``."""
    if len(ys) == 1 and reducer.processes == 1:
        return [bn_relu_train(ys[0], weights[0], biases[0], running_mean, running_var)]
    return split_bn_relu_train(ys, weights, biases, running_mean, running_var, reducer)
