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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from . import cuda_build

SOURCE = "batchnorm.cu"
MOMENTUM = 0.9
EPS = 1e-5
LAUNCHES = {"bn_stats": 0, "bn_relu_fwd": 0, "bn_relu_bwd_reduce": 0, "bn_relu_bwd_apply": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# the kernels' C entry points per dtype: bfloat16 on the train path,
# float32 for parity runs
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_THREADS = 256  # a block of csrc/batchnorm.cu; the 16-byte groups of a row must divide it


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


@torch.no_grad()
def bn_stats_plain(y, weight, running_mean, running_var, momentum=MOMENTUM, eps=EPS):
    """Statistics ``st`` (4, C) of ``y`` over (N, H, W) and the running
    update in place (the kernel ``bn_stats``'s function); float32
    statistics, float64 for a float64 ``y``."""
    sd = torch.promote_types(y.dtype, torch.float32)
    yd = y.to(torch.float64)
    n = _rows(y)
    mean = yd.sum((0, 2, 3)) / n
    diff = (yd.square().sum((0, 2, 3)) / n - mean * mean).to(sd)
    mean = mean.to(sd)
    var = diff.clamp_min(0.0)
    r = 1.0 / torch.sqrt(var + eps)
    running_mean.mul_(momentum).add_(mean * (1.0 - momentum))
    running_var.mul_(momentum).add_(var * (1.0 - momentum))
    return torch.stack([mean, diff, r, r * weight])


def _z(y, st, bias):
    """``(y - mean) * inv + bias`` in the statistics' dtype."""
    return (y.to(st.dtype) - _c(st[0])) * _c(st[3]) + _c(bias)


def bn_relu_fwd_plain(y, st, bias):
    """``cast(max((y - mean) * inv + bias, 0))`` (the kernel ``bn_relu_fwd``)."""
    return _z(y, st, bias).clamp_min(0.0).to(y.dtype)


def bn_relu_bwd_reduce_plain(g, y, st, bias, train: bool):
    """(dgamma, dbeta, coef (2, C)) from the output gradient ``g`` (the
    kernel ``bn_relu_bwd_reduce``); ``coef`` = (c1, c2) is 0 in eval mode."""
    sd = st.dtype
    gz = g.to(sd) * _relu_grad(_z(y, st, bias))
    yc = y.to(sd) - _c(st[0])
    s = gz.sum((0, 2, 3), dtype=torch.float64)
    q = (gz * yc).sum((0, 2, 3), dtype=torch.float64)
    diff, r = st[1], st[2]
    coef = torch.zeros((2, st.shape[1]), dtype=sd, device=st.device)
    if train:
        n = _rows(y)
        k = _relu_grad(diff)  # the clamp max(diff, 0), differentiated alike
        coef[0] = (s / n).to(sd)
        coef[1] = k * (r * r) * (q / n).to(sd)
    return q.to(sd) * r, s.to(sd), coef


def bn_relu_bwd_apply_plain(g, y, st, bias, coef):
    """``dy = cast(inv * ((gz - c1) - (y - mean) * c2))`` (the kernel
    ``bn_relu_bwd_apply``)."""
    sd = st.dtype
    gz = g.to(sd) * _relu_grad(_z(y, st, bias))
    yc = y.to(sd) - _c(st[0])
    return (_c(st[3]) * ((gz - _c(coef[0])) - yc * _c(coef[1]))).to(y.dtype)


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

