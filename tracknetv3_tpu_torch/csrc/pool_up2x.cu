// 2x2 max pool and nearest-2x upsample of NHWC activations (bfloat16 on
// the serving path, float32 for parity runs), for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (tracknetv3_tpu_torch/ops/pool_up2x.py).
//
// Replaces the JAX package's Pallas TPU kernels in tools/probe_bn_pool.py:
//   maxpool2x2_nhwc_{bf16,f32}    <- pool_kernel (launched by pool_pl, :211)
//   up2x_nearest_nhwc_{bf16,f32}  <- up_kernel   (launched by up2x_pl, :243)
// which were written for the serving forward's _pool
// (tracknetv3_tpu/models/fused_forward.py:82) and _up2x
// (tracknetv3_tpu/models/tracknet.py:81).
//
// Function.
//   pool: y[n, i, j, c] = max of x[n, 2i + a, 2j + b, c] over a, b in {0, 1},
//         NaN if any of the four is NaN (lax.max and F.max_pool2d both
//         propagate NaN; so do __hmax2_nan and max_nan below).
//   up2x: y[n, 2i + a, 2j + b, c] = x[n, i, j, c]: interleaved duplication,
//         the broadcast-and-reshape of _up2x (not a tiling of rows).
// Both are exact: a max and a copy.
//
// Design. Bound on the H100 SXM by bytes: each reads its input once and
// writes its output once, with no arithmetic to speak of. One thread owns
// one 16-byte group of channels (8 bf16 or 4 float32) of one output pixel
// (pool) or one input pixel (up2x), so every load and store is one 16-byte
// vector access and neighbouring threads touch neighbouring 16-byte chunks
// of a pixel's channels. pool: four 16-byte loads, one store; up2x: one
// load, four stores (a copy, so one kernel serves both types). Requires a
// channel row of a multiple of 16 bytes, even H and W for the pool, and
// 16-byte aligned base pointers (the wrapper checks all of it). This is
// the simple, right first version; fusing up2x into the concat buffer is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Lane-wise NaN-propagating max of two 16-byte vectors of T.
template <typename T>
__device__ __forceinline__ uint4 max16(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 max16<__nv_bfloat16>(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = __hmax2_nan(pa[i], pb[i]);
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

template <>
__device__ __forceinline__ uint4 max16<float>(uint4 a, uint4 b) {
  return make_uint4(__float_as_uint(max_nan(__uint_as_float(a.x), __uint_as_float(b.x))),
                    __float_as_uint(max_nan(__uint_as_float(a.y), __uint_as_float(b.y))),
                    __float_as_uint(max_nan(__uint_as_float(a.z), __uint_as_float(b.z))),
                    __float_as_uint(max_nan(__uint_as_float(a.w), __uint_as_float(b.w))));
}

// x: (N, H, W, C) -> y: (N, H/2, W/2, C); one thread per output pixel and
// 16 bytes of channels; C8 = 16-byte units per pixel, ``total`` =
// N * H/2 * W/2 * C8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool2x2_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int64_t total,
                      int OH, int OW, int C8) {
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total) return;
  const int c8 = (int)(q % C8);
  int64_t p = q / C8;
  const int ow = (int)(p % OW);
  p /= OW;
  const int oh = (int)(p % OH);
  const int64_t n = p / OH;
  const int64_t W = 2 * (int64_t)OW;
  // in 16-byte units: one pixel is C8 units, one input row W * C8
  const int64_t row = W * C8;
  const int64_t i00 = ((n * 2 * OH + 2 * oh) * W + 2 * ow) * C8 + c8;
  const uint4 a = x[i00], b = x[i00 + C8], c = x[i00 + row], d = x[i00 + row + C8];
  y[q] = max16<T>(max16<T>(a, b), max16<T>(c, d));
}

// x: (N, h, w, C) -> y: (N, 2h, 2w, C); one thread per input pixel and 16
// bytes of channels; C8 = 16-byte units per pixel, ``total`` = N * h * w * C8.
__global__ void __launch_bounds__(kThreads)
    up2x_nearest_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int64_t total,
                        int h, int w, int C8) {
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total) return;
  const int c8 = (int)(q % C8);
  int64_t p = q / C8;
  const int iw = (int)(p % w);
  p /= w;
  const int ih = (int)(p % h);
  const int64_t n = p / h;
  const int64_t OW = 2 * (int64_t)w;
  const int64_t row = OW * C8;
  const int64_t o00 = ((n * 2 * h + 2 * ih) * OW + 2 * iw) * C8 + c8;
  const uint4 v = x[q];
  y[o00] = v;
  y[o00 + C8] = v;
  y[o00 + row] = v;
  y[o00 + row + C8] = v;
}

inline unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

template <typename T>
int maxpool2x2(const void* x, void* y, int N, int H, int W, int C, void* stream) {
  const int OH = H / 2, OW = W / 2, C8 = C * (int)sizeof(T) / 16;
  const int64_t total = (int64_t)N * OH * OW * C8;
  if (total == 0) return 0;
  maxpool2x2_kernel<T><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)y, total, OH, OW, C8);
  return (int)cudaGetLastError();
}

int up2x_nearest(const void* x, void* y, int N, int h, int w, int row_bytes, void* stream) {
  const int C8 = row_bytes / 16;
  const int64_t total = (int64_t)N * h * w * C8;
  if (total == 0) return 0;
  up2x_nearest_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)y, total, h, w, C8);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (N, H/2, W/2, C) = 2x2 max pool of x (N, H, W, C), NHWC.
int maxpool2x2_nhwc_bf16(const void* x, void* y, int N, int H, int W, int C, void* stream) {
  return maxpool2x2<__nv_bfloat16>(x, y, N, H, W, C, stream);
}
int maxpool2x2_nhwc_f32(const void* x, void* y, int N, int H, int W, int C, void* stream) {
  return maxpool2x2<float>(x, y, N, H, W, C, stream);
}

// y (N, 2h, 2w, C) = nearest 2x upsample of x (N, h, w, C), NHWC.
int up2x_nearest_nhwc_bf16(const void* x, void* y, int N, int h, int w, int C,
                           void* stream) {
  return up2x_nearest(x, y, N, h, w, 2 * C, stream);
}
int up2x_nearest_nhwc_f32(const void* x, void* y, int N, int h, int w, int C,
                          void* stream) {
  return up2x_nearest(x, y, N, h, w, 4 * C, stream);
}

}  // extern "C"
