// BatchNorm + ReLU of the TrackNet train and eval steps, forward and
// backward, for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/batchnorm.py).
//
// Replaces the JAX package's Pallas TPU kernels in tools/probe_bn_pool.py,
// written for the train step's BatchNorm epilogue
// (tracknetv3_tpu/models/fused_forward.py:285-332):
//   bn_stats_{bf16,f32}            <- stats_kernel (:128, launched by stats_pl, :144)
//   bn_relu_fwd_{bf16,f32}         <- norm_kernel  (:167, launched by norm_pl, :173)
//   bn_relu_bwd_reduce_{bf16,f32}  <- the gradient of both (JAX takes it from
//   bn_relu_bwd_apply_{bf16,f32}      autodiff; there is no Pallas source)
// and, for data-parallel training, the two reductions split at their sums so
// that the sums of the shares of a global batch can be added up between the
// halves (JAX gets this from GSPMD: the batch mean of a sharded array is an
// all-reduce):
//   bn_stats_sums_{bf16,f32}       <- stats_kernel's sums (P4), one launch
//   bn_relu_fwd_split_{bf16,f32}   <- the rest of P4 from summed sums, and
//                                     norm_kernel (P5), one launch
//   bn_relu_bwd_sums_{bf16,f32}    <- the gradient's sums
//   bn_relu_bwd_apply_split_{bf16,f32}
//                                  <- dgamma, dbeta, the coefficients and dy
//
// Function. y is a conv output (rows, C), rows = N*H*W (an NCHW view with
// channels_last memory), bfloat16 on the train path, float32 for parity
// runs. Per channel, with n = rows and float32 arithmetic unless said:
//   stats:  mean = sum(y) / n, diff = sum(y^2) / n - mean^2 (sums and
//           diff in double, then rounded), var = max(diff, 0),
//           r = 1 / sqrt(var + eps), inv = r * gamma; running_mean and
//           running_var <- momentum * old + (1 - momentum) * (mean, var).
//   fwd:    z = (y - mean) * inv + beta, out = cast(max(z, 0)), NaN kept.
//   reduce: gz = g * (z > 0 ? 1 : z == 0 ? 0.5 : 0) -- jnp.maximum's
//           gradient, which passes half at a tie -- and, with yc = y - mean,
//           Sg = sum(gz), Sgy = sum(gz * yc) in double; dbeta = Sg,
//           dgamma = Sgy * r; c1 = Sg / n and c2 = k * r^2 * Sgy / n, where
//           k = 1, 0.5 or 0 as diff > 0, == 0 or < 0 (the clamp's gradient,
//           again halved at a tie). Eval mode normalises with the running
//           statistics, which are constants: c1 = c2 = 0.
//   apply:  dy = cast(inv * ((gz - c1) - yc * c2)).
// Split: sums (2, C) double = (sum y, sum y^2) forward and (Sg, Sgy)
// backward over one share's rows; fwd_split takes summed sums and the global
// row count n, computes the statistics as stats does and normalises as fwd
// does; apply_split takes dgamma and dbeta from one share's own sums (each
// share's gradient is summed later with the others') and c1, c2 from the
// summed ones, then applies them as apply does. The backward's sums
// keep the unsplit reduction's fixed order. The forward's sums add every
// element as the unsplit partial pass does (cvt, add, fma in double) but
// combine the blocks in an order of their own (below), so they may differ
// from the unsplit statistics' sums in the last bits of the float64 sums:
// repeated launches on equal inputs give equal bits, and the sums stay
// within 1e-12 of the plain version. The rest of the split path, given equal
// sums, computes the unsplit one's every bit.
// Every rounding is written out (__fsub_rn, __fmul_rn, __fadd_rn): nvcc
// would contract a*b + c into an FMA, and then the backward's ReLU mask
// could disagree with the forward's z at the boundary. The plain versions
// in batchnorm.py repeat the same roundings. No --use_fast_math.
//
// Design. Bound on the H100 SXM by bytes (3.35 TB/s); arithmetic per
// element is a handful of operations. One thread owns one 16-byte group of
// channels (8 bf16 or 4 float32) of a row, so each load and store is one
// 16-byte vector access and neighbouring threads read neighbouring bytes.
// A block of 256 threads covers 256 / G rows at a time (G = 16-byte groups
// per row, which must divide 256). The two reductions (stats, reduce):
// a thread adds each element into a double accumulator (so 1.47 M rows of
// one channel neither cancel in E[y^2] - mean^2 nor lose a gradient sum
// that cancels; the conversions and double adds hide under the loads),
// the block combines its rows in shared memory in a fixed order and writes
// one double partial per channel; a finalize kernel sums the partials in a
// fixed order and computes the per-channel results. No
// float atomics: a run repeats bit for bit on a card. The reductions take
// one wave of resident blocks, so each block walks many rows and the
// finalize reads few partials. The elementwise kernels (fwd,
// apply) walk the rows with a grid stride that is a multiple of G, so each
// thread loads its channels' constants once. This is the simple, right
// first version: one read of y for the statistics and one for the
// normalise, one read of g and y for each backward kernel. The backward's
// split sums reuse its partial pass and end in a sum kernel instead of the
// finalize.
//
// The forward's split sums are one launch (bn_stats_sums_kernel). Two
// launches (the partial pass, then a sum kernel of (C + 31) / 32 blocks whose
// warps walked up to 132 partials in a dependent chain) left a fixed tail
// per layer that half a batch could not hide. Here a grid of thread block
// clusters, about two blocks an SM (one wave: the wrapper sizes it from the
// card's resident clusters), walks the rows, kBatch 16-byte loads in flight
// per thread. A block combines its rows by a shuffle-xor tree in each warp
// and its warps in shared memory, in place; a cluster adds its blocks'
// partials through distributed shared memory, each block a slice of the 2C
// sums, so only one partial per cluster reaches device memory; per slice
// the last block to arrive adds the clusters' partials, every thread taking
// a share. The split backward's apply computes the coefficients itself, in
// every block, from the (2, C) sums: the finalize launch and its (2, C)
// coefficients in device memory are gone; the two double divisions a channel
// and block are what that costs. The split forward's normalise does the same
// with the statistics: every block computes mean and inv of all channels from
// the summed sums (fwd_finalize_channel, the unsplit finalize's own body), and
// block 0 writes st (4, C) for the backward and the running update, so each
// share computes its own st in its own normalise: no finalize launch (a
// latency-bound 3 us a layer) and no copy of st to the other shares.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinRows = 16;      // rows a thread of a reduction walks at least
constexpr int kMaxBlocks = 1056;  // 8 blocks of 256 threads fill each of an H100's 132 SMs
constexpr int kFinalizeWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks of a cluster of the split forward's sums
constexpr int kBatch = 8;    // rows a thread of the split forward's sums loads at once

// values of T in one 16-byte group
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
};
template <>
struct Pack<float> {
  static constexpr int n = 4;
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <typename T>
__device__ __forceinline__ void load_pack(const uint4* __restrict__ p, int64_t i, float* f) {
  unpack<T>(p[i], f);
}

template <typename T>
__device__ __forceinline__ void store_pack(uint4* __restrict__ p, int64_t i, const float* f);

template <>
__device__ __forceinline__ void store_pack<__nv_bfloat16>(uint4* __restrict__ p, int64_t i,
                                                          const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  p[i] = v;
}

template <>
__device__ __forceinline__ void store_pack<float>(uint4* __restrict__ p, int64_t i,
                                                  const float* f) {
  p[i] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// z = (y - mean) * inv + beta, rounded as the plain version rounds it
__device__ __forceinline__ float bn_z(float y, float mean, float inv, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(y, mean), inv), beta);
}

// max(z, 0) with NaN kept, as jnp.maximum and torch.clamp_min do
__device__ __forceinline__ float relu(float z) { return (z > 0.f || z != z) ? z : 0.f; }

// d max(z, 0) / dz as jnp.maximum differentiates it: half at a tie
__device__ __forceinline__ float relu_grad(float z) {
  return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
}

// Blocks of ``kernel`` the card keeps resident at once (one wave), at most
// kMaxBlocks.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int n = sms * per_sm;
  return n < 1 ? 1 : (n > kMaxBlocks ? kMaxBlocks : n);
}

// Row blocks of a reduction over ``rows`` rows of G 16-byte groups: one
// wave of ``resident`` blocks, fewer where a thread would walk less than
// kMinRows rows.
inline int reduce_blocks(int resident, int64_t rows, int G) {
  const int64_t rows_per_pass = (int64_t)(kThreads / G) * kMinRows;
  const int64_t want = (rows + rows_per_pass - 1) / rows_per_pass;
  return (int)(want < 1 ? 1 : (want > resident ? resident : want));
}

inline unsigned int apply_blocks(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (unsigned int)(want > kMaxBlocks ? kMaxBlocks : want);
}

// Block combine of the threads' two double sums per channel, fixed order;
// writes part[(blockIdx.x * 2 + {0, 1}) * C + c].
template <int P>
__device__ __forceinline__ void block_partials(const double (&a)[P], const double (&b)[P], int G,
                                               double* __restrict__ part) {
  __shared__ double sh[2 * kThreads * P];
  const int C = G * P, R = kThreads / G;
  const int g = threadIdx.x % G, lr = threadIdx.x / G;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    sh[lr * C + g * P + j] = a[j];
    sh[R * C + lr * C + g * P + j] = b[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    double s = 0.0, q = 0.0;
    for (int k = 0; k < R; ++k) {
      s += sh[k * C + c];
      q += sh[R * C + k * C + c];
    }
    part[((int64_t)blockIdx.x * 2) * C + c] = s;
    part[((int64_t)blockIdx.x * 2 + 1) * C + c] = q;
  }
}

// Sums of the partials of channel c = blockIdx.x * 32 + lane over the
// row blocks, in a fixed order; valid in warp 0 of the block.
__device__ __forceinline__ void sum_partials(const double* __restrict__ part, int nblk, int C,
                                             double& s, double& q) {
  __shared__ double sh[2][kFinalizeWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  s = 0.0;
  q = 0.0;
  if (c < C) {
#pragma unroll 8  // loads of eight row blocks in flight; the sum keeps its order
    for (int b = w; b < nblk; b += kFinalizeWarps) {
      s += part[((int64_t)b * 2) * C + c];
      q += part[((int64_t)b * 2 + 1) * C + c];
    }
  }
  sh[0][w][lane] = s;
  sh[1][w][lane] = q;
  __syncthreads();
  s = 0.0;
  q = 0.0;
  if (w == 0) {
    for (int k = 0; k < kFinalizeWarps; ++k) {
      s += sh[0][k][lane];
      q += sh[1][k][lane];
    }
  }
}

// ---------------------------------------------------------------- kernels

// Per-block sums of y and y^2 per channel, in double.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_stats_partial_kernel(const uint4* __restrict__ y, double* __restrict__ part, int64_t rows,
                            int G, int64_t rows_per_block) {
  constexpr int P = Pack<T>::n;
  const int g = threadIdx.x % G, lr = threadIdx.x / G, R = kThreads / G;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  double ds[P], dq[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ds[j] = dq[j] = 0.0;
#pragma unroll 4  // loads of four rows in flight
  for (int64_t r = r0 + lr; r < r1; r += R) {
    float f[P];
    load_pack<T>(y, r * G + g, f);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const double v = (double)f[j];
      ds[j] += v;
      dq[j] = fma(v, v, dq[j]);  // v * v is exact in double
    }
  }
  block_partials<P>(ds, dq, G, part);
}

// Channel c's statistics from its sums (s, q) over n rows: mean and inv;
// where st is not null also its column of st (4, C) = mean, diff, r, inv and,
// where running_mean is not null too, the running update in place.
__device__ __forceinline__ void fwd_finalize_channel(int c, int C, double s, double q, double n,
                                                     const float* __restrict__ gamma, float eps,
                                                     float* __restrict__ st,
                                                     float* __restrict__ running_mean,
                                                     float* __restrict__ running_var,
                                                     float momentum, float one_minus_momentum,
                                                     float& mean, float& inv) {
  const double md = s / n;
  mean = (float)md;
  const float diff = (float)(q / n - md * md);
  const float var = relu(diff);
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  inv = __fmul_rn(r, gamma[c]);
  if (st == nullptr) return;
  st[c] = mean;
  st[C + c] = diff;
  st[2 * C + c] = r;
  st[3 * C + c] = inv;
  if (running_mean == nullptr) return;
  running_mean[c] =
      __fadd_rn(__fmul_rn(running_mean[c], momentum), __fmul_rn(mean, one_minus_momentum));
  running_var[c] =
      __fadd_rn(__fmul_rn(running_var[c], momentum), __fmul_rn(var, one_minus_momentum));
}

// mean, diff, r, inv into st (4, C); the running update in place.
__global__ void __launch_bounds__(kThreads)
    bn_stats_finalize_kernel(const double* __restrict__ part, int nblk, int C, double n,
                             const float* __restrict__ gamma, float* __restrict__ running_mean,
                             float* __restrict__ running_var, float* __restrict__ st, float eps,
                             float momentum, float one_minus_momentum) {
  double s, q;
  sum_partials(part, nblk, C, s, q);
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x >= 32 || c >= C) return;
  float mean, inv;
  fwd_finalize_channel(c, C, s, q, n, gamma, eps, st, running_mean, running_var, momentum,
                       one_minus_momentum, mean, inv);
}

// out = cast(max((y - mean) * inv + beta, 0)); st rows 0 and 3 are mean, inv.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_fwd_kernel(const uint4* __restrict__ y, uint4* __restrict__ out, int64_t total, int G,
                       const float* __restrict__ st, const float* __restrict__ beta) {
  constexpr int P = Pack<T>::n;
  const int C = G * P;
  const int g = threadIdx.x % G;  // the grid stride is a multiple of G
  float m[P], a[P], b[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = g * P + j;
    m[j] = st[c];
    a[j] = st[3 * C + c];
    b[j] = beta[c];
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    float f[P];
    load_pack<T>(y, i, f);
#pragma unroll
    for (int j = 0; j < P; ++j) f[j] = relu(bn_z(f[j], m[j], a[j], b[j]));
    store_pack<T>(out, i, f);
  }
}

// The split forward's normalise: mean and inv of every channel from the
// summed sums ``sums`` over n rows into shared memory, rounded as
// bn_stats_finalize_kernel rounds them, then out as bn_relu_fwd_kernel; block
// 0 also writes st and, where running_mean is not null, the running update.
// No block reads what block 0 writes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_fwd_split_kernel(const uint4* __restrict__ y, uint4* __restrict__ out, int64_t total,
                             int G, const double* __restrict__ sums, double n,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             float* __restrict__ running_mean, float* __restrict__ running_var,
                             float* __restrict__ st, float eps, float momentum,
                             float one_minus_momentum) {
  constexpr int P = Pack<T>::n;
  __shared__ float mi[2 * kThreads * P];  // mean (C), then inv (C)
  const int C = G * P;
  float* const st0 = blockIdx.x == 0 ? st : nullptr;
  for (int c = threadIdx.x; c < C; c += kThreads)
    fwd_finalize_channel(c, C, sums[c], sums[C + c], n, gamma, eps, st0, running_mean,
                         running_var, momentum, one_minus_momentum, mi[c], mi[C + c]);
  __syncthreads();
  const int g = threadIdx.x % G;  // the grid stride is a multiple of G
  float m[P], a[P], b[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = g * P + j;
    m[j] = mi[c];
    a[j] = mi[C + c];
    b[j] = beta[c];
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    float f[P];
    load_pack<T>(y, i, f);
#pragma unroll
    for (int j = 0; j < P; ++j) f[j] = relu(bn_z(f[j], m[j], a[j], b[j]));
    store_pack<T>(out, i, f);
  }
}

// Per-block sums of gz and gz * (y - mean) per channel, in double (the
// product rounded to float32 first, as the plain version rounds it).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_partial_kernel(const uint4* __restrict__ gr, const uint4* __restrict__ y,
                               double* __restrict__ part, int64_t rows, int G,
                               int64_t rows_per_block, const float* __restrict__ st,
                               const float* __restrict__ beta) {
  constexpr int P = Pack<T>::n;
  const int C = G * P;
  const int g = threadIdx.x % G, lr = threadIdx.x / G, R = kThreads / G;
  float m[P], a[P], b[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = g * P + j;
    m[j] = st[c];
    a[j] = st[3 * C + c];
    b[j] = beta[c];
  }
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  double ds[P], dq[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ds[j] = dq[j] = 0.0;
#pragma unroll 4  // loads of four rows in flight
  for (int64_t r = r0 + lr; r < r1; r += R) {
    float fg[P], fy[P];
    load_pack<T>(gr, r * G + g, fg);
    load_pack<T>(y, r * G + g, fy);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float gz = __fmul_rn(fg[j], relu_grad(bn_z(fy[j], m[j], a[j], b[j])));
      ds[j] += (double)gz;
      dq[j] += (double)__fmul_rn(gz, __fsub_rn(fy[j], m[j]));
    }
  }
  block_partials<P>(ds, dq, G, part);
}

// Channel c's dgamma and dbeta from the sums (s, q).
__device__ __forceinline__ void bwd_param_grads(int c, int C, double s, double q,
                                                const float* __restrict__ st,
                                                float* __restrict__ dgamma,
                                                float* __restrict__ dbeta) {
  dbeta[c] = (float)s;
  dgamma[c] = __fmul_rn((float)q, st[2 * C + c]);
}

// Channel c's apply coefficients (c1, c2) from the sums (S, Q) over n rows
// into coef (2, C); 0 in eval mode.
__device__ __forceinline__ void bwd_coef(int c, int C, double S, double Q, double n,
                                         const float* __restrict__ st, float* coef, int train) {
  const float diff = st[C + c], r = st[2 * C + c];
  float c1 = 0.f, c2 = 0.f;
  if (train) {
    const float k = diff > 0.f ? 1.f : (diff == 0.f ? 0.5f : 0.f);
    c1 = (float)(S / n);
    c2 = __fmul_rn(__fmul_rn(k, __fmul_rn(r, r)), (float)(Q / n));
  }
  coef[c] = c1;
  coef[C + c] = c2;
}

// Channel c's dgamma and dbeta from the sums (s, q), and its apply
// coefficients (c1, c2) from the sums (S, Q) over n rows.
__device__ __forceinline__ void bwd_finalize_channel(int c, int C, double s, double q, double S,
                                                     double Q, double n,
                                                     const float* __restrict__ st,
                                                     float* __restrict__ dgamma,
                                                     float* __restrict__ dbeta,
                                                     float* __restrict__ coef, int train) {
  bwd_param_grads(c, C, s, q, st, dgamma, dbeta);
  bwd_coef(c, C, S, Q, n, st, coef, train);
}

// dgamma, dbeta and the apply coefficients coef (2, C) = (c1, c2).
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_finalize_kernel(const double* __restrict__ part, int nblk, int C, double n,
                                const float* __restrict__ st, float* __restrict__ dgamma,
                                float* __restrict__ dbeta, float* __restrict__ coef, int train) {
  double s, q;
  sum_partials(part, nblk, C, s, q);
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x >= 32 || c >= C) return;
  bwd_finalize_channel(c, C, s, q, s, q, n, st, dgamma, dbeta, coef, train);
}

// The partials' sums (2, C) in the fixed order of the finalize kernels.
__global__ void __launch_bounds__(kThreads)
    bn_sums_kernel(const double* __restrict__ part, int nblk, int C, double* __restrict__ sums) {
  double s, q;
  sum_partials(part, nblk, C, s, q);
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x >= 32 || c >= C) return;
  sums[c] = s;
  sums[C + c] = q;
}

// The split forward's sums (2, C) = (sum y, sum y^2) of one share in one
// launch. Clusters of kCluster blocks; block b of the grid takes rows
// [b * rows_per_block, (b + 1) * rows_per_block), each thread every R-th of
// them (R = rows a block covers at a time) in order, loading kBatch rows
// before it adds them, in double as the partial pass does. In the block:
// the rows of a warp by a shuffle-xor tree (G < 32), then the warps (or,
// for G >= 32, the rows) in order, in place in shared memory. In the
// cluster: block rank k adds slice k of the 2C sums over the kCluster
// blocks' shared memory in rank order and writes it to cpart[cluster]. Across
// clusters: per slice, the last block to take its ticket (after
// __threadfence; an int atomic, no float atomics) adds the slice over the
// clusters in a fixed order (S threads an output, each every S-th cluster in
// order, then the S in order), writes it to sums and resets the ticket. The
// order depends on the block index and the grid alone, never on arrival.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bn_stats_sums_kernel(const uint4* __restrict__ y, double* __restrict__ cpart,
                         int* __restrict__ tickets, double* __restrict__ sums, int64_t rows,
                         int G, int64_t rows_per_block) {
  constexpr int P = Pack<T>::n;
  __shared__ double sh[2 * kThreads * P];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = G * P, R = kThreads / G;
  const int g = threadIdx.x % G, lr = threadIdx.x / G;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  double ds[P], dq[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ds[j] = dq[j] = 0.0;
  for (int64_t r = r0 + lr; r < r1; r += (int64_t)kBatch * R) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (r + (int64_t)u * R < r1) v[u] = y[(r + (int64_t)u * R) * G + g];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r + (int64_t)u * R < r1) {
        float f[P];
        unpack<T>(v[u], f);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const double d = (double)f[j];
          ds[j] += d;
          dq[j] = fma(d, d, dq[j]);  // d * d is exact in double
        }
      }
    }
  }
  // the block: K slots of C channels (the warps, or the rows when a warp
  // holds less than a row), summed in slot order into slot 0
  const int lane = threadIdx.x & 31;
  int K, k;
  bool writes;
  if (G < 32) {
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        ds[j] += __shfl_xor_sync(0xffffffffu, ds[j], off);
        dq[j] += __shfl_xor_sync(0xffffffffu, dq[j], off);
      }
    }
    K = kThreads / 32;
    k = threadIdx.x >> 5;
    writes = lane < G;
  } else {
    K = R;
    k = lr;
    writes = true;
  }
  if (writes) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sh[k * C + g * P + j] = ds[j];
      sh[K * C + k * C + g * P + j] = dq[j];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    double* col = sh + (o / C) * K * C + o % C;
    double acc = col[0];
    for (int kk = 1; kk < K; ++kk) acc += col[kk * C];
    col[0] = acc;
  }
  // the cluster: this block's slice of the 2C sums over its blocks
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int O = 2 * C / kCluster;  // outputs of a slice
  const int64_t cl = blockIdx.x / kCluster;
  for (int i = threadIdx.x; i < O; i += kThreads) {
    const int o = rank * O + i;
    const int at = (o / C) * K * C + o % C;
    double v[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) v[q] = cluster.map_shared_rank(sh, q)[at];
    double acc = v[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) acc += v[q];
    cpart[cl * 2 * C + o] = acc;
  }
  __threadfence();
  cluster.sync();  // the cluster's reads of this block's shared memory are done
  const int clusters = gridDim.x / kCluster;
  if (threadIdx.x == 0) last = atomicAdd(tickets + rank, 1) == clusters - 1;
  __syncthreads();
  if (!last) return;
  // the last block of this slice: the slice over the clusters
  __threadfence();
  const int Oc = O < kThreads ? O : kThreads;  // outputs a round
  const int S = kThreads / Oc;                 // threads an output
  const int io = threadIdx.x % Oc, t = threadIdx.x / Oc;
  for (int base = 0; base < O; base += Oc) {
    const int o = rank * O + base + io;
    double acc = 0.0;
    for (int c0 = t; c0 < clusters; c0 += kBatch * S) {
      double v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = c0 + u * S < clusters ? __ldcg(cpart + (int64_t)(c0 + u * S) * 2 * C + o) : 0.0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc += v[u];
    }
    sh[t * Oc + io] = acc;
    __syncthreads();
    if (t == 0) {
      double tot = sh[io];
      for (int tt = 1; tt < S; ++tt) tot += sh[tt * Oc + io];
      sums[o] = tot;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) tickets[rank] = 0;
}

// The split backward's apply: the coefficients (c1, c2) of every channel
// from the summed sums ``total`` over n rows into shared memory, rounded as
// bwd_finalize_channel rounds them, then dy as bn_relu_bwd_apply_kernel;
// block 0 also writes dgamma and dbeta from the share's own sums ``local``.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_apply_split_kernel(const uint4* __restrict__ gr, const uint4* __restrict__ y,
                                   uint4* __restrict__ dy, int64_t total, int G,
                                   const float* __restrict__ st, const float* __restrict__ beta,
                                   const double* __restrict__ local,
                                   const double* __restrict__ summed, double n,
                                   float* __restrict__ dgamma, float* __restrict__ dbeta) {
  constexpr int P = Pack<T>::n;
  __shared__ float coef[2 * kThreads * P];
  const int C = G * P;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    bwd_coef(c, C, summed[c], summed[C + c], n, st, coef, 1);
    if (blockIdx.x == 0) bwd_param_grads(c, C, local[c], local[C + c], st, dgamma, dbeta);
  }
  __syncthreads();
  const int g = threadIdx.x % G;  // the grid stride is a multiple of G
  float m[P], a[P], b[P], c1[P], c2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = g * P + j;
    m[j] = st[c];
    a[j] = st[3 * C + c];
    b[j] = beta[c];
    c1[j] = coef[c];
    c2[j] = coef[C + c];
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    float fg[P], fy[P];
    load_pack<T>(gr, i, fg);
    load_pack<T>(y, i, fy);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float gz = __fmul_rn(fg[j], relu_grad(bn_z(fy[j], m[j], a[j], b[j])));
      const float yc = __fsub_rn(fy[j], m[j]);
      fg[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(gz, c1[j]), __fmul_rn(yc, c2[j])));
    }
    store_pack<T>(dy, i, fg);
  }
}

// dy = cast(inv * ((gz - c1) - (y - mean) * c2)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_apply_kernel(const uint4* __restrict__ gr, const uint4* __restrict__ y,
                             uint4* __restrict__ dy, int64_t total, int G,
                             const float* __restrict__ st, const float* __restrict__ beta,
                             const float* __restrict__ coef) {
  constexpr int P = Pack<T>::n;
  const int C = G * P;
  const int g = threadIdx.x % G;  // the grid stride is a multiple of G
  float m[P], a[P], b[P], c1[P], c2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = g * P + j;
    m[j] = st[c];
    a[j] = st[3 * C + c];
    b[j] = beta[c];
    c1[j] = coef[c];
    c2[j] = coef[C + c];
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    float fg[P], fy[P];
    load_pack<T>(gr, i, fg);
    load_pack<T>(y, i, fy);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float gz = __fmul_rn(fg[j], relu_grad(bn_z(fy[j], m[j], a[j], b[j])));
      const float yc = __fsub_rn(fy[j], m[j]);
      fg[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(gz, c1[j]), __fmul_rn(yc, c2[j])));
    }
    store_pack<T>(dy, i, fg);
  }
}

// ---------------------------------------------------------------- launchers

template <typename T>
int groups_of(int C) {
  return C * (int)sizeof(T) / 16;
}

template <typename T>
int stats(const void* y, double* part, const float* gamma, float* running_mean,
          float* running_var, float* st, int64_t rows, int C, float eps, float momentum,
          float one_minus_momentum, void* stream) {
  // the first card the process launches on sets the wave size for all
  static const int resident = resident_blocks(bn_stats_partial_kernel<T>);
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = groups_of<T>(C);
  const int nblk = reduce_blocks(resident, rows, G);
  const int64_t per_block = (rows + nblk - 1) / nblk;
  bn_stats_partial_kernel<T><<<nblk, kThreads, 0, s>>>((const uint4*)y, part, rows, G, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_stats_finalize_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(
      part, nblk, C, (double)rows, gamma, running_mean, running_var, st, eps, momentum,
      one_minus_momentum);
  return (int)cudaGetLastError();
}

template <typename T>
int relu_fwd(const void* y, void* out, const float* st, const float* beta, int64_t rows, int C,
             void* stream) {
  const int G = groups_of<T>(C);
  const int64_t total = rows * G;
  bn_relu_fwd_kernel<T><<<apply_blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)y, (uint4*)out, total, G, st, beta);
  return (int)cudaGetLastError();
}

template <typename T>
int relu_fwd_split(const void* y, void* out, const double* sums, double n, const float* gamma,
                   const float* beta, float* running_mean, float* running_var, float* st,
                   int64_t rows, int C, float eps, float momentum, float one_minus_momentum,
                   void* stream) {
  const int G = groups_of<T>(C);
  const int64_t total = rows * G;
  bn_relu_fwd_split_kernel<T><<<apply_blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)y, (uint4*)out, total, G, sums, n, gamma, beta, running_mean, running_var,
      st, eps, momentum, one_minus_momentum);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_reduce(const void* g, const void* y, double* part, const float* st, const float* beta,
               float* dgamma, float* dbeta, float* coef, int64_t rows, int C, int train,
               void* stream) {
  static const int resident = resident_blocks(bn_relu_bwd_partial_kernel<T>);
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = groups_of<T>(C);
  const int nblk = reduce_blocks(resident, rows, G);
  const int64_t per_block = (rows + nblk - 1) / nblk;
  bn_relu_bwd_partial_kernel<T><<<nblk, kThreads, 0, s>>>((const uint4*)g, (const uint4*)y, part,
                                                          rows, G, per_block, st, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_bwd_finalize_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(part, nblk, C, (double)rows,
                                                                 st, dgamma, dbeta, coef, train);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_apply(const void* g, const void* y, void* dy, const float* st, const float* beta,
              const float* coef, int64_t rows, int C, void* stream) {
  const int G = groups_of<T>(C);
  const int64_t total = rows * G;
  bn_relu_bwd_apply_kernel<T><<<apply_blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)g, (const uint4*)y, (uint4*)dy, total, G, st, beta, coef);
  return (int)cudaGetLastError();
}

// The launch of bn_stats_sums_kernel over ``clusters`` clusters.
cudaLaunchConfig_t sums_config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int sums_clusters(int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sums_config(1, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, bn_stats_sums_kernel<T>, &cfg);
}

template <typename T>
int stats_sums(const void* y, double* cpart, int* tickets, double* sums, int64_t rows, int C,
               int clusters, int64_t rows_per_block, void* stream) {
  if (clusters < 1 || rows_per_block < 1 || rows_per_block * kCluster * clusters < rows)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sums_config(clusters, (cudaStream_t)stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, bn_stats_sums_kernel<T>, (const uint4*)y, cpart, tickets, sums,
                         rows, groups_of<T>(C), rows_per_block);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int bwd_apply_split(const void* g, const void* y, void* dy, const float* st, const float* beta,
                    const double* local, const double* total, double n, float* dgamma,
                    float* dbeta, int64_t rows, int C, void* stream) {
  const int G = groups_of<T>(C);
  const int64_t elems = rows * G;
  bn_relu_bwd_apply_split_kernel<T><<<apply_blocks(elems), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)g, (const uint4*)y, (uint4*)dy, elems, G, st, beta, local, total, n, dgamma,
      dbeta);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_sums(const void* g, const void* y, double* part, const float* st, const float* beta,
             double* sums, int64_t rows, int C, void* stream) {
  static const int resident = resident_blocks(bn_relu_bwd_partial_kernel<T>);
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = groups_of<T>(C);
  const int nblk = reduce_blocks(resident, rows, G);
  const int64_t per_block = (rows + nblk - 1) / nblk;
  bn_relu_bwd_partial_kernel<T><<<nblk, kThreads, 0, s>>>((const uint4*)g, (const uint4*)y, part,
                                                          rows, G, per_block, st, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_sums_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(part, nblk, C, sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most row blocks a reduction uses: the wrapper allocates 2 * C doubles of
// partials for each.
int bn_max_blocks(void) { return kMaxBlocks; }

// st (4, C) = mean, diff, r, inv of y (rows, C); running stats updated.
int bn_stats_bf16(const void* y, double* part, const float* gamma, float* running_mean,
                  float* running_var, float* st, long long rows, int C, float eps,
                  float momentum, float one_minus_momentum, void* stream) {
  return stats<__nv_bfloat16>(y, part, gamma, running_mean, running_var, st, rows, C, eps,
                              momentum, one_minus_momentum, stream);
}
int bn_stats_f32(const void* y, double* part, const float* gamma, float* running_mean,
                 float* running_var, float* st, long long rows, int C, float eps, float momentum,
                 float one_minus_momentum, void* stream) {
  return stats<float>(y, part, gamma, running_mean, running_var, st, rows, C, eps, momentum,
                      one_minus_momentum, stream);
}

// out (rows, C) = cast(max((y - mean) * inv + beta, 0)).
int bn_relu_fwd_bf16(const void* y, void* out, const float* st, const float* beta,
                     long long rows, int C, void* stream) {
  return relu_fwd<__nv_bfloat16>(y, out, st, beta, rows, C, stream);
}
int bn_relu_fwd_f32(const void* y, void* out, const float* st, const float* beta, long long rows,
                    int C, void* stream) {
  return relu_fwd<float>(y, out, st, beta, rows, C, stream);
}

// dgamma, dbeta (C) and coef (2, C) from g, y (rows, C).
int bn_relu_bwd_reduce_bf16(const void* g, const void* y, double* part, const float* st,
                            const float* beta, float* dgamma, float* dbeta, float* coef,
                            long long rows, int C, int train, void* stream) {
  return bwd_reduce<__nv_bfloat16>(g, y, part, st, beta, dgamma, dbeta, coef, rows, C, train,
                                   stream);
}
int bn_relu_bwd_reduce_f32(const void* g, const void* y, double* part, const float* st,
                           const float* beta, float* dgamma, float* dbeta, float* coef,
                           long long rows, int C, int train, void* stream) {
  return bwd_reduce<float>(g, y, part, st, beta, dgamma, dbeta, coef, rows, C, train, stream);
}

// dy (rows, C) from g, y and coef.
int bn_relu_bwd_apply_bf16(const void* g, const void* y, void* dy, const float* st,
                           const float* beta, const float* coef, long long rows, int C,
                           void* stream) {
  return bwd_apply<__nv_bfloat16>(g, y, dy, st, beta, coef, rows, C, stream);
}
int bn_relu_bwd_apply_f32(const void* g, const void* y, void* dy, const float* st,
                          const float* beta, const float* coef, long long rows, int C,
                          void* stream) {
  return bwd_apply<float>(g, y, dy, st, beta, coef, rows, C, stream);
}

// sums (2, C) = (sum y, sum y^2) of y (rows, C) in double, one launch of
// ``clusters`` clusters of kCluster blocks, each block over rows_per_block
// rows; cpart: clusters * 2 * C doubles of scratch; tickets: kCluster ints,
// 0 before the launch and again after it.
int bn_stats_sums_bf16(const void* y, double* cpart, int* tickets, double* sums, long long rows,
                       int C, int clusters, long long rows_per_block, void* stream) {
  return stats_sums<__nv_bfloat16>(y, cpart, tickets, sums, rows, C, clusters, rows_per_block,
                                   stream);
}
int bn_stats_sums_f32(const void* y, double* cpart, int* tickets, double* sums, long long rows,
                      int C, int clusters, long long rows_per_block, void* stream) {
  return stats_sums<float>(y, cpart, tickets, sums, rows, C, clusters, rows_per_block, stream);
}

// Clusters of bn_stats_sums_* the current card keeps resident at once.
int bn_stats_sums_clusters_bf16(int* out) { return sums_clusters<__nv_bfloat16>(out); }
int bn_stats_sums_clusters_f32(int* out) { return sums_clusters<float>(out); }

// out (rows, C) = cast(max((y - mean) * inv + beta, 0)) with the statistics
// of the sums (2, C) of every share over n rows; st (4, C) and, where
// running_mean and running_var are not null, the running update.
int bn_relu_fwd_split_bf16(const void* y, void* out, const double* sums, double n,
                           const float* gamma, const float* beta, float* running_mean,
                           float* running_var, float* st, long long rows, int C, float eps,
                           float momentum, float one_minus_momentum, void* stream) {
  return relu_fwd_split<__nv_bfloat16>(y, out, sums, n, gamma, beta, running_mean, running_var,
                                       st, rows, C, eps, momentum, one_minus_momentum, stream);
}
int bn_relu_fwd_split_f32(const void* y, void* out, const double* sums, double n,
                          const float* gamma, const float* beta, float* running_mean,
                          float* running_var, float* st, long long rows, int C, float eps,
                          float momentum, float one_minus_momentum, void* stream) {
  return relu_fwd_split<float>(y, out, sums, n, gamma, beta, running_mean, running_var, st, rows,
                               C, eps, momentum, one_minus_momentum, stream);
}

// sums (2, C) = (Sg, Sgy) of g, y (rows, C) in double.
int bn_relu_bwd_sums_bf16(const void* g, const void* y, double* part, const float* st,
                          const float* beta, double* sums, long long rows, int C, void* stream) {
  return bwd_sums<__nv_bfloat16>(g, y, part, st, beta, sums, rows, C, stream);
}
int bn_relu_bwd_sums_f32(const void* g, const void* y, double* part, const float* st,
                         const float* beta, double* sums, long long rows, int C, void* stream) {
  return bwd_sums<float>(g, y, part, st, beta, sums, rows, C, stream);
}

// dy (rows, C) from g, y and the sums ``total`` of every share over n rows;
// dgamma, dbeta (C) from one share's sums ``local``.
int bn_relu_bwd_apply_split_bf16(const void* g, const void* y, void* dy, const float* st,
                                 const float* beta, const double* local, const double* total,
                                 double n, float* dgamma, float* dbeta, long long rows, int C,
                                 void* stream) {
  return bwd_apply_split<__nv_bfloat16>(g, y, dy, st, beta, local, total, n, dgamma, dbeta, rows,
                                        C, stream);
}
int bn_relu_bwd_apply_split_f32(const void* g, const void* y, void* dy, const float* st,
                                const float* beta, const double* local, const double* total,
                                double n, float* dgamma, float* dbeta, long long rows, int C,
                                void* stream) {
  return bwd_apply_split<float>(g, y, dy, st, beta, local, total, n, dgamma, dbeta, rows, C,
                                stream);
}

}  // extern "C"
