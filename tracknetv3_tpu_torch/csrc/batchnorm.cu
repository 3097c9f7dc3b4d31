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
//   bn_stats_sums_{bf16,f32}       <- stats_kernel's sums (P4)
//   bn_stats_finalize              <- the rest of P4, from summed sums
//   bn_relu_bwd_sums_{bf16,f32}    <- the gradient's sums
//   bn_relu_bwd_finalize           <- dgamma, dbeta and the coefficients
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
// backward over one share's rows, in the fixed order of the unsplit
// reductions; stats_finalize takes summed sums and the global row count n;
// bwd_finalize takes dgamma and dbeta from one share's own sums (each
// share's gradient is summed later with the others') and c1, c2 from the
// summed ones. With one share the split path computes the unsplit one's
// every bit.
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
// normalise, one read of g and y for each backward kernel. The split sums
// reuse the partial passes (bound by bytes as above) and end in a sum
// kernel instead of the finalize; the split finalizes read a (2, C) double
// row and a few C-vectors, so they are bound by launch latency, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinRows = 16;      // rows a thread of a reduction walks at least
constexpr int kMaxBlocks = 1056;  // 8 blocks of 256 threads fill each of an H100's 132 SMs
constexpr int kFinalizeWarps = kThreads / 32;

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
__device__ __forceinline__ void load_pack(const uint4* __restrict__ p, int64_t i, float* f);

template <>
__device__ __forceinline__ void load_pack<__nv_bfloat16>(const uint4* __restrict__ p, int64_t i,
                                                         float* f) {
  const uint4 v = p[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

template <>
__device__ __forceinline__ void load_pack<float>(const uint4* __restrict__ p, int64_t i, float* f) {
  const uint4 v = p[i];
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
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
  const double md = s / n;
  const float mean = (float)md;
  const float diff = (float)(q / n - md * md);
  const float var = relu(diff);
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  st[c] = mean;
  st[C + c] = diff;
  st[2 * C + c] = r;
  st[3 * C + c] = __fmul_rn(r, gamma[c]);
  running_mean[c] =
      __fadd_rn(__fmul_rn(running_mean[c], momentum), __fmul_rn(mean, one_minus_momentum));
  running_var[c] =
      __fadd_rn(__fmul_rn(running_var[c], momentum), __fmul_rn(var, one_minus_momentum));
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

// Channel c's dgamma and dbeta from the sums (s, q), and its apply
// coefficients (c1, c2) from the sums (S, Q) over n rows.
__device__ __forceinline__ void bwd_finalize_channel(int c, int C, double s, double q, double S,
                                                     double Q, double n,
                                                     const float* __restrict__ st,
                                                     float* __restrict__ dgamma,
                                                     float* __restrict__ dbeta,
                                                     float* __restrict__ coef, int train) {
  const float diff = st[C + c], r = st[2 * C + c];
  dbeta[c] = (float)s;
  dgamma[c] = __fmul_rn((float)q, r);
  float c1 = 0.f, c2 = 0.f;
  if (train) {
    const float k = diff > 0.f ? 1.f : (diff == 0.f ? 0.5f : 0.f);
    c1 = (float)(S / n);
    c2 = __fmul_rn(__fmul_rn(k, __fmul_rn(r, r)), (float)(Q / n));
  }
  coef[c] = c1;
  coef[C + c] = c2;
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

// The split backward's finalize: dgamma, dbeta from one share's sums
// ``local``, (c1, c2) from the sums ``total`` of every share, n rows in all.
__global__ void __launch_bounds__(32)
    bn_relu_bwd_finalize_split_kernel(const double* __restrict__ local,
                                      const double* __restrict__ total, int C, double n,
                                      const float* __restrict__ st, float* __restrict__ dgamma,
                                      float* __restrict__ dbeta, float* __restrict__ coef,
                                      int train) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= C) return;
  bwd_finalize_channel(c, C, local[c], local[C + c], total[c], total[C + c], n, st, dgamma, dbeta,
                       coef, train);
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

template <typename T>
int stats_sums(const void* y, double* part, double* sums, int64_t rows, int C, void* stream) {
  static const int resident = resident_blocks(bn_stats_partial_kernel<T>);
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = groups_of<T>(C);
  const int nblk = reduce_blocks(resident, rows, G);
  const int64_t per_block = (rows + nblk - 1) / nblk;
  bn_stats_partial_kernel<T><<<nblk, kThreads, 0, s>>>((const uint4*)y, part, rows, G, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_sums_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(part, nblk, C, sums);
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

// sums (2, C) = (sum y, sum y^2) of y (rows, C) in double.
int bn_stats_sums_bf16(const void* y, double* part, double* sums, long long rows, int C,
                       void* stream) {
  return stats_sums<__nv_bfloat16>(y, part, sums, rows, C, stream);
}
int bn_stats_sums_f32(const void* y, double* part, double* sums, long long rows, int C,
                      void* stream) {
  return stats_sums<float>(y, part, sums, rows, C, stream);
}

// st (4, C) and the running update from sums (2, C) over n rows in all.
int bn_stats_finalize(const double* sums, const float* gamma, float* running_mean,
                      float* running_var, float* st, double n, int C, float eps, float momentum,
                      float one_minus_momentum, void* stream) {
  bn_stats_finalize_kernel<<<(C + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
      sums, 1, C, n, gamma, running_mean, running_var, st, eps, momentum, one_minus_momentum);
  return (int)cudaGetLastError();
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

// dgamma, dbeta (C) from one share's sums, coef (2, C) from the summed ones.
int bn_relu_bwd_finalize(const double* local, const double* total, const float* st,
                         float* dgamma, float* dbeta, float* coef, double n, int C, int train,
                         void* stream) {
  bn_relu_bwd_finalize_split_kernel<<<(C + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      local, total, C, n, st, dgamma, dbeta, coef, train);
  return (int)cudaGetLastError();
}

}  // extern "C"
