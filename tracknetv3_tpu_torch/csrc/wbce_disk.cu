// Fused WBCE loss against virtual disk labels, forward and backward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/wbce_disk.py).
//
// Replaces the JAX package's Pallas TPU kernels in
// tracknetv3_tpu/ops/pallas_wbce.py:
//   wbce_disk_fwd  <- _fwd_kernel (launched by _forward)
//   wbce_disk_bwd  <- _bwd_kernel (launched by _vjp_bwd)
//
// Function. For logits z (B, L, H, W) float32 and per-(sample, frame)
// targets -- disk centers A and B (int32, (0, 0) = no ball) and the weight
// wa of disk A -- the label is y = wa * disk(A) + (1 - wa) * disk(B) with
// disk radius sigma, built from the pixel's row and column and never
// stored. The loss is the mean over B*L*H*W of
//   -((1-p)^2 y max(log p, log 1e-7) + p^2 (1-y) max(log(1-p), log 1e-7)),
// p = sigmoid(z), log p = log_sigmoid(z) = min(z, 0) - log1p(exp(-|z|)).
// The backward writes dL/dz times g / (B*L*H*W), g read from a device
// scalar. Its clamp masks test exactly the forward's condition (raw
// log_sigmoid > log 1e-7); so no fast-math expf/logf anywhere.
//
// Design. Grid (ceil(H / kRows), L, B): a block owns kRows rows of one
// (sample, frame) plane, loads its four centers and its weight once, and
// walks the rows with threads on neighbouring columns (coalesced, no
// division per element). The forward reduces in each warp, then across the
// block, writes one partial per block, and a one-block pass sums the
// partials in a fixed order (double accumulator) and divides by B*L*H*W.
// No float atomics: the loss is the same from run to run.
//
// Bound on the H100 SXM (3.35 TB/s) at the training shape
// (10, 8, 288, 512): the forward must read the 47.2 MB of logits, so
// >= 14.1 us; the backward reads them and writes 47.2 MB of dz, so
// >= 28.2 us. Each element also costs one expf and one log1pf, and the
// per-element instruction count may make the kernels compute-limited
// before they reach that bandwidth. This is the simple, right first
// version; tiling for speed is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of one plane per block
// logf(1e-7) in double, rounded to float: the same constant as the JAX
// package's jnp.float32(jnp.log(1e-7)).
constexpr float kLogFloor = -16.118095650958320f;

struct Targets {
  float cxa, cya, cxb, cyb, wa;
  bool va, vb;
};

__device__ __forceinline__ Targets load_targets(const int* __restrict__ centers,
                                                const float* __restrict__ w, int b,
                                                int l, int L) {
  // centers: (B, 4L) int32 laid out [cxa | cya | cxb | cyb]; w: (B, L).
  const int* c = centers + (size_t)b * 4 * L;
  const int cxa = c[l], cya = c[L + l], cxb = c[2 * L + l], cyb = c[3 * L + l];
  Targets t;
  t.cxa = (float)cxa;
  t.cya = (float)cya;
  t.cxb = (float)cxb;
  t.cyb = (float)cyb;
  t.va = (cxa != 0) || (cya != 0);
  t.vb = (cxb != 0) || (cyb != 0);
  t.wa = w[(size_t)b * L + l];
  return t;
}

__device__ __forceinline__ float label(const Targets& t, float row, float col,
                                       float sigma2) {
  const float dya = row - t.cya, dxa = col - t.cxa;
  const float dyb = row - t.cyb, dxb = col - t.cxb;
  const float ya = (t.va && dya * dya + dxa * dxa <= sigma2) ? 1.f : 0.f;
  const float yb = (t.vb && dyb * dyb + dxb * dxb <= sigma2) ? 1.f : 0.f;
  return ya * t.wa + yb * (1.f - t.wa);
}

// p = sigmoid(z) and the raw (unclamped) log_sigmoid(z), log_sigmoid(-z).
__device__ __forceinline__ void sigmoid_logs(float z, float& p, float& raw_lp,
                                             float& raw_l1mp) {
  const float e = expf(-fabsf(z));
  const float l1p = log1pf(e);
  raw_lp = fminf(z, 0.f) - l1p;
  raw_l1mp = fminf(-z, 0.f) - l1p;
  p = z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
}

__device__ __forceinline__ float loss_term(float z, float y) {
  float p, raw_lp, raw_l1mp;
  sigmoid_logs(z, p, raw_lp, raw_l1mp);
  const float lp = fmaxf(raw_lp, kLogFloor);
  const float l1mp = fmaxf(raw_l1mp, kLogFloor);
  const float omp = 1.f - p;
  return -(omp * omp * y * lp + p * p * (1.f - y) * l1mp);
}

__device__ __forceinline__ float grad_term(float z, float y) {
  float p, raw_lp, raw_l1mp;
  sigmoid_logs(z, p, raw_lp, raw_l1mp);
  // The log terms are constant where the clamp engages, so their
  // derivative vanishes there: the masks test the forward's max() exactly.
  const float in_lo = raw_lp > kLogFloor ? 1.f : 0.f;
  const float in_hi = raw_l1mp > kLogFloor ? 1.f : 0.f;
  const float lp = fmaxf(raw_lp, kLogFloor);
  const float l1mp = fmaxf(raw_l1mp, kLogFloor);
  const float omp = 1.f - p;
  return y * (2.f * p * omp * omp * lp - omp * omp * omp * in_lo) +
         (1.f - y) * (-2.f * p * p * omp * l1mp + p * p * p * in_hi);
}

// Sum over the block; the result is valid in thread 0. Fixed order.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = T(0);
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    wbce_disk_fwd_kernel(const float* __restrict__ z, const int* __restrict__ centers,
                         const float* __restrict__ w, float* __restrict__ partials,
                         int L, int H, int W, float sigma2) {
  const int l = blockIdx.y, b = blockIdx.z;
  const Targets t = load_targets(centers, w, b, l, L);
  const size_t plane = ((size_t)b * L + l) * (size_t)H * W;
  const int row0 = blockIdx.x * kRows;
  const int row1 = min(row0 + kRows, H);
  float acc = 0.f;
  for (int r = row0; r < row1; ++r) {
    const float* zr = z + plane + (size_t)r * W;
    for (int c = threadIdx.x; c < W; c += kThreads) {
      acc += loss_term(zr[c], label(t, (float)r, (float)c, sigma2));
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[((size_t)b * L + l) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    wbce_disk_finalize_kernel(const float* __restrict__ partials, int n, float count,
                              float* __restrict__ loss) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += (double)partials[i];
  const double s = block_sum(acc);
  if (threadIdx.x == 0) loss[0] = (float)s / count;
}

__global__ void __launch_bounds__(kThreads)
    wbce_disk_bwd_kernel(const float* __restrict__ z, const int* __restrict__ centers,
                         const float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ dz, int L, int H, int W, float sigma2,
                         float count) {
  const int l = blockIdx.y, b = blockIdx.z;
  const Targets t = load_targets(centers, w, b, l, L);
  const float scale = g[0] / count;
  const size_t plane = ((size_t)b * L + l) * (size_t)H * W;
  const int row0 = blockIdx.x * kRows;
  const int row1 = min(row0 + kRows, H);
  for (int r = row0; r < row1; ++r) {
    const size_t off = plane + (size_t)r * W;
    for (int c = threadIdx.x; c < W; c += kThreads) {
      dz[off + c] = grad_term(z[off + c], label(t, (float)r, (float)c, sigma2)) * scale;
    }
  }
}

inline dim3 grid_of(int B, int L, int H) { return dim3((H + kRows - 1) / kRows, L, B); }

}  // namespace

extern "C" {

// Number of float partials the forward needs as scratch.
int wbce_disk_num_partials(int B, int L, int H) {
  const dim3 g = grid_of(B, L, H);
  return (int)(g.x * g.y * g.z);
}

// loss[0] = mean clamped WBCE; partials: wbce_disk_num_partials() floats.
int wbce_disk_forward(const float* z, const int* centers, const float* w,
                      float* partials, float* loss, int B, int L, int H, int W,
                      float sigma, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(B, L, H);
  const float count = (float)((long long)B * L * H * W);
  wbce_disk_fwd_kernel<<<grid, kThreads, 0, s>>>(z, centers, w, partials, L, H, W,
                                                 sigma * sigma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wbce_disk_finalize_kernel<<<1, kThreads, 0, s>>>(
      partials, (int)(grid.x * grid.y * grid.z), count, loss);
  return (int)cudaGetLastError();
}

// dz (B, L, H, W) = dL/dz * g[0] / (B*L*H*W).
int wbce_disk_backward(const float* z, const int* centers, const float* w,
                       const float* g, float* dz, int B, int L, int H, int W,
                       float sigma, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float count = (float)((long long)B * L * H * W);
  wbce_disk_bwd_kernel<<<grid_of(B, L, H), kThreads, 0, s>>>(
      z, centers, w, g, dz, L, H, W, sigma * sigma, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
