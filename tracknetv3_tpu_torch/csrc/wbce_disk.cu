// Fused WBCE loss against virtual disk labels, forward and backward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/wbce_disk.py, whose loss_plan computes every
// size of a forward launch).
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
// Bound on the H100 SXM (3.35 TB/s) at the training shape
// (10, 8, 288, 512): the forward must read the 47.2 MB of logits, so
// >= 14.1 us; the backward reads them and writes 47.2 MB of dz, so
// >= 28.2 us. Each element also costs one IEEE expf, one log1pf and one
// division, so the arithmetic each element needs sets a second floor
// (chip_smoke.py counts its instructions in this library's SASS, from the
// probe kernels at the end of this file, leaving out moves, convergence
// markers and uniform index math).
//
// Forward design (K1): one launch.
// - A fixed partition of the logits into work items of one row of one
//   (sample, frame) plane (2 KB at W = 512), one float partial per item. The
//   item count is the shape's, not the card's, so the loss does not depend on
//   the grid and is the same bits run to run.
// - A persistent grid (kBlocksPerSM blocks of 8 warps per SM) in which every
//   warp walks its own even contiguous share of the rows: no block barrier
//   inside the loop, and at B*L*H = 23,040 rows the shares differ by one row
//   of about eleven.
// - Each lane issues its kLoadsPerLane 16-byte ld.global.nc loads of the row
//   at once, then computes. A ring of 1-D bulk TMA copies per warp into
//   shared memory gave the same bits and was slower at every grid on an H100
//   (PERF.md, PR 7): the loop is bound by the elements' dependent expf /
//   log1pf / division chains, not by the loads.
// - Rows no disk touches: where |row - cy| > sigma for both visible centers
//   (dy * dy > sigma^2, exact in float for integer rows and centers) the
//   label is 0 on the whole row, and the term is -(p * p * l1mp), bit for bit
//   what loss_term returns at y = 0; such rows skip the membership math and
//   raw_lp. The predicate is computed once per row. At sigma 2.5 at most 10
//   of a plane's 288 rows hold label pixels.
// - Each row's partial: per-lane float sums in a fixed order (the lane's
//   float4s in order, the four terms of one in order), then the fixed
//   warp-shuffle tree. The last block to finish (an int ticket taken after
//   __threadfence; no float atomics) sums the partials in double, thread t
//   taking rows t, t + 256, ..., then a fixed tree; divides by B*L*H*W;
//   resets the ticket for the next launch.
//
// Backward (K2): grid (ceil(H / kRows), L, B), a block owns kRows rows of one
// plane and walks them with threads on neighbouring columns. Not redesigned
// yet.

#include <cuda_runtime.h>
#include <stdint.h>

// One (sample, frame) plane's targets: the two disks' centers as floats,
// whether each is visible, the weight of disk A. (Outside the anonymous
// namespace: the probe kernels at the end take it as a parameter.)
struct Targets {
  float cxa, cya, cxb, cyb, wa;
  bool va, vb;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // K2: rows of one plane per block
// K1: each warp walks its own rows, kLoadsPerLane float4s in flight per
// lane; kBlocksPerSM blocks on each SM
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;
constexpr int kLoadsPerLane = 4;
constexpr int kMaxDevices = 64;
// logf(1e-7) in double, rounded to float: the same constant as the JAX
// package's jnp.float32(jnp.log(1e-7)).
constexpr float kLogFloor = -16.118095650958320f;

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

// loss_term(z, 0.f), bit for bit, without the label's side: raw_lp and the
// (1-p)^2 y log p product are not needed where y is 0.
__device__ __forceinline__ float loss_term_y0(float z) {
  const float e = expf(-fabsf(z));
  const float l1p = log1pf(e);
  const float raw_l1mp = fminf(-z, 0.f) - l1p;
  const float p = z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
  const float l1mp = fmaxf(raw_l1mp, kLogFloor);
  return -(p * p * l1mp);
}

// Whether row ``row`` of a plane can hold a label pixel: within sigma of a
// visible center's row. Exact: integer-valued floats, and a squared column
// distance >= 0 only adds to the squared row distance.
__device__ __forceinline__ bool label_row(const Targets& t, float row, float sigma2) {
  const float dya = row - t.cya, dyb = row - t.cyb;
  return (t.va && dya * dya <= sigma2) || (t.vb && dyb * dyb <= sigma2);
}

__device__ __forceinline__ float terms4(const Targets& t, float4 v, float row, float col,
                                        float sigma2, bool lbl) {
  // added in this order: x, y, z, w
  float s = 0.f;
  if (lbl) {
    s += loss_term(v.x, label(t, row, col, sigma2));
    s += loss_term(v.y, label(t, row, col + 1.f, sigma2));
    s += loss_term(v.z, label(t, row, col + 2.f, sigma2));
    s += loss_term(v.w, label(t, row, col + 3.f, sigma2));
  } else {
    s += loss_term_y0(v.x);
    s += loss_term_y0(v.y);
    s += loss_term_y0(v.z);
    s += loss_term_y0(v.w);
  }
  return s;
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

struct FwdArgs {
  const float* z;
  const int* centers;
  const float* w;
  float* partials;  // one per item: one per row of a plane
  int* ticket;      // 0 between launches
  float* loss;
  int L, H, W;
  int items;  // B*L*H
  float sigma2;
  double count;  // B*L*H*W
};

__device__ __forceinline__ float4 ld_nc_v4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Sum over a warp; the result is valid in lane 0. The fixed tree of block_sum.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// K1 (see the design note). Each warp walks its own share of the rows; each
// lane loads its float4s of a row straight to registers.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) wbce_disk_fwd_kernel(const FwdArgs a) {
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const int begin = (int)(gw * a.items / warps);
  const int end = (int)((gw + 1) * a.items / warps);
  const int W4 = a.W / 4;

  int plane_of_t = -1;
  Targets t;
  for (int item = begin; item < end; ++item) {
    const int plane = item / a.H;
    if (plane != plane_of_t) {
      t = load_targets(a.centers, a.w, plane / a.L, plane % a.L, a.L);
      plane_of_t = plane;
    }
    const float row = (float)(item - plane * a.H);
    const bool lbl = label_row(t, row, a.sigma2);  // once per row
    const float* src = a.z + (size_t)item * a.W;
    float acc = 0.f;
    for (int q0 = lane; q0 < W4; q0 += kLoadsPerLane * 32) {
      float4 v[kLoadsPerLane];
#pragma unroll
      for (int u = 0; u < kLoadsPerLane; ++u) {
        const int q = q0 + 32 * u;
        if (q < W4) v[u] = ld_nc_v4(src + 4 * q);
      }
#pragma unroll
      for (int u = 0; u < kLoadsPerLane; ++u) {
        const int q = q0 + 32 * u;
        if (q < W4) acc += terms4(t, v[u], row, (float)(4 * q), a.sigma2, lbl);
      }
    }
    const float part = warp_sum(acc);
    if (lane == 0) a.partials[item] = part;
  }

  // The last block to get here sums the partials.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  double sum = 0.0;
  for (int i = threadIdx.x; i < a.items; i += kThreads) sum += (double)__ldcg(a.partials + i);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    a.loss[0] = (float)(sum / a.count);
    *a.ticket = 0;
  }
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

// K1's launch plan (ops/wbce_disk.py loss_plan), int64 in this order.
enum Plan { P_ITEMS, P_GRID, P_THREADS, P_LEN };

bool plan_matches(const long long* p, int B, int L, int H, int W) {
  if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || W % 4 || p[P_ITEMS] != (long long)B * L * H ||
      p[P_ITEMS] > 0x7fffffffLL)
    return false;
  return p[P_THREADS] == kThreads && p[P_GRID] >= 1 &&
         p[P_GRID] <= (p[P_ITEMS] + kWarps - 1) / kWarps;
}

// The most blocks K1's grid may have on the current device: its SMs times
// kBlocksPerSM where the occupancy API confirms that many fit on an SM, else
// 0. Read at the first launch on each device and kept.
int max_fwd_grid(int* out) {
  static int cached[kMaxDevices];  // 0: not read yet; -1: read, none fit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wbce_disk_fwd_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = per_sm >= kBlocksPerSM ? sms * kBlocksPerSM : -1;
  }
  *out = cached[dev] > 0 ? cached[dev] : 0;
  return 0;
}

}  // namespace

// Probe kernels, never launched: chip_smoke.py counts the SASS instructions
// of each to read the arithmetic one element of K1 needs (on a label row, on
// a skipped row) and one of K2, less what probe_base also has (its index
// math, load and store). The targets come in as a kernel parameter, as they
// are per plane, not per element.
extern "C" __global__ void wbce_probe_base(const float* z, float* out, Targets t, float sigma2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = z[i];
}

extern "C" __global__ void wbce_probe_fwd_label(const float* z, float* out, Targets t,
                                                float sigma2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = loss_term(z[i], label(t, (float)blockIdx.x, (float)threadIdx.x, sigma2));
}

extern "C" __global__ void wbce_probe_fwd_skip(const float* z, float* out, Targets t,
                                               float sigma2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = loss_term_y0(z[i]);
}

extern "C" __global__ void wbce_probe_bwd(const float* z, float* out, Targets t, float sigma2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = grad_term(z[i], label(t, (float)blockIdx.x, (float)threadIdx.x, sigma2));
}

extern "C" {

// K1's constants, which ops/wbce_disk.py checks against its own: threads,
// blocks per SM, the plan's length.
int wbce_disk_constants(long long* out) {
  out[0] = kThreads;
  out[1] = kBlocksPerSM;
  out[2] = P_LEN;
  return 0;
}

// loss[0] = mean clamped WBCE, in one launch. partials: plan[P_ITEMS] = B*L*H
// floats; ticket: one int, 0 before the launch and again after it.
int wbce_disk_forward(const float* z, const int* centers, const float* w, float* partials,
                      int* ticket, float* loss, int B, int L, int H, int W, float sigma,
                      const long long* plan, void* stream) {
  if (!plan_matches(plan, B, L, H, W) || ((uintptr_t)z % 16)) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.z = z;
  a.centers = centers;
  a.w = w;
  a.partials = partials;
  a.ticket = ticket;
  a.loss = loss;
  a.L = L;
  a.H = H;
  a.W = W;
  a.items = (int)plan[P_ITEMS];
  a.sigma2 = sigma * sigma;
  a.count = (double)B * L * H * W;
  int max_grid = 0;
  const int err = max_fwd_grid(&max_grid);
  if (err != 0) return err;
  if (plan[P_GRID] > max_grid) return (int)cudaErrorInvalidValue;
  wbce_disk_fwd_kernel<<<(unsigned int)plan[P_GRID], kThreads, 0, (cudaStream_t)stream>>>(a);
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
