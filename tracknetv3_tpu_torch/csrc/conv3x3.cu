// SAME 3x3 convolution of NHWC bfloat16 activations as an implicit GEMM on the
// tensor cores, with the folded serving forward's epilogue in its body:
//   y = bf16(relu(acc_f32 + bias_f32))
// float32 accumulation over all 9 * Ci terms, the bias added to the
// accumulator, a NaN-propagating ReLU, one round-to-nearest-even to bfloat16.
// For Hopper (sm_90a). Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/conv3x3.py).
//
// Replaces the JAX package's Pallas TPU probe kernels:
//   conv3x3_k3c_kernel   <- tools/probe_pallas_conv.py:48 (make_conv3x3) and
//                           :130 with sheet=True (make_conv3x3_wide);
//                           tools/probe_pallas_ablate.py:63 variant "full"
//   conv3x3_9tap_kernel  <- tools/probe_pallas_conv.py:130 with sheet=False;
//                           tools/probe_pallas_ablate.py:63 variant "full-9mm"
// and computes, with the epilogue, _conv_relu of the serving forward
// (tracknetv3_tpu/models/fused_forward.py:63). With a null bias and relu = 0
// it is the probes' bare conv. The ablation's partial variants ("mm-only",
// "mm1-only", "dma+mm", "sheet+mm") are stage switches of the k3c kernel with
// their own entry points; they read zeroed shared memory where the probe read
// scratch that nothing wrote, so they are timings with no defined output.
//
// Function. x (N, H, W, Ci), packed weights (3, 3 * Ci, Co) = the HWIO kernel
// reshaped, rows (dx, ci) for each dy, bias (Co) float32 or null,
// y (N, H, W, Co):
//   acc[n, h, w, co] = sum over dy, dx, ci of
//       x[n, h + dy - 1, w + dx - 1, ci] * wp[dy, dx * Ci + ci, co]
// with x = 0 outside the image. The halo is zero-filled in shared memory; no
// padded copy of x is made in device memory (the probes' jnp.pad).
//
// Design. Bound on the H100 SXM by operations at every serving shape but the
// first layer (2 * 9 * Ci * Co operations per output pixel against
// 2 * (Ci + Co) bytes). A block of 256 threads (8 warps) owns a tile of 8 rows
// x 16 columns of output pixels (M = 128) and 64 output channels, and walks
// the input channels in chunks of 32. Per chunk it stages the halo tile
// (10, 18, 32) and the weight rows of all nine taps (288, 64) with 16-byte
// loads, then
//   k3c:  copies the halo into the dx-concatenated sheet (10, 16, 96) and runs
//         one K = 96 product per dy on it (the probes' im2col sheet);
//   9tap: runs nine K = 32 products on views of the halo tile shifted by
//         (dy, dx), with no sheet.
// One narrow/wide kernel serves all widths: the probes' split at Ci = 128 was
// the TPU's lane alignment, not the arithmetic. Each warp keeps a 32 pixel x
// 32 channel block of float32 accumulators (2 x 2 wmma 16x16x16 fragments) in
// registers across all chunks; a fragment's 16 rows are 16 neighbouring pixels
// of one tile row, so every A operand is a plain row-major view with the
// pixel stride as its leading dimension. Pixel and row strides in shared
// memory are padded (48, 112, 80 elements) so that every fragment pointer is
// 32-byte aligned and the rows of a fragment spread over the banks. The
// accumulators go through a float32 staging tile (aliasing the operand tiles)
// to the epilogue, which writes 16 bytes of channels per thread and masks the
// ragged edge. Both kernels add in the same order (chunk, dy, dx, ci), so they
// agree bit for bit. This is the simple, right first version: no cp.async
// pipeline, wgmma or TMA; two (k3c) or three (9tap) resident blocks per SM
// overlap each other's loads.
//
// Requires Ci a multiple of 32 (the first layer's 27 channels are padded to
// 32 with zeros by the caller, weights and input alike), Co a multiple of 64,
// 16-byte aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int TH = 8, TW = 16;        // output pixel tile
constexpr int BM = TH * TW;           // 128 pixels
constexpr int BN = 64;                // output channels per block
constexpr int CK = 32;                // input channels per chunk
constexpr int HR = TH + 2, HC = TW + 2;
constexpr int HS = 48;                // halo pixel stride (elements)
constexpr int SK = 3 * CK;            // sheet depth per pixel: (dx, ci)
constexpr int SS = 112;               // sheet pixel stride
constexpr int WS = BN + 16;           // weight row stride
constexpr int CS = BN + 8;            // staging row stride (floats)
constexpr int kHaloBytes = HR * HC * HS * 2;   // 17280
constexpr int kSheetBytes = HR * TW * SS * 2;  // 35840
constexpr int kWeightBytes = 9 * CK * WS * 2;  // 46080
constexpr int kStageBytes = BM * CS * 4;       // 36864
constexpr int kSmemK3c = kHaloBytes + kSheetBytes + kWeightBytes;  // 99200
constexpr int kSmem9tap = kHaloBytes + kWeightBytes;               // 63360
static_assert(kStageBytes <= kHaloBytes + kSheetBytes, "staging aliases halo + sheet");
static_assert(kStageBytes <= kSmem9tap, "staging aliases halo + weights");
static_assert(BM * 9 * CK * 2 <= kSheetBytes + kWeightBytes, "mm1 reads a (128, 288) sheet");
static_assert(kHaloBytes % 128 == 0 && kSheetBytes % 128 == 0, "tile bases stay aligned");

// stage switches of the k3c kernel (the ablation's variants)
constexpr int kLoad = 1;   // global loads of the halo tile and the weights
constexpr int kSheet = 2;  // build the sheet from the halo tile
constexpr int kFull = kLoad | kSheet;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Tile {
  int n, h0, w0, co0;
};

__device__ __forceinline__ Tile block_tile(int H, int W) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  int b = blockIdx.x;
  Tile t;
  t.w0 = (b % tiles_w) * TW;
  b /= tiles_w;
  t.h0 = (b % tiles_h) * TH;
  t.n = b / tiles_h;
  t.co0 = blockIdx.y * BN;
  return t;
}

// halo[row][col][0..CK) = x[n, h0 - 1 + row, w0 - 1 + col, c0 + 0..CK), zero
// outside the image.
__device__ __forceinline__ void load_halo(bf16* halo, const bf16* __restrict__ x, Tile t,
                                          int c0, int H, int W, int Ci) {
  constexpr int Q = CK / 8;  // 16-byte units per pixel
  for (int i = threadIdx.x; i < HR * HC * Q; i += kThreads) {
    const int q = i % Q, p = i / Q;
    const int col = p % HC, row = p / HC;
    const int h = t.h0 - 1 + row, w = t.w0 - 1 + col;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < H && w >= 0 && w < W)
      v = *reinterpret_cast<const uint4*>(x + (((int64_t)t.n * H + h) * W + w) * Ci + c0 + q * 8);
    *reinterpret_cast<uint4*>(halo + (row * HC + col) * HS + q * 8) = v;
  }
}

// ws[(dy * 3 + dx) * CK + c][0..BN) = wp[dy, dx * Ci + c0 + c, co0 + 0..BN)
__device__ __forceinline__ void load_weights(bf16* ws, const bf16* __restrict__ wp, int c0,
                                             int co0, int Ci, int Co) {
  constexpr int Q = BN / 8;
  for (int i = threadIdx.x; i < 9 * CK * Q; i += kThreads) {
    const int q = i % Q, r = i / Q;
    const int c = r % CK, tap = r / CK;  // tap = dy * 3 + dx
    const bf16* src = wp + ((int64_t)tap * Ci + c0 + c) * Co + co0 + q * 8;
    *reinterpret_cast<uint4*>(ws + r * WS + q * 8) = *reinterpret_cast<const uint4*>(src);
  }
}

// sheet[row][col][dx * CK + c] = halo[row][col + dx][c]
__device__ __forceinline__ void build_sheet(bf16* sheet, const bf16* halo) {
  constexpr int Q = CK / 8;
  for (int i = threadIdx.x; i < HR * TW * 3 * Q; i += kThreads) {
    const int q = i % Q;
    int p = i / Q;
    const int dx = p % 3;
    p /= 3;
    const int col = p % TW, row = p / TW;
    *reinterpret_cast<uint4*>(sheet + (row * TW + col) * SS + dx * CK + q * 8) =
        *reinterpret_cast<const uint4*>(halo + (row * HC + col + dx) * HS + q * 8);
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// max(v, 0) that keeps NaN, as jnp.maximum and torch.maximum do (fmaxf drops it).
__device__ __forceinline__ float relu_nan(float v) { return (v != v) ? v : fmaxf(v, 0.0f); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Accumulators -> float32 staging tile -> + bias, ReLU, one rounding -> y.
// ``stage`` aliases the operand tiles: every warp must be past its last
// product before the first store (the leading barrier).
__device__ __forceinline__ void epilogue(FragC (&acc)[2][2], float* stage, bf16* __restrict__ y,
                                         const float* __restrict__ bias, int relu, Tile t,
                                         int H, int W, int Co) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + ((2 * wm + i) * 16) * CS + wn * 32 + j * 16, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * (BN / 8); i += kThreads) {
    const int g = i % (BN / 8), m = i / (BN / 8);
    const int h = t.h0 + m / TW, w = t.w0 + m % TW;
    if (h >= H || w >= W) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + m * CS + g * 8);
    const float4 hi = *reinterpret_cast<const float4*>(stage + m * CS + g * 8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (bias != nullptr) {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + t.co0 + g * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + t.co0 + g * 8 + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(v[k], b[k]);
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = relu_nan(v[k]);
    }
    const uint4 out = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(y + (((int64_t)t.n * H + h) * W + w) * Co + t.co0 + g * 8) = out;
  }
}

// The im2col-sheet kernel. STAGES switches the global loads and the sheet
// build off for the ablation; ONE_PRODUCT runs a single K = 9 * CK product on
// a resident (128, 288) sheet instead of one K = 3 * CK product per dy.
template <int STAGES, bool ONE_PRODUCT>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_k3c_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                       const float* __restrict__ bias, bf16* __restrict__ y, int H, int W,
                       int Ci, int Co, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* sheet = reinterpret_cast<bf16*>(smem + kHaloBytes);
  bf16* ws = reinterpret_cast<bf16*>(smem + kHaloBytes + kSheetBytes);
  const Tile t = block_tile(H, W);
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  if (STAGES != kFull) zero_smem(smem, kSmemK3c);  // so that runs repeat

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    __syncthreads();  // the last chunk's products are done with the tiles
    if (STAGES & kLoad) {
      load_halo(halo, x, t, c0, H, W, Ci);
      load_weights(ws, wp, c0, t.co0, Ci, Co);
    }
    __syncthreads();
    if (STAGES & kSheet) build_sheet(sheet, halo);
    __syncthreads();
    FragA a[2];
    FragB b[2];
    if (ONE_PRODUCT) {
#pragma unroll 2
      for (int k = 0; k < 9 * CK; k += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], sheet + ((2 * wm + i) * 16) * (9 * CK) + k, 9 * CK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], ws + k * WS + wn * 32 + j * 16, WS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
        for (int k = 0; k < SK; k += 16) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], sheet + ((2 * wm + i + dy) * TW) * SS + k, SS);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], ws + (dy * SK + k) * WS + wn * 32 + j * 16, WS);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
  }
  epilogue(acc, reinterpret_cast<float*>(smem), y, bias, relu, t, H, W, Co);
}

// The nine-product kernel: no sheet, each tap's A operand is the halo tile
// shifted by (dy, dx).
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_9tap_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                        const float* __restrict__ bias, bf16* __restrict__ y, int H, int W,
                        int Ci, int Co, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + kHaloBytes);
  const Tile t = block_tile(H, W);
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    __syncthreads();  // the last chunk's products are done with the tiles
    load_halo(halo, x, t, c0, H, W, Ci);
    load_weights(ws, wp, c0, t.co0, Ci, Co);
    __syncthreads();
    FragA a[2];
    FragB b[2];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int k = 0; k < CK; k += 16) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], halo + ((2 * wm + i + dy) * HC + dx) * HS + k, HS);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                b[j], ws + ((dy * 3 + dx) * CK + k) * WS + wn * 32 + j * 16, WS);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
  }
  epilogue(acc, reinterpret_cast<float*>(smem), y, bias, relu, t, H, W, Co);
}

// Launch ``kernel`` over every pixel tile and channel tile. More than 48 KB of
// dynamic shared memory has to be asked for once per kernel.
template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, bool* configured, const void* x, const void* wp,
           const void* bias, void* y, int N, int H, int W, int Ci, int Co, int relu,
           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Ci % CK || Co % BN)
    return (int)cudaErrorInvalidValue;
  if (!*configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    *configured = true;
  }
  const int64_t tiles = (int64_t)N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)tiles, (unsigned int)(Co / BN));
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wp, (const float*)bias, (bf16*)y, H, W, Ci, Co, relu);
  return (int)cudaGetLastError();
}

template <int STAGES, bool ONE_PRODUCT>
int launch_k3c(const void* x, const void* wp, const void* bias, void* y, int N, int H, int W,
               int Ci, int Co, int relu, void* stream) {
  static bool configured = false;  // one per instantiation
  return launch(conv3x3_k3c_kernel<STAGES, ONE_PRODUCT>, kSmemK3c, &configured, x, wp, bias, y,
                N, H, W, Ci, Co, relu, stream);
}

}  // namespace

extern "C" {

// y (N, H, W, Co) bf16 = epilogue(conv3x3(x (N, H, W, Ci) bf16, wp (3, 3 * Ci, Co) bf16)),
// NHWC; bias (Co) float32 or null; relu 0 or 1. Each returns cudaGetLastError().
#define CONV3X3_ARGS                                                                        \
  const void *x, const void *wp, const void *bias, void *y, int N, int H, int W, int Ci,   \
      int Co, int relu, void *stream
#define CONV3X3_PASS x, wp, bias, y, N, H, W, Ci, Co, relu, stream

int conv3x3_k3c_bf16(CONV3X3_ARGS) { return launch_k3c<kFull, false>(CONV3X3_PASS); }

int conv3x3_9tap_bf16(CONV3X3_ARGS) {
  static bool configured = false;
  return launch(conv3x3_9tap_kernel, kSmem9tap, &configured, CONV3X3_PASS);
}

// The ablation's partial variants: timings only, their output is not a conv.
// No global loads, products on a resident (zeroed) sheet:
int conv3x3_k3c_mm_only_bf16(CONV3X3_ARGS) { return launch_k3c<0, false>(CONV3X3_PASS); }
// the same as one K = 9 * CK product:
int conv3x3_k3c_mm1_only_bf16(CONV3X3_ARGS) { return launch_k3c<0, true>(CONV3X3_PASS); }
// global loads + products on the resident sheet (no sheet build):
int conv3x3_k3c_dma_mm_bf16(CONV3X3_ARGS) { return launch_k3c<kLoad, false>(CONV3X3_PASS); }
// sheet build from a resident halo tile + products (no global loads):
int conv3x3_k3c_sheet_mm_bf16(CONV3X3_ARGS) { return launch_k3c<kSheet, false>(CONV3X3_PASS); }

}  // extern "C"
