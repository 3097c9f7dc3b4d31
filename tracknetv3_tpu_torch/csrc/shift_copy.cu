// Window, repeat and roll copies of NHWC tiles and frame stacks (any element
// of 1, 2 or 4 bytes: uint8 frames, bfloat16, float32), for Hopper (sm_90a).
// Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/shift_copy.py).
//
// Replaces the JAX package's Pallas TPU kernels in tools/probe_mosaic_caps.py,
// the halo / shift probes written to find which shifted views of an NHWC
// tile Mosaic can copy:
//   window_copy  <- u1_kernel :88  (leading-dimension window at a free offset),
//                   u2_kernel :107 and u7_kernel :230 (column offset 1 in the copy),
//                   u3_kernel :126 (column offset 1 sliced out of the fetched tile:
//                   the ``staged`` switch), u4_kernel :147 (channels 128..255 of 256)
//   repeat_rows  <- u5_kernel :164 (x2 row repeat; the probe's expectation is
//                   the interleaved np.repeat, which is what this computes)
//   roll_cols    <- u6_kernel :201 (roll by one column)
// On the train path they do what XLA fused into the JAX step's input assembly
// (tracknetv3_tpu/training/steps.py): the overlapping windows of a segment
// (:88-97), the per-segment median repeat (:102), the gather of device-resident
// frames (:75-79) and the two gathers of the frame-mixup blend (:56-57).
//
// Function (all are copies: every bit of an element is kept).
//   window_copy: out[i, t, w, c] = x[starts[i] + t, col0 + w, ch0 + c] for x
//                viewed as (R, W, C), i < n, t < rows, w < cols, c < chs.
//   repeat_rows: out[r * k + j] = x[r], j < k (interleaved, not tiled).
//   roll_cols:   out[r, w, :] = x[r, (w - shift) mod W, :].
//
// Design. Bound on the H100 SXM by bytes: each input byte is read once and
// each output byte written once, with no arithmetic beyond addresses. The
// kernels work in bytes, so one body serves every element type; the vector
// type V (16, 8, 4, 2 or 1 bytes) is the widest that divides every base
// pointer, stride, offset and extent of the launch (the wrapper chooses it;
// the entry points check it again). A frame start is a multiple of the frame's
// bytes, but a one-column shift of a 3-channel uint8 image is 3 bytes, so the
// width is a property of the launch, not of the type. One block copies
// kThreads * kUnroll vectors of one output row: each thread first issues its
// kUnroll loads, then its stores, so several 16-byte loads are in flight per
// thread; neighbouring threads touch neighbouring vectors. A block reads its
// own window start from the table (no host read-back). ``staged`` copies whole
// pixels of the source row into a 32 KB shared tile first and slices the tile,
// as U3 and U4 slice the fetched VMEM tile; the direct form slices in the
// global load, as U2 and U7 slice in the DMA. This is the simple, right first
// version: no TMA, no cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileBytes = 32768;  // the staged variant's shared tile

typedef long long i64;

struct WindowArgs {
  const unsigned char* x;
  const void* starts;
  unsigned char* out;
  int starts_i64;      // the table holds int64 (else int32)
  i64 rows;            // rows of x per window
  i64 row_stride;      // bytes of one row of x: W * pix_bytes
  i64 out_row_bytes;   // cols * chs_bytes
  i64 blocks_per_row;  // blocks that share one output row
  // direct: an output row is ``segs`` runs of ``seg_bytes`` contiguous bytes,
  // the s-th at byte off0 + s * seg_stride of the source row
  i64 off0, segs, seg_stride, seg_bytes;
  // staged: whole pixels [p0, p0 + tile_pix) of the source row go through
  // shared memory; of them columns [col0, col0 + cols) and bytes
  // [ch0_bytes, ch0_bytes + chs_bytes) of each pixel are written
  i64 W, pix_bytes, col0, cols, ch0_bytes, chs_bytes, tile_pix;
};

template <typename V, bool kStaged>
__global__ void __launch_bounds__(kThreads) window_copy_kernel(const WindowArgs a) {
  const i64 orow = (i64)(blockIdx.x / (unsigned int)a.blocks_per_row);
  const i64 chunk = (i64)(blockIdx.x % (unsigned int)a.blocks_per_row);
  const i64 i = orow / a.rows, t = orow - i * a.rows;
  const i64 start = a.starts_i64 ? reinterpret_cast<const i64*>(a.starts)[i]
                                 : (i64) reinterpret_cast<const int*>(a.starts)[i];
  const unsigned char* src = a.x + (start + t) * a.row_stride;
  unsigned char* dst = a.out + orow * a.out_row_bytes;
  constexpr i64 kV = (i64)sizeof(V);

  if constexpr (!kStaged) {
    const i64 units = a.out_row_bytes / kV;
    const i64 per_seg = a.seg_bytes / kV;
    const i64 u0 = chunk * (kThreads * kUnroll) + threadIdx.x;
    V v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const i64 u = u0 + (i64)j * kThreads;
      if (u < units) {
        const i64 s = (a.segs == 1) ? 0 : u / per_seg;
        const i64 k = u - s * per_seg;
        v[j] = *reinterpret_cast<const V*>(src + a.off0 + s * a.seg_stride + k * kV);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const i64 u = u0 + (i64)j * kThreads;
      if (u < units) *reinterpret_cast<V*>(dst + u * kV) = v[j];
    }
  } else {
    __shared__ uint4 tile16[kTileBytes / 16];
    unsigned char* tile = reinterpret_cast<unsigned char*>(tile16);
    const i64 p0 = chunk * a.tile_pix;
    const i64 pn = (a.W - p0 < a.tile_pix) ? (a.W - p0) : a.tile_pix;
    const i64 in_units = pn * a.pix_bytes / kV;
    const V* src_v = reinterpret_cast<const V*>(src + p0 * a.pix_bytes);
    for (i64 u = threadIdx.x; u < in_units; u += kThreads)
      reinterpret_cast<V*>(tile)[u] = src_v[u];
    __syncthreads();
    const i64 lo = (a.col0 > p0) ? a.col0 : p0;
    const i64 hi = (a.col0 + a.cols < p0 + pn) ? (a.col0 + a.cols) : (p0 + pn);
    if (hi <= lo) return;
    const i64 per_pix = a.chs_bytes / kV;
    const i64 out_units = (hi - lo) * per_pix;
    for (i64 u = threadIdx.x; u < out_units; u += kThreads) {
      const i64 p = u / per_pix, k = u - p * per_pix;
      const V val =
          *reinterpret_cast<const V*>(tile + (lo - p0 + p) * a.pix_bytes + a.ch0_bytes + k * kV);
      *reinterpret_cast<V*>(dst + (lo - a.col0 + p) * a.chs_bytes + k * kV) = val;
    }
  }
}

// x: (R, row_bytes) -> out: (R * k, row_bytes), out[r * k + j] = x[r].
template <typename V>
__global__ void __launch_bounds__(kThreads)
    repeat_rows_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                       i64 row_bytes, i64 k, i64 blocks_per_row) {
  const i64 r = (i64)(blockIdx.x / (unsigned int)blocks_per_row);
  const i64 chunk = (i64)(blockIdx.x % (unsigned int)blocks_per_row);
  constexpr i64 kV = (i64)sizeof(V);
  const i64 units = row_bytes / kV;
  const i64 u0 = chunk * (kThreads * kUnroll) + threadIdx.x;
  const unsigned char* src = x + r * row_bytes;
  V v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const i64 u = u0 + (i64)j * kThreads;
    if (u < units) v[j] = *reinterpret_cast<const V*>(src + u * kV);
  }
  for (i64 c = 0; c < k; ++c) {
    unsigned char* dst = out + (r * k + c) * row_bytes;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const i64 u = u0 + (i64)j * kThreads;
      if (u < units) *reinterpret_cast<V*>(dst + u * kV) = v[j];
    }
  }
}

// x, out: (R, W, pix_bytes); out[r, w] = x[r, (w - shift) mod W], 0 <= shift < W.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    roll_cols_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, i64 W,
                     i64 pix_bytes, i64 shift, i64 blocks_per_row) {
  const i64 r = (i64)(blockIdx.x / (unsigned int)blocks_per_row);
  const i64 chunk = (i64)(blockIdx.x % (unsigned int)blocks_per_row);
  constexpr i64 kV = (i64)sizeof(V);
  const i64 per_pix = pix_bytes / kV;
  const i64 units = W * per_pix;
  const i64 u0 = chunk * (kThreads * kUnroll) + threadIdx.x;
  const unsigned char* src = x + r * W * pix_bytes;
  unsigned char* dst = out + r * W * pix_bytes;
  V v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const i64 u = u0 + (i64)j * kThreads;
    if (u < units) {
      const i64 w = u / per_pix, k = u - w * per_pix;
      const i64 ws = (w >= shift) ? (w - shift) : (w - shift + W);
      v[j] = *reinterpret_cast<const V*>(src + ws * pix_bytes + k * kV);
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const i64 u = u0 + (i64)j * kThreads;
    if (u < units) *reinterpret_cast<V*>(dst + u * kV) = v[j];
  }
}

inline bool aligned(const void* p, i64 vec) { return ((uintptr_t)p % (uintptr_t)vec) == 0; }

inline bool divides(i64 vec, std::initializer_list<i64> values) {
  for (i64 v : values)
    if (v % vec) return false;
  return true;
}

// blocks of kThreads * kUnroll vectors that cover ``units`` vectors
inline i64 blocks_for(i64 units) {
  return (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
}

// the grid's x dimension holds rows * blocks_per_row blocks
inline bool grid_fits(i64 rows, i64 blocks_per_row) {
  return blocks_per_row > 0 && blocks_per_row <= 0x7fffffffLL &&
         rows <= 0x7fffffffLL / blocks_per_row;
}

template <typename V>
int launch_window(const WindowArgs& a, i64 out_rows, bool staged, cudaStream_t stream) {
  const unsigned int grid = (unsigned int)(out_rows * a.blocks_per_row);
  if (staged)
    window_copy_kernel<V, true><<<grid, kThreads, 0, stream>>>(a);
  else
    window_copy_kernel<V, false><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_repeat(const void* x, void* out, i64 R, i64 row_bytes, i64 k, cudaStream_t stream) {
  const i64 bpr = blocks_for(row_bytes / (i64)sizeof(V));
  if (!grid_fits(R, bpr)) return (int)cudaErrorInvalidValue;
  repeat_rows_kernel<V><<<(unsigned int)(R * bpr), kThreads, 0, stream>>>(
      (const unsigned char*)x, (unsigned char*)out, row_bytes, k, bpr);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_roll(const void* x, void* out, i64 R, i64 W, i64 pix_bytes, i64 shift,
                cudaStream_t stream) {
  const i64 bpr = blocks_for(W * pix_bytes / (i64)sizeof(V));
  if (!grid_fits(R, bpr)) return (int)cudaErrorInvalidValue;
  roll_cols_kernel<V><<<(unsigned int)(R * bpr), kThreads, 0, stream>>>(
      (const unsigned char*)x, (unsigned char*)out, W, pix_bytes, shift, bpr);
  return (int)cudaGetLastError();
}

#define DISPATCH_VEC(vec, CALL)                      \
  switch (vec) {                                     \
    case 16: return CALL(uint4);                     \
    case 8: return CALL(uint2);                      \
    case 4: return CALL(unsigned int);               \
    case 2: return CALL(unsigned short);             \
    case 1: return CALL(unsigned char);              \
    default: return (int)cudaErrorInvalidValue;      \
  }

}  // namespace

extern "C" {

// the staged variant's shared tile: a pixel (C elements) must fit in it
int shift_copy_tile_bytes() { return kTileBytes; }

// out (n, rows, cols, chs) = x[starts[i] + t, col0 + w, ch0 + c], x viewed as
// (R, W, C) with pixels of pix_bytes and channel offsets given in bytes.
// ``vec`` must divide both base pointers and every byte quantity. Returns a
// cudaError (1 = an argument that does not fit the kernel).
int window_copy(const void* x, const void* starts, int starts_i64, void* out, long long n,
                long long rows, long long W, long long pix_bytes, long long col0, long long cols,
                long long ch0_bytes, long long chs_bytes, int staged, int vec, void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0 || chs_bytes <= 0) return 0;
  if (col0 < 0 || col0 + cols > W || ch0_bytes < 0 || ch0_bytes + chs_bytes > pix_bytes)
    return (int)cudaErrorInvalidValue;
  WindowArgs a;
  a.x = (const unsigned char*)x;
  a.starts = starts;
  a.out = (unsigned char*)out;
  a.starts_i64 = starts_i64;
  a.rows = rows;
  a.row_stride = W * pix_bytes;
  a.out_row_bytes = cols * chs_bytes;
  a.W = W;
  a.pix_bytes = pix_bytes;
  a.col0 = col0;
  a.cols = cols;
  a.ch0_bytes = ch0_bytes;
  a.chs_bytes = chs_bytes;
  if (chs_bytes == pix_bytes) {  // whole pixels: one run per output row
    a.segs = 1;
    a.seg_bytes = cols * pix_bytes;
    a.seg_stride = 0;
  } else {  // a channel range: one run per pixel
    a.segs = cols;
    a.seg_bytes = chs_bytes;
    a.seg_stride = pix_bytes;
  }
  a.off0 = col0 * pix_bytes + ch0_bytes;
  a.tile_pix = 0;
  if (!aligned(x, vec) || !aligned(out, vec) ||
      !divides(vec, {a.row_stride, a.off0, a.seg_stride, a.seg_bytes}))
    return (int)cudaErrorInvalidValue;
  if (staged) {
    if (pix_bytes > kTileBytes || !divides(vec, {pix_bytes, ch0_bytes, chs_bytes}))
      return (int)cudaErrorInvalidValue;
    a.tile_pix = kTileBytes / pix_bytes;
    a.blocks_per_row = (W + a.tile_pix - 1) / a.tile_pix;
  } else {
    a.blocks_per_row = blocks_for(a.out_row_bytes / vec);
  }
  if (!grid_fits(n * rows, a.blocks_per_row)) return (int)cudaErrorInvalidValue;
#define CALL_WINDOW(V) launch_window<V>(a, n * rows, staged != 0, (cudaStream_t)stream)
  DISPATCH_VEC(vec, CALL_WINDOW)
#undef CALL_WINDOW
}

// out (R * k, row_bytes): out[r * k + j] = x[r].
int repeat_rows(const void* x, void* out, long long R, long long row_bytes, long long k, int vec,
                void* stream) {
  if (R <= 0 || row_bytes <= 0 || k <= 0) return 0;
  if (!aligned(x, vec) || !aligned(out, vec) || !divides(vec, {row_bytes}))
    return (int)cudaErrorInvalidValue;
#define CALL_REPEAT(V) launch_repeat<V>(x, out, R, row_bytes, k, (cudaStream_t)stream)
  DISPATCH_VEC(vec, CALL_REPEAT)
#undef CALL_REPEAT
}

// out (R, W, pix_bytes): out[r, w] = x[r, (w - shift) mod W], 0 <= shift < W.
int roll_cols(const void* x, void* out, long long R, long long W, long long pix_bytes,
              long long shift, int vec, void* stream) {
  if (R <= 0 || W <= 0 || pix_bytes <= 0) return 0;
  if (shift < 0 || shift >= W || !aligned(x, vec) || !aligned(out, vec) ||
      !divides(vec, {pix_bytes}))
    return (int)cudaErrorInvalidValue;
#define CALL_ROLL(V) launch_roll<V>(x, out, R, W, pix_bytes, shift, (cudaStream_t)stream)
  DISPATCH_VEC(vec, CALL_ROLL)
#undef CALL_ROLL
}

}  // extern "C"
