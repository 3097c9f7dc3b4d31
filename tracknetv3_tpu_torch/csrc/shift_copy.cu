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
// kernels work in bytes, so one body serves every element type. A launch of
// window_copy takes one of three routes, which ops/shift_copy.py copy_plan
// chooses from the launch's geometry and passes in with every size of the
// launch (the entry point checks the plan against its own constants):
// - bulk (a copy of whole rows, whose base pointers, offsets and strides
//   are multiples of 16 bytes, large enough that every block walks at least
//   kStages full pieces: at the README configuration the train path's frame
//   gathers and segment expansion, 35 MB each; on smaller copies the vector
//   body measured faster on an H100, PERF.md). A persistent grid of one-warp
//   blocks, as many per SM as the ring's shared memory lets reside (two at
//   the largest stages). The output is a list of units (16 to 128 bytes of
//   a row, as wide as the pointers and strides allow: a bulk copy that starts
//   off a 128-byte line is slower), and block b takes units
//   [b * units / grid, (b + 1) * units / grid): every block moves the same
//   bytes to within a unit, so no block is left with one more piece than
//   the others. It walks its share in pieces of up to kMaxStageBytes (24 KB)
//   that end at a row's end. Its lane 0 works a ring of kStages shared-memory
//   stages: it issues the piece's 1-D bulk TMA load (cp.async.bulk ...
//   complete_tx::bytes) kLag pieces ahead, waits on the stage's mbarrier,
//   issues one bulk store of the piece
//   (cp.async.bulk.global.shared::cta.bulk_group), and refills a stage only
//   after wait_group.read says its store has left shared memory. Loads of
//   later pieces overlap the stores of earlier ones; no data passes through
//   registers. A block finds its first unit with one divide and steps from
//   piece to piece; the next window's start is read one window ahead of use.
// - vector (any other direct launch: a channel range, a smaller copy, a
//   one-column shift of a 3-byte uint8 pixel): one block copies
//   kThreads * kUnroll vectors of one output row; the vector type V (16, 8,
//   4, 2 or 1 bytes) is the widest that divides every base pointer, stride,
//   offset and extent of the launch; each thread first issues its kUnroll
//   loads, then its stores.
// - staged (U3, U4 staged): whole pixels of the source row go into a shared
//   tile of up to 32 KB and are sliced there, as U3 and U4 slice the fetched
//   VMEM tile; the vector body moves them. The plan sizes the tile so that
//   the grid fills the card.
// A block reads its own window start from the table (no host read-back).
// repeat_rows and roll_cols keep the vector body.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

// Hopper's 1-D bulk asynchronous copies (TMA without a tensor map) and the
// shared-memory mbarriers that count their bytes, as inline PTX.
//
// A load  cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes
//         copies a contiguous run of global memory into shared memory and
//         reports its bytes to an mbarrier; a thread arms the barrier with
//         the bytes it expects (mbar_arrive_expect_tx) and every reader waits
//         on the barrier's phase parity (mbar_wait).
// A store cp.async.bulk.global.shared::cta.bulk_group copies a run of shared
//         memory to global memory; stores are grouped by commit_group, and
//         wait_group.read N returns once all but the N newest groups have
//         finished reading shared memory (the buffer may then be refilled).
// Sizes and both addresses must be multiples of 16 bytes.

namespace bulk {

// A barrier wait that has not completed after this long traps, so a ring
// that is wrong ends the launch with an error instead of hanging the card.
constexpr long long kWaitLimitNs = 10000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (the copies)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity ``parity`` has completed; trap after
// kWaitLimitNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      const long long now = globaltimer_ns();
      if (spins == 0) start = now;
      else if (now - start > kWaitLimitNs) __trap();
    }
  }
}

// global -> shared, ``bytes`` (a multiple of 16), completion on ``bar``
__device__ __forceinline__ void load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, ``bytes`` (a multiple of 16), in the current bulk group
__device__ __forceinline__ void store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// all but the N newest bulk groups have finished reading shared memory
template <int N>
__device__ __forceinline__ void wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

}  // namespace bulk

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileBytes = 32768;  // the staged variant's shared tile
// the bulk route: a ring of kStages stages of at most kMaxStageBytes, loads
// issued kLag pieces ahead of the store, blocks of one warp, as many per SM
// as their shared memory allows, up to kMaxBulkBlocksPerSM
constexpr int kStages = 4;
constexpr int kLag = 3;
constexpr int kMaxStageBytes = 24576;
constexpr int kBulkThreads = 32;
constexpr int kMaxBulkBlocksPerSM = 4;
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, before the stages
constexpr int kMaxDevices = 64;
static_assert(kLag < kStages, "a stage is refilled only after its store was issued");
static_assert(kStages * 8 <= kBarrierBytes, "one 8-byte mbarrier per stage");

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

struct BulkArgs {
  const unsigned char* x;
  const void* starts;
  unsigned char* out;
  int starts_i64;
  i64 n, rows;          // windows, rows per window
  i64 row_stride;       // bytes of one row of x
  i64 out_row_bytes;
  i64 off0;             // as in WindowArgs
  // an output row is one run of the source row from byte off0, taken as
  // units_per_row units of unit_bytes (16 to 128); a piece is up to
  // chunk_units units of one row; ``units`` over all rows
  i64 unit_bytes, units_per_row, chunk_units, units;
  i64 stage_bytes;
};

__device__ __forceinline__ i64 load_start(const BulkArgs& a, i64 i) {
  return a.starts_i64 ? reinterpret_cast<const i64*>(a.starts)[i]
                      : (i64) reinterpret_cast<const int*>(a.starts)[i];
}

// Where one piece comes from and goes to.
struct Piece {
  const unsigned char* src;  // first source byte of the piece
  unsigned char* dst;
  unsigned int bytes;
};

// Steps through a block's share of units [u, end) piece by piece: the output
// row and unit within it, the window and row within the window, and the
// window's start (the next one read ahead).
struct Cursor {
  i64 u, end, orow, k, i, t, start, next_start;

  __device__ __forceinline__ void begin(const BulkArgs& a, i64 u0, i64 u1) {
    u = u0;
    end = u1;
    orow = u0 / a.units_per_row;
    k = u0 - orow * a.units_per_row;
    i = orow / a.rows;
    t = orow - i * a.rows;
    start = load_start(a, i);
    next_start = (i + 1 < a.n) ? load_start(a, i + 1) : 0;
  }

  __device__ __forceinline__ bool done() const { return u >= end; }

  // the piece at the cursor, and the cursor moved past it
  __device__ __forceinline__ Piece take(const BulkArgs& a) {
    i64 m = a.chunk_units;
    if (a.units_per_row - k < m) m = a.units_per_row - k;
    if (end - u < m) m = end - u;
    Piece p;
    p.src = a.x + (start + t) * a.row_stride + a.off0 + k * a.unit_bytes;
    p.dst = a.out + orow * a.out_row_bytes + k * a.unit_bytes;
    p.bytes = (unsigned int)(m * a.unit_bytes);
    u += m;
    k += m;
    if (k == a.units_per_row) {
      k = 0;
      ++orow;
      if (++t == a.rows) {
        t = 0;
        ++i;
        start = next_start;
        if (i + 1 < a.n) next_start = load_start(a, i + 1);
      }
    }
    return p;
  }
};

// The bulk route (see the design note). One warp per block: every lane
// steps the cursor, lane 0 works the ring.
__global__ void __launch_bounds__(kBulkThreads) window_copy_bulk_kernel(const BulkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const i64 u0 = (i64)blockIdx.x * a.units / gridDim.x;
  const i64 u1 = (i64)(blockIdx.x + 1) * a.units / gridDim.x;
  if (u1 <= u0) return;
  const int lane = threadIdx.x;
  const uint32_t bars = bulk::smem_u32(smem);
  const uint32_t stage0 = bars + kBarrierBytes;
  // destination and bytes of the piece in each stage, for its store
  __shared__ unsigned char* stage_dst[kStages];
  __shared__ unsigned int stage_bytes[kStages];
  Cursor cur;
  cur.begin(a, u0, u1);  // its window-start loads overlap the barriers' set-up
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bulk::mbar_init(bars + 8 * s, 1);
    bulk::mbar_init_fence();
  }
  __syncwarp();
  // issue the load of local piece j (the one at the cursor) into its stage
  auto issue = [&](i64 j) {
    const int s = (int)(j % kStages);
    const Piece p = cur.take(a);
    if (lane == 0) {
      stage_dst[s] = p.dst;
      stage_bytes[s] = p.bytes;
      bulk::mbar_arrive_expect_tx(bars + 8 * s, p.bytes);
      bulk::load(stage0 + (uint32_t)(s * a.stage_bytes), p.src, p.bytes, bars + 8 * s);
    }
    __syncwarp();
  };

  i64 issued = 0;  // pieces whose loads are issued; kLag ahead of the store
  while (issued < kLag && !cur.done()) issue(issued++);
  for (i64 j = 0; j < issued; ++j) {
    if (!cur.done()) {  // piece j + kLag
      // its stage last held piece j + kLag - kStages, whose store was
      // followed by kStages - kLag - 1 newer ones
      if (issued >= kStages && lane == 0) bulk::wait_group_read<kStages - kLag - 1>();
      __syncwarp();
      issue(issued++);
    }
    const int s = (int)(j % kStages);
    if (lane == 0) {
      bulk::mbar_wait(bars + 8 * s, (uint32_t)((j / kStages) & 1));
      bulk::store(stage_dst[s], stage0 + (uint32_t)(s * a.stage_bytes), stage_bytes[s]);
      bulk::commit_group();
    }
  }
  if (lane == 0) bulk::wait_group_read<0>();  // the stores' writes finish on their own
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

// window_copy's launch plan (ops/shift_copy.py copy_plan), int64 in this order.
enum Plan {
  P_ROUTE, P_VEC, P_BLOCKS_PER_ROW, P_TILE_PIX, P_UNIT_BYTES, P_UNITS_PER_ROW, P_CHUNK_UNITS,
  P_UNITS, P_STAGE_BYTES, P_GRID, P_THREADS, P_SMEM, P_BLOCKS_PER_SM, P_LEN
};
enum Route { kRouteVector = 0, kRouteStaged = 1, kRouteBulk = 2 };

// The bulk plan must cover the geometry with pieces that fit their stages.
bool bulk_plan_matches(const BulkArgs& b, const long long* p) {
  if (p[P_VEC] != 16 || p[P_BLOCKS_PER_ROW] != 0 || p[P_TILE_PIX] != 0 ||
      p[P_THREADS] != kBulkThreads ||
      p[P_BLOCKS_PER_SM] < 1 || p[P_BLOCKS_PER_SM] > kMaxBulkBlocksPerSM)
    return false;
  if (b.stage_bytes <= 0 || b.stage_bytes > kMaxStageBytes || b.stage_bytes % 128 ||
      p[P_SMEM] != kBarrierBytes + kStages * b.stage_bytes)
    return false;
  if (b.units_per_row * b.unit_bytes != b.out_row_bytes || b.chunk_units < 1 ||
      b.chunk_units * b.unit_bytes > b.stage_bytes)
    return false;
  return b.units == b.n * b.rows * b.units_per_row && p[P_GRID] >= 1 && p[P_GRID] <= b.units &&
         p[P_GRID] <= 0x7fffffffLL;
}

// What the bulk kernel's launch needs of the current device, read at its
// first bulk launch with this shared memory and kept: the dynamic shared
// memory attribute set, and the most blocks its grid may have there (its
// SMs times the plan's blocks per SM, where the occupancy API confirms that
// many fit on an SM; else 0).
int bulk_max_grid(int smem, long long blocks_per_sm, long long* out) {
  struct Seen { int smem = -1, attr_smem = -1, sms = 0, per_sm = 0; };
  static Seen seen[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Seen& d = seen[dev];
  if (d.smem != smem) {
    if (smem > d.attr_smem) {
      err = cudaFuncSetAttribute(window_copy_bulk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      d.attr_smem = smem;
    }
    if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, window_copy_bulk_kernel,
                                                        kBulkThreads, smem);
    if (err != cudaSuccess) return (int)err;
    d.smem = smem;
  }
  *out = d.per_sm >= blocks_per_sm ? (long long)d.sms * blocks_per_sm : 0;
  return 0;
}

int launch_bulk(const BulkArgs& b, const long long* p, cudaStream_t stream) {
  const int smem = (int)p[P_SMEM];
  long long max_grid = 0;
  const int err = bulk_max_grid(smem, p[P_BLOCKS_PER_SM], &max_grid);
  if (err != 0) return err;
  if (p[P_GRID] > max_grid) return (int)cudaErrorInvalidValue;
  window_copy_bulk_kernel<<<(unsigned int)p[P_GRID], kBulkThreads, smem, stream>>>(b);
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

// The constants ops/shift_copy.py checks against its own: the staged
// variant's largest tile (a pixel must fit in it), the vector body's threads
// and unroll, the bulk ring's stages, largest stage, threads, most blocks per
// SM, barrier bytes and load lag, and the plan's length.
int shift_copy_constants(long long* out) {
  const long long c[] = {kTileBytes, kThreads, kUnroll, kStages, kMaxStageBytes,
                         kBulkThreads, kMaxBulkBlocksPerSM, kBarrierBytes, kLag, P_LEN};
  for (int i = 0; i < (int)(sizeof(c) / sizeof(c[0])); ++i) out[i] = c[i];
  return 0;
}

// out (n, rows, cols, chs) = x[starts[i] + t, col0 + w, ch0 + c], x viewed as
// (R, W, C) with pixels of pix_bytes and channel offsets given in bytes.
// ``plan``: copy_plan's P_LEN int64s (route, vector width, items, grid,
// shared memory); a plan that does not fit the geometry or this source's
// constants is refused. Returns a cudaError (1 = an argument that does not
// fit the kernel).
int window_copy(const void* x, const void* starts, int starts_i64, void* out, long long n,
                long long rows, long long W, long long pix_bytes, long long col0, long long cols,
                long long ch0_bytes, long long chs_bytes, const long long* plan, void* stream) {
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
  const i64 route = plan[P_ROUTE], vec = plan[P_VEC];
  if (vec < 1 || vec > 16 || (vec & (vec - 1)) || !aligned(x, vec) || !aligned(out, vec) ||
      !divides(vec, {a.row_stride, a.off0, a.seg_stride, a.seg_bytes}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == kRouteBulk) {
    BulkArgs b;
    b.x = a.x;
    b.starts = starts;
    b.out = a.out;
    b.starts_i64 = starts_i64;
    b.n = n;
    b.rows = rows;
    b.row_stride = a.row_stride;
    b.out_row_bytes = a.out_row_bytes;
    b.off0 = a.off0;
    b.unit_bytes = plan[P_UNIT_BYTES];
    // whole pixels (one run a row) in units of 16 to 128 bytes, on which
    // every piece starts
    if (a.segs != 1 || b.unit_bytes < 16 || b.unit_bytes > 128 ||
        (b.unit_bytes & (b.unit_bytes - 1)) || !aligned(x, b.unit_bytes) ||
        !aligned(out, b.unit_bytes) ||
        !divides(b.unit_bytes, {a.row_stride, a.off0, a.out_row_bytes}))
      return (int)cudaErrorInvalidValue;
    b.units_per_row = plan[P_UNITS_PER_ROW];
    b.chunk_units = plan[P_CHUNK_UNITS];
    b.units = plan[P_UNITS];
    b.stage_bytes = plan[P_STAGE_BYTES];
    if (!bulk_plan_matches(b, plan)) return (int)cudaErrorInvalidValue;
    return launch_bulk(b, plan, st);
  }
  if (route != kRouteVector && route != kRouteStaged) return (int)cudaErrorInvalidValue;
  const bool staged = route == kRouteStaged;
  if (staged) {  // the plan's tile: whole pixels, at most kTileBytes
    a.tile_pix = plan[P_TILE_PIX];
    if (a.tile_pix < 1 || a.tile_pix * pix_bytes > kTileBytes ||
        !divides(vec, {pix_bytes, ch0_bytes, chs_bytes}))
      return (int)cudaErrorInvalidValue;
    a.blocks_per_row = (W + a.tile_pix - 1) / a.tile_pix;
  } else {
    if (plan[P_TILE_PIX] != 0) return (int)cudaErrorInvalidValue;
    a.blocks_per_row = blocks_for(a.out_row_bytes / vec);
  }
  if (!grid_fits(n * rows, a.blocks_per_row) || plan[P_BLOCKS_PER_ROW] != a.blocks_per_row ||
      plan[P_GRID] != n * rows * a.blocks_per_row || plan[P_THREADS] != kThreads ||
      plan[P_SMEM] != 0)
    return (int)cudaErrorInvalidValue;
#define CALL_WINDOW(V) launch_window<V>(a, n * rows, staged, st)
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
