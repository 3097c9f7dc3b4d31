// SAME 3x3 convolution of NHWC bfloat16 activations as an implicit GEMM on
// Hopper's tensor cores, with the folded serving forward's epilogue in its
// body:
//   y = bf16(relu(acc_f32 + bias_f32))
// float32 accumulation over all 9 * Ci terms, the bias added to the
// accumulator (__fadd_rn), a NaN-keeping ReLU, one round-to-nearest-even to
// bfloat16. For sm_90a. Plain C interface, loaded with ctypes
// (tracknetv3_tpu_torch/ops/conv3x3.py, whose launch_plan computes every
// size, grid and tensor map that a launch passes in).
//
// Replaces the JAX package's Pallas TPU probe kernels:
//   k3c   <- tools/probe_pallas_conv.py:48 (make_conv3x3) and :130 with
//            sheet=True (make_conv3x3_wide); tools/probe_pallas_ablate.py:63
//            variant "full", and its partial variants as stage switches
//   9tap  <- tools/probe_pallas_conv.py:130 with sheet=False;
//            tools/probe_pallas_ablate.py:63 variant "full-9mm"
// and computes, with the epilogue, _conv_relu of the serving forward
// (tracknetv3_tpu/models/fused_forward.py:63). With a null bias and relu = 0
// it is the probes' bare conv.
//
// Function. x (N, H, W, Ci), packed weights (3, 3 * Ci, Co) = the HWIO kernel
// reshaped, rows (dx, ci) for each dy, i.e. (9 taps, Ci, Co); bias (Co)
// float32 or null; y (N, H, W, Co):
//   acc[n, h, w, co] = sum over dy, dx, ci of
//       x[n, h + dy - 1, w + dx - 1, ci] * wp[dy, dx * Ci + ci, co]
// with x = 0 outside the image.
//
// What bounds it. Operations, at every serving shape but the first layer's
// (2 * 9 * Ci * Co per output pixel against 2 * (Ci + Co) bytes), and on the
// way there the bytes each block reads from L2: every pixel tile reads the
// whole weight tensor once, 9 * Ci * BN * 2 bytes per M * BN outputs, so
// M = 128 pixels per block make 128 operations per weight byte. (Clusters of
// two blocks sharing each weight stage by TMA multicast were measured and ran
// 1.86x slower on an H100, likely because the pairs then advance in lockstep.)
//
// Design (one main loop, two A-operand paths):
// - A block of 288 threads: two consumer warpgroups (warps 0-7) and one
//   producer warp (warp 8). It owns TH x TW = 8 x 16 output pixels (M = 128;
//   each consumer warpgroup 4 rows = one m64 block, each of its warps one
//   row of 16) and BN = 128 output channels (64 where Co = 64), and walks
//   the input channels in chunks of CK = 64 (128 bytes per pixel). At
//   BN = 64 the 9tap kernel takes MW = 2 m64 blocks per warpgroup (TH = 16,
//   M = 256): the accumulators fit in registers at that width, and each
//   weight byte then serves twice the products.
// - TMA loads with the halo for free: one box (CK, TW + 2, TH + 2, 1) of a
//   4-D tensor map over x (C, W, H, N) at (c0, w0 - 1, h0 - 1, n) lands the
//   halo tile; the hardware zero-fills every coordinate outside the image,
//   the channels past Ci included, so Ci need only be a multiple of 8 (the
//   16-byte global stride). The weights come by a 3-D map over (Co, Ci, 9
//   taps): one box (64, CK, 3) per 64 output channels is the three taps of
//   one kernel row dy. Both land 128B-swizzled (CU_TENSOR_MAP_SWIZZLE_128B:
//   16-byte chunk q of 128-byte row r at chunk q ^ (r % 8)), which is
//   wgmma's canonical layout and keeps every read below free of bank
//   conflicts.
// - An mbarrier ring. The producer keeps two halo buffers (one per chunk)
//   and kWStages weight stages (one per (chunk, dy): 3 * CK x BN) in flight,
//   each signalled on a full barrier with expect-tx; the consumer warps
//   release each buffer on its empty barrier (8 arrivals: one per warp)
//   once the products that read it are done (wgmma.wait_group is called only
//   before such a release, and before the epilogue).
// - wgmma m64nBNk16, bf16 in, float32 accumulators in registers across all
//   chunks; B (the weights) by descriptor, MN-major (co contiguous), LBO =
//   the 64-channel block stride, SBO = 1024 bytes (8 rows of 128 bytes).
// - k3c (P1, P2 sheet, P3 full): each consumer warpgroup copies its 6 halo
//   rows into its own dx-concatenated im2col sheet, three 128B-swizzled
//   blocks of 96 pixel rows (one per dx), and runs one K = 3 * CK product
//   per dy with A and B from shared memory (SS). The dy shift is 16 pixel
//   rows = 2048 bytes, two whole swizzle atoms, so every A descriptor starts
//   atom-aligned; the K step inside a 128-byte row is a 32-byte start offset.
//   The products drain at the end of each chunk, before the next sheet
//   build (a wgmma pipeline stage spanning the build's stores makes ptxas
//   serialise every product, C7515).
// - 9tap (P2 sheet=False, P3 full-9mm): no sheet. Each tap's A operand is
//   the halo tile shifted by (dy, dx); a one-pixel dx shift is 128 bytes,
//   inside a swizzle atom, so A is loaded with ldmatrix (lane addresses may
//   point anywhere) and multiplied from registers (RS), double-buffered over
//   one group of 4 MW products per tap.
// - Epilogue from registers: bias, ReLU and the bf16 pack on the
//   accumulator fragments, 4-byte stores into a 128B-swizzled staging tile
//   (k3c: the warpgroup's own sheet; 9tap: its own 16 KB), then one TMA
//   store per m64 block and 64 channels, box (64, TW, 4, 1), whose bounds
//   clip the ragged H and W edges.
// - A barrier wait that has not completed after 10 seconds traps, so a
//   pipeline fault ends the launch with an error instead of hanging the card.
//
// Shared memory, bytes (each buffer 1024-aligned; 1024 of slack to align the
// base; 128 for the barriers):
//   halo buffer     23,040 (10 x 18 pixels x 128), 23,552 with its padding, x 2;
//                   MW = 2: 41,472 (18 x 18 x 128), 41,984
//   weight stage    BN / 64 x 24,576 (3 taps x 64 ci x 128), kWStages of them
//   k3c sheet       36,864 per warpgroup (3 dx x 96 pixels x 128), x 2
//   9tap staging    MW x BN / 64 x 8,192 per warpgroup, x 2
//   k3c:  2 weight stages, 220,288 at BN = 128 (171,136 at BN = 64)
//   9tap: 3 weight stages, 228,480 at BN = 128 (191,616 at BN = 64, MW = 2)
// out of 232,448: one block per SM.
//
// The ablation's partial variants ("mm-only", "mm1-only", "dma+mm",
// "sheet+mm") are stage switches of the k3c kernel (BN = 128 only): no
// global loads (products on zeroed shared memory), no sheet build, or one
// commit group per chunk instead of one per dy. They are timings with no
// defined output.
//
// Both kernels add the terms of a chunk in the same order (dy, dx, ci in 16s),
// and the tensor cores add each group of 16 in a fixed order, so the two
// agree bit for bit.
//
// Requires Ci a multiple of 8 (the first layer's 27 channels are padded to 32
// by the caller), Co a multiple of 64, 16-byte aligned pointers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;     // output pixel tile: 8 MW rows x 16 columns
constexpr int CK = 64;     // input channels per chunk: one 128-byte row per pixel
constexpr int HC = TW + 2;
constexpr int M64_ROWS = 4;  // tile rows of one m64 block (64 pixels)
constexpr int SHEET_ROWS = M64_ROWS + 2;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kSheetBlock = SHEET_ROWS * TW * 128;             // 12,288: one dx
constexpr int kSheetBytes = 3 * kSheetBlock;                   // 36,864 per warpgroup
constexpr int kWBlock = 3 * CK * 128;                          // 24,576: 64 channels
constexpr int kStoreBlock = M64_ROWS * TW * 128;               // 8,192: 64 pixels x 64 channels
constexpr int kBarrierBytes = 128;
constexpr int kAlignSlack = 1024;
constexpr long long kWaitLimitNs = 10000000000LL;
static_assert(kStoreBlock * 2 <= kSheetBytes, "k3c stages its output in its sheet");

// stage switches of the k3c kernel (the ablation's variants)
constexpr int kLoad = 1;   // TMA loads of the halo tile and the weights
constexpr int kSheet = 2;  // build the sheet from the halo tile
constexpr int kOne = 4;    // one commit group per chunk (no loads: nothing to release)
constexpr int kFull = kLoad | kSheet;

// The tile of a kernel with MW m64 blocks per consumer warpgroup: TH = 8 MW
// rows (M = 128 MW pixels) and its halo.
template <int MW>
struct Tile {
  static constexpr int TH = 2 * M64_ROWS * MW, HR = TH + 2;
  static constexpr int kHaloBox = HR * HC * 128;                    // 23,040 (MW 1)
  static constexpr int kHaloBuf = (kHaloBox + 1023) / 1024 * 1024;  // 23,552 (MW 1)
};

template <bool K3C>
struct Layout {
  static constexpr int kWStages = K3C ? 2 : 3;
};

template <bool K3C, int BN, int MW>
__host__ __device__ constexpr int smem_bytes() {
  return kAlignSlack + 2 * Tile<MW>::kHaloBuf +
         2 * (K3C ? kSheetBytes : MW * (BN / 64) * kStoreBlock) +
         Layout<K3C>::kWStages * (BN / 64) * kWBlock + kBarrierBytes;
}
static_assert(smem_bytes<true, 128, 1>() == 220288, "the source note's k3c bytes");
static_assert(smem_bytes<false, 128, 1>() == 228480, "the source note's 9tap bytes");
static_assert(smem_bytes<true, 64, 1>() == 171136 && smem_bytes<false, 64, 2>() == 191616,
              "the source note's bytes at BN = 64");
static_assert(smem_bytes<false, 128, 1>() <= 232448, "one block per SM");

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity ``parity`` has completed; trap after 10 s.
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand whose swizzle
// atoms (8 rows of 128 bytes) start 1024-aligned: start address, leading and
// stride byte offsets in 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk ``q`` of 128-byte row ``row`` in a
// 128B-swizzled buffer whose base is 1024-aligned (TMA's SWIZZLE_128B).
__device__ __forceinline__ uint32_t sw128(int row, int q) {
  return (uint32_t)(row * 128 + ((q ^ (row & 7)) << 4));
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d += A (64 x 16: shared memory, K-major) * B (16 x 64: shared memory, MN-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
  // d += A (64 x 16: registers, ldmatrix layout) * B (16 x 64: shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d += A (64 x 16: shared memory, K-major) * B (16 x 128: shared memory, MN-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
  // d += A (64 x 16: registers, ldmatrix layout) * B (16 x 128: shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// max(v, 0) that keeps NaN, as jnp.maximum and torch.maximum do (fmaxf drops it).
__device__ __forceinline__ float relu_nan(float v) { return (v != v) ? v : fmaxf(v, 0.0f); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The conv. K3C picks the A path (sheet + SS, or shifted halo + ldmatrix +
// RS); STAGES switches parts of the k3c pipeline off for the ablation.
template <bool K3C, int BN, int STAGES, int MW>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w,
                   const __grid_constant__ CUtensorMap tmap_y, const float* __restrict__ bias,
                   int relu, int Ci, int H, int tiles_w, int tiles_h) {
  constexpr int S = Layout<K3C>::kWStages;
  constexpr int R = BN / 2;   // float32 accumulators per thread
  constexpr int NB = BN / 64;  // 64-channel blocks
  constexpr int kWStage = NB * kWBlock;
  constexpr int TH = Tile<MW>::TH, WG_ROWS = MW * M64_ROWS;  // tile rows, a warpgroup's
  constexpr int kHaloBox = Tile<MW>::kHaloBox, kHaloBuf = Tile<MW>::kHaloBuf;
  constexpr int kPerWg = K3C ? kSheetBytes : MW * NB * kStoreBlock;
  constexpr bool LOAD = (STAGES & kLoad) != 0, SHEET = (STAGES & kSheet) != 0;
  constexpr bool ONE = (STAGES & kOne) != 0;
  static_assert(K3C || STAGES == kFull, "the stage switches are the k3c kernel's");
  static_assert(!K3C || MW == 1, "a k3c warpgroup's sheet holds one m64 block");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* per_wg = smem + 2 * kHaloBuf;  // sheets (k3c) or staging tiles (9tap)
  unsigned char* wst = per_wg + 2 * kPerWg;     // weight stages
  const uint32_t bars = smem_u32(wst + S * kWStage);
  const uint32_t halo_full = bars, halo_empty = bars + 16;  // [2] each
  const uint32_t w_full = bars + 32, w_empty = bars + 32 + 8 * S;  // [S] each

  int b = blockIdx.x;
  const int w0 = (b % tiles_w) * TW;
  b /= tiles_w;
  const int h0 = (b % tiles_h) * TH;
  const int n = b / tiles_h;
  const int co0 = blockIdx.y * BN;
  const int nchunks = (Ci + CK - 1) / CK;

  if (STAGES != kFull) {  // the partial variants read shared memory nothing loads
    for (int i = threadIdx.x; i < (int)(wst + S * kWStage - smem) / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(halo_full + 8 * i, 1);
      mbar_init(halo_empty + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // The producer: the halo tile of each chunk, then its three weight stages.
    if (LOAD && lane == 0) {
      for (int c = 0; c < nchunks; ++c) {
        const int hb = c & 1;
        mbar_wait(halo_empty + 8 * hb, ((c >> 1) & 1) ^ 1);
        mbar_expect_tx(halo_full + 8 * hb, kHaloBox);
        tma_load_4d(smem_u32(smem + hb * kHaloBuf), &tmap_x, halo_full + 8 * hb, c * CK, w0 - 1,
                    h0 - 1, n);
        for (int dy = 0; dy < 3; ++dy) {
          const int it = 3 * c + dy, s = it % S;
          mbar_wait(w_empty + 8 * s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(w_full + 8 * s, kWStage);
          for (int nb = 0; nb < NB; ++nb)
            tma_load_3d(smem_u32(wst + s * kWStage + nb * kWBlock), &tmap_w, w_full + 8 * s,
                        co0 + nb * 64, c * CK, 3 * dy);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns tile rows WG_ROWS wg .. + WG_ROWS - 1,
  // MW m64 blocks of 4 rows; in block mb its warp wq owns row
  // WG_ROWS wg + 4 mb + wq, A rows 16 wq .. 16 wq + 15 of the block's 64.
  const int wg = warp / 4, wq = warp % 4, tid = threadIdx.x % 128;
  unsigned char* own = per_wg + wg * kPerWg;
  float acc[MW][R];
#pragma unroll
  for (int mb = 0; mb < MW; ++mb)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[mb][i] = 0.0f;
  int released = 0;  // weight stages handed back so far, in fill order
  auto release_weights = [&](int last) {
    for (; released <= last; ++released)
      if (lane == 0) mbar_arrive(w_empty + 8 * (released % S));
  };
  const uint32_t lbo_b = kWBlock, sbo = 1024;
  uint32_t frag[2][MW][4][4];  // 9tap: A fragments, double-buffered over groups

  for (int c = 0; c < nchunks; ++c) {
    const int hb = c & 1;
    if (!K3C && c > 0) {
      wgmma_wait<0>();  // the last chunk's products are done
      if (LOAD) {
        release_weights(3 * c - 1);
        if (lane == 0) mbar_arrive(halo_empty + 8 * ((c - 1) & 1));
      }
    }
    if (LOAD) {
      mbar_wait(halo_full + 8 * hb, (c >> 1) & 1);
      __syncwarp();
    }
    const unsigned char* halo = smem + hb * kHaloBuf;
    if (K3C) {
      if (SHEET) {
        if (c > 0) named_barrier(1 + wg, 128);  // no warp of ours still reads the sheet
        // sheet block dx, row r = 16 i + j: halo pixel (4 wg + i, j + dx)
        for (int i = tid; i < 3 * SHEET_ROWS * TW * 8; i += 128) {
          const int q = i & 7, r = (i >> 3) % (SHEET_ROWS * TW);
          const int dx = (i >> 3) / (SHEET_ROWS * TW);
          const int hp = (wg * WG_ROWS + r / TW) * HC + r % TW + dx;
          *reinterpret_cast<uint4*>(own + dx * kSheetBlock + sw128(r, q)) =
              *reinterpret_cast<const uint4*>(halo + sw128(hp, q));
        }
        fence_proxy_async();
      }
      if (LOAD) {
        __syncwarp();
        if (lane == 0) mbar_arrive(halo_empty + 8 * hb);
      }
      if (SHEET) named_barrier(1 + wg, 128);  // the sheet is whole
      const uint32_t a0 = smem_u32(own);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int it = 3 * c + dy, s = it % S;
        if (LOAD) {
          mbar_wait(w_full + 8 * s, (it / S) & 1);
          __syncwarp();
        }
        const uint32_t b0 = smem_u32(wst + s * kWStage);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < CK / 16; ++kk)
            Wgmma<BN>::ss(acc[0],
                          sw128_desc(a0 + dx * kSheetBlock + dy * TW * 128 + kk * 32, 0, sbo),
                          sw128_desc(b0 + dx * CK * 128 + kk * 16 * 128, lbo_b, sbo));
        if (!ONE || dy == 2) wgmma_commit();
        if (!ONE && dy == 1) {
          wgmma_wait<1>();  // dy 0's products are done
          if (LOAD) release_weights(it - 1);
        }
      }
      // Drain before the next sheet build: a pipeline stage that spanned the
      // build's stores would make ptxas serialize every product.
      wgmma_wait<0>();
      if (LOAD) release_weights(3 * c + 2);
    } else {
      const uint32_t h_base = smem_u32(halo);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int it = 3 * c + dy, s = it % S;
        if (LOAD) {
          mbar_wait(w_full + 8 * s, (it / S) & 1);
          __syncwarp();
        }
        const uint32_t b0 = smem_u32(wst + s * kWStage);
        // lane l addresses row l % 16 of the warp's 16 A rows (pixel l % 16
        // of tile row WG_ROWS wg + 4 mb + wq), K half l / 16 of each 16
        const int hp = (wg * WG_ROWS + wq + dy) * HC + (lane & 15);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int g = 3 * dy + dx;
          uint32_t(&a)[MW][4][4] = frag[g & 1];
          if (g > 0) {
            wgmma_wait<1>();  // the group that last read these registers is done
            if (LOAD && dx == 1 && dy > 0) release_weights(it - 1);
          }
#pragma unroll
          for (int mb = 0; mb < MW; ++mb)
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk)
              ldmatrix_x4(a[mb][kk], h_base + sw128(hp + M64_ROWS * mb * HC + dx,
                                                    2 * kk + (lane >> 4)));
          wgmma_fence();
#pragma unroll
          for (int mb = 0; mb < MW; ++mb)
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk)
              Wgmma<BN>::rs(acc[mb], a[mb][kk],
                            sw128_desc(b0 + dx * CK * 128 + kk * 16 * 128, lbo_b, sbo));
          wgmma_commit();
        }
      }
    }
  }

  // Epilogue: bias, ReLU, one rounding, into the 128B-swizzled staging tile
  // (per m64 block and 64 channels, 64 pixel rows of 128 bytes), then TMA
  // stores.
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MW; ++mb) fence_regs(acc[mb]);
  if (K3C) named_barrier(1 + wg, 128);  // the staging tile is our sheet
  const int r0 = wq * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    float2 bb = make_float2(0.0f, 0.0f);
    if (bias != nullptr) bb = *reinterpret_cast<const float2*>(bias + co0 + col);
#pragma unroll
    for (int mb = 0; mb < MW; ++mb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        float v0 = acc[mb][4 * j + 2 * half], v1 = acc[mb][4 * j + 2 * half + 1];
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bb.x);
          v1 = __fadd_rn(v1, bb.y);
        }
        if (relu) {
          v0 = relu_nan(v0);
          v1 = relu_nan(v1);
        }
        *reinterpret_cast<uint32_t*>(own + (mb * NB + (j >> 3)) * kStoreBlock +
                                     sw128(r, j & 7) + (lane & 3) * 4) = pack_bf16(v0, v1);
      }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0) {  // the stores clip rows and columns past H, W
    for (int mb = 0; mb < MW; ++mb) {
      const int h = h0 + wg * WG_ROWS + M64_ROWS * mb;
      if (h >= H) break;  // a box wholly past the image is not stored
      for (int nb = 0; nb < NB; ++nb)
        tma_store_4d(&tmap_y, smem_u32(own + (mb * NB + nb) * kStoreBlock), co0 + nb * 64, w0,
                     h, n);
    }
    tma_store_commit_and_wait();
  }
}

// ------------------------------------------------------------ host side

// The launch plan (ops/conv3x3.py launch_plan), int64 in this order.
enum Plan {
  P_N, P_H, P_W, P_CI, P_CO, P_BN, P_GRID_X, P_GRID_Y, P_SMEM, P_TILES_W, P_TILES_H,
  P_X_DIMS = 11, P_X_STRIDES = 15, P_X_BOX = 18,  // x: (C, W, H, N)
  P_W_DIMS = 22, P_W_STRIDES = 25, P_W_BOX = 27,  // weights: (Co, Ci, 9 taps)
  P_Y_DIMS = 30, P_Y_STRIDES = 34, P_Y_BOX = 37,  // y: (Co, W, H, N)
  P_LEN = 41
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the process already loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

// A bf16 tensor map, 128B-swizzled, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, int rank, const long long* plan, int dims,
           int strides, int box) {
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], es[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)plan[dims + i];
    bx[i] = (cuuint32_t)plan[box + i];
    es[i] = 1;
  }
  for (int i = 0; i < rank - 1; ++i) st[i] = (cuuint64_t)plan[strides + i];
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, st,
                        bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The plan must be the one this instantiation was compiled for.
template <bool K3C, int BN, int MW>
bool plan_matches(const long long* p) {
  const long long N = p[P_N], H = p[P_H], W = p[P_W], Ci = p[P_CI], Co = p[P_CO];
  constexpr int TH = Tile<MW>::TH;
  const long long tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const long long x_box[4] = {CK, HC, Tile<MW>::HR, 1}, w_box[3] = {64, CK, 3};
  const long long y_box[4] = {64, TW, M64_ROWS, 1};
  bool ok = N > 0 && H > 0 && W > 0 && Ci > 0 && Ci % 8 == 0 && Co % BN == 0 && Co > 0 &&
            p[P_BN] == BN && p[P_SMEM] == smem_bytes<K3C, BN, MW>() && p[P_TILES_H] == tiles_h &&
            p[P_TILES_W] == tiles_w && p[P_GRID_X] == N * tiles_h * tiles_w &&
            p[P_GRID_X] <= 0x7fffffffLL && p[P_GRID_Y] == Co / BN;
  for (int i = 0; i < 4; ++i) ok = ok && p[P_X_BOX + i] == x_box[i] && p[P_Y_BOX + i] == y_box[i];
  for (int i = 0; i < 3; ++i) ok = ok && p[P_W_BOX + i] == w_box[i];
  return ok;
}

template <bool K3C, int BN, int STAGES, int MW>
int launch(const void* x, const void* wp, const void* bias, void* y, const long long* plan,
           int relu, void* stream) {
  if (!plan_matches<K3C, BN, MW>(plan)) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<K3C, BN, MW>();
  auto kernel = conv3x3_kernel<K3C, BN, STAGES, MW>;
  // the attribute is the current device's: one flag per instantiation and
  // device, so that a second card of a mesh sets it too
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  CUtensorMap mx, mw, my;
  int e = encode(&mx, x, 4, plan, P_X_DIMS, P_X_STRIDES, P_X_BOX);
  if (e == 0) e = encode(&mw, wp, 3, plan, P_W_DIMS, P_W_STRIDES, P_W_BOX);
  if (e == 0) e = encode(&my, y, 4, plan, P_Y_DIMS, P_Y_STRIDES, P_Y_BOX);
  if (e != 0) return e;
  const dim3 grid((unsigned int)plan[P_GRID_X], (unsigned int)plan[P_GRID_Y]);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      mx, mw, my, (const float*)bias, relu, (int)plan[P_CI], (int)plan[P_H],
      (int)plan[P_TILES_W], (int)plan[P_TILES_H]);
  return (int)cudaGetLastError();
}

template <bool K3C, int STAGES>
int launch_bn(const void* x, const void* wp, const void* bias, void* y, const long long* plan,
              int relu, void* stream) {
  if (plan[P_BN] == 128) return launch<K3C, 128, STAGES, 1>(x, wp, bias, y, plan, relu, stream);
  if (STAGES == kFull && plan[P_BN] == 64) {
    // 9tap at BN = 64: two m64 blocks per warpgroup (M = 256), which fit in
    // registers at this width and halve the weight bytes per product
    if constexpr (K3C) return launch<true, 64, kFull, 1>(x, wp, bias, y, plan, relu, stream);
    else return launch<false, 64, kFull, 2>(x, wp, bias, y, plan, relu, stream);
  }
  return (int)cudaErrorInvalidValue;  // the partial variants are built at BN = 128 only
}

}  // namespace

extern "C" {

// y (N, H, W, Co) bf16 = epilogue(conv3x3(x (N, H, W, Ci) bf16, wp (3, 3 * Ci, Co) bf16)),
// NHWC; bias (Co) float32 or null; relu 0 or 1; plan: launch_plan's P_LEN int64s.
// Each returns cudaGetLastError(), cudaErrorInvalidValue for a plan that is not
// this kernel's, or kEncodeError + the CUresult of a tensor map that failed.
#define CONV3X3_ARGS \
  const void *x, const void *wp, const void *bias, void *y, const long long *plan, int relu, \
      void *stream
#define CONV3X3_PASS x, wp, bias, y, plan, relu, stream

int conv3x3_k3c_bf16(CONV3X3_ARGS) { return launch_bn<true, kFull>(CONV3X3_PASS); }

int conv3x3_9tap_bf16(CONV3X3_ARGS) { return launch_bn<false, kFull>(CONV3X3_PASS); }

// The ablation's partial variants: timings only, their output is not a conv.
// No loads, no sheet build: products on zeroed shared memory, one group per dy:
int conv3x3_k3c_mm_only_bf16(CONV3X3_ARGS) { return launch_bn<true, 0>(CONV3X3_PASS); }
// the same as one commit group per chunk:
int conv3x3_k3c_mm1_only_bf16(CONV3X3_ARGS) { return launch_bn<true, kOne>(CONV3X3_PASS); }
// TMA loads + products on the zeroed sheet (no sheet build):
int conv3x3_k3c_dma_mm_bf16(CONV3X3_ARGS) { return launch_bn<true, kLoad>(CONV3X3_PASS); }
// sheet build from the zeroed halo tile + products (no loads):
int conv3x3_k3c_sheet_mm_bf16(CONV3X3_ARGS) { return launch_bn<true, kSheet>(CONV3X3_PASS); }

}  // extern "C"
