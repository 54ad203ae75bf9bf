// The ceiling probe's pointwise-shape matrix product, hand-written for Hopper
// (sm_90a):
//
//   int8: out = int8(wrap)((x . w) >> 7), s8 x s8 -> s32 (arithmetic shift)
//   bf16: out = bf16(round to nearest even)(x . w), f32 accumulation
//
// x (M, K) and w (K, N) row-major, out (M, N) row-major, any M, K, N. Replaces
// the Pallas kernel `kern` of tools/ceiling_probe.py (pallas_dot), which the
// probe runs at M = 8192, K = N = C for C in {728, 768}.
//
// Bound on an H100 at (8192, 728): 8.68 G operations, 4.39 us at the int8
// tensor-core peak (bytes: 12.45 MB, 3.72 us at 3.35 TB/s) and 8.78 us at the
// bf16 peak (bytes 7.43 us): bound by operations in both types, and a launch
// costs about as much as the work.
//
// Design (the wgmma route, every shape but int8 with K > 768):
//  * Tiles of 128 x 192 of out. 192 because N = 728 = 3 * 192 + 152 and
//    768 = 4 * 192: four column stripes at either width (the int8 wgmma takes
//    N in steps of 16 past 32, so 184 is not a choice), 8 % of the products
//    wasted at 728. 128 x 128 tiles gave 6 x 64 = 384 tiles, 1.45 waves of
//    2 blocks on 132 SMs; here 4 x 64 = 256 tiles.
//  * A persistent grid: the blocks of a column stripe are `per` =
//    min(row tiles, SMs / stripes) = 33 at the probe's shapes, so 132 blocks,
//    one an SM, and block j of a stripe walks row tiles j, j + per, ...: 31
//    blocks take two tiles and two take one, the 1.94 waves of 256 tiles
//    without a second launch wave, and a block's next tile's loads overlap
//    its epilogue.
//  * Three warpgroups: two consumers, 64 rows of the tile each, the whole
//    192 columns as one wgmma m64n192 (k16 bf16 -> f32, k32 s8 -> s32) with
//    96 accumulator registers a thread; one producer that keeps a ring of
//    4 K stages in shared memory full, 128 bytes of K a stage (64 bf16 or
//    128 int8: one 128-byte swizzle row), through a full and an empty
//    mbarrier a stage. The consumers keep one wgmma group in flight and release a
//    stage when the group after it has been issued.
//  * Producers: TMA (one thread, 2-D boxes, 128-byte swizzle, zeros past
//    every edge) where every global row is a multiple of 16 bytes and the
//    bases are 16-byte aligned; else cp.async from the whole producer
//    warpgroup (16, 8 or 4 bytes a copy, whichever divides the row and the
//    base, zeros by a source size of 0) into the same swizzled layout,
//    completing on the same mbarrier by cp.async.mbarrier.arrive.noinc;
//    rows of an odd byte count go byte by byte. probe_dot_plan says which
//    (ops/probe_dot.py::plan mirrors it). The cp.async route's consumers
//    fence the async proxy before a stage's wgmma.
//  * A (x) is K-major, as wgmma wants it. bf16 w (K, N) is N-major and goes
//    in as it is: [64 k][64 n] boxes, the descriptor's transpose bit set
//    (LBO = 8 KB between 64-column boxes, SBO = 1 KB between 8-row groups).
//    int8 wgmma takes K-major operands only, so int8 w is transposed once a
//    block: the consumers read the block's 192-column stripe of w (at most
//    768 deep: 144 KB) with 4-byte loads, 48 in flight a thread, turn 4 x 4
//    byte blocks with byte permutes, and keep it resident, 128-byte
//    swizzled, for every row tile they walk; only x streams (4 stages of
//    16 KB). The 33 blocks of a stripe start at different 128-deep atoms of
//    it, so that they do not all ask for the same lines at once.
//  * Epilogue: the accumulator fragment (row 16 w + g (+8), columns 8 j +
//    2 q (+1)) becomes an arithmetic >> 7 and the low byte (the cast wraps,
//    no saturation), or one round-to-nearest-even cast, into a warp's own
//    staging in shared memory (16 rows x 96 columns; bf16 has one for each
//    half of the tile's columns, int8 room for one). Where out's rows are
//    16-byte multiples on an aligned base, one lane sends it as a TMA box
//    store left in flight (the box is clipped at out's edges); else the
//    warp writes it by whole rows, 8, 4, 2 or 1 bytes a store (whichever
//    divides out's rows and base), masked at the ragged M and N edges.
//    (Stores straight from the fragment, 2 or 4 bytes a lane, would
//    scatter over 8 rows a warp instruction.)
//
// What holds it back (chip_smoke.py --probe-dot): any launch reads ~5 us
// between CUDA events; bf16 stages of 40 KB arrive barely faster than the
// products use them (the loads alone, without products or stores, take
// ~75 % of the run at C = 768, ~85 % at 728, whose 1456-byte rows put each
// 128-byte box row across two lines); int8 spends ~8 us reading its
// stripe. A trial with clusters of two CTAs sharing each stage's w boxes by
// TMA multicast was slower, not kept: it halves the L2 reads of w, not the
// bytes each SM takes in.
//
// Probe builds (-D, see chip_smoke.py --probe-dot): PROBE_DOT_TRACE records
// globaltimer stamps of each block's phases (probe_dot_trace reads them);
// PROBE_DOT_NO_MMA, _NO_EPILOGUE, _NO_STRIPE leave a phase out (wrong
// results, times only); PROBE_DOT_EMPTY returns at once.
//
// The mma.sync route (the first version of this kernel, its int8 half)
// takes int8 with K > 768, whose stripe would not fit beside the ring: a
// 128 x 128 tile a block of 8 warps, three cp.async stages of 64 bytes of
// K, w's int8 tile transposed in shared memory each stage, mma.sync
// m16n8k32.
//
// C interface: probe_dot_launch returns cudaGetLastError() after the launch,
// -1 for a shape it does not take; probe_dot_plan fills the host's choice.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // WgmmaS8: the s8 wgmma, shared with sepconv.cu

namespace {

// --------------------------------------------- mma.sync route (int8, K > 768)
namespace mma_sync_route {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;          // output tile of a block
constexpr int kBKB = 64;                     // bytes of K a stage
constexpr int kStages = 3;
constexpr int kALd = kBKB + 16;              // A [m][k] row, bytes
constexpr int kRawLd = kBN + 16;             // int8 B as staged, [k][n] row, bytes
constexpr int kBLdS8 = kBKB + 16;            // int8 B transposed, [n][k] row, bytes
constexpr int kABytes = kBM * kALd;

constexpr int kStage = kABytes + kBKB * kRawLd;
constexpr int kSmem = kStages * kStage + kBN * kBLdS8;

struct Args {
  const char* x;  // (m, k)
  const char* w;  // (k, n)
  char* out;      // (m, n)
  int m, n, k;
  int vec_a;      // bytes a copy of x's rows: 16, 8, 4, or 1
  int vec_b;      // bytes a copy of w's rows: 16, 8, 4, or 1
};

template <int V>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? V : 0;
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(V), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most the N newest groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int V>
__device__ __forceinline__ void copy_rows_v(char* smem, int s_ld, const char* g, size_t g_ld,
                                            int r0, int r_end, int c0, int c_end, int rows,
                                            int row_bytes) {
  const int per_row = row_bytes / V;
  for (int u = threadIdx.x; u < rows * per_row; u += kThreads) {
    const int r = u / per_row, cb = (u % per_row) * V;
    const bool valid = r0 + r < r_end && c0 + cb < c_end;
    cp_async<V>(smem + r * s_ld + cb, valid ? g + size_t(r0 + r) * g_ld + c0 + cb : g, valid);
  }
}

// rows x row_bytes of a row-major global array (row stride g_ld bytes) from
// row r0 and byte c0 into shared memory (row stride s_ld); rows >= r_end and
// bytes >= c_end read as zero. A vec copy never straddles c_end: the host
// picks vec dividing g_ld (= c_end) and the base address.
__device__ __forceinline__ void copy_rows(char* smem, int s_ld, const char* g, size_t g_ld,
                                          int r0, int r_end, int c0, int c_end, int rows,
                                          int row_bytes, int vec) {
  switch (vec) {
    case 16: copy_rows_v<16>(smem, s_ld, g, g_ld, r0, r_end, c0, c_end, rows, row_bytes); break;
    case 8: copy_rows_v<8>(smem, s_ld, g, g_ld, r0, r_end, c0, c_end, rows, row_bytes); break;
    case 4: copy_rows_v<4>(smem, s_ld, g, g_ld, r0, r_end, c0, c_end, rows, row_bytes); break;
    default:
      for (int u = threadIdx.x; u < rows * row_bytes; u += kThreads) {
        const int r = u / row_bytes, cb = u % row_bytes;
        smem[r * s_ld + cb] = r0 + r < r_end && c0 + cb < c_end
                                  ? g[size_t(r0 + r) * g_ld + c0 + cb] : char(0);
      }
  }
}

// int8 B: the staged [k][n] tile (kBKB rows of kBN bytes) transposed into
// the [n][k] tile, a 4 x 4 byte block at a time: four row words in, byte
// permutes, four column words out. A warp takes 16 blocks down K and two
// across N: its stores hit 32 banks, its loads 4 (8-way conflicts, cheaper
// than the 16-way stores of the other order).
__device__ __forceinline__ void transpose_b_s8(char* bt, const char* raw) {
  for (int u = threadIdx.x; u < (kBKB / 4) * (kBN / 4); u += kThreads) {
    const int kb = u % (kBKB / 4), nb = u / (kBKB / 4);
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(raw + (4 * kb + i) * kRawLd + 4 * nb);
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(bt + (4 * nb + j) * kBLdS8 + 4 * kb) = col[j];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two output values of one row, columns col and col + 1 (col even).
__device__ __forceinline__ void store_pair(const Args& a, int row, int col, int v0, int v1) {
  if (row >= a.m || col >= a.n) return;
  uint8_t* o = reinterpret_cast<uint8_t*>(a.out) + size_t(row) * a.n + col;
  // arithmetic shift, then the low byte: the cast wraps
  const uint8_t b0 = static_cast<uint8_t>(v0 >> 7), b1 = static_cast<uint8_t>(v1 >> 7);
  if (col + 1 < a.n && a.n % 2 == 0) {
    *reinterpret_cast<uint16_t*>(o) = uint16_t(b0) | uint16_t(b1) << 8;
  } else {
    o[0] = b0;
    if (col + 1 < a.n) o[1] = b1;
  }
}
__global__ void __launch_bounds__(kThreads, 2) probe_dot_mma_sync(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile: rows 64 wm.., columns 32 wn..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_bytes = a.k;
  const int tiles = (k_bytes + kBKB - 1) / kBKB;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0;

  auto load_tile = [&](int t) {  // cp.async of K tile t into its stage
    char* st = smem + (t % kStages) * kStage;
    copy_rows(st, kALd, a.x, size_t(k_bytes), m0, a.m, t * kBKB, k_bytes, kBM, kBKB, a.vec_a);
    copy_rows(st + kABytes, kRawLd, a.w, size_t(a.n), t * kBKB, a.k, n0, a.n, kBKB, kBN,
              a.vec_b);
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();  // one group a tile, empty past the end: the waits stay uniform
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + kStages - 1 < tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const char* as = smem + (t % kStages) * kStage;
    char* bs = smem + kStages * kStage;
    transpose_b_s8(bs, as + kABytes);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBKB / 32; ++ks) {  // 32 bytes of K: one mma deep
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // two n-tiles of 8 an ldmatrix
        uint32_t r[4];
        ldmatrix_x4(r, bs + (32 * wn + 16 * p + (lane & 7) + 8 * (lane >> 4)) * kBLdS8 +
                           32 * ks + 16 * ((lane >> 3) & 1));
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af, as + (64 * wm + 16 * mi + (lane & 15)) * kALd + 32 * ks +
                            16 * (lane >> 4));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma(acc[mi][nj], af, bf[nj]);
      }
    }
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int row = m0 + 64 * wm + 16 * mi + g, col = n0 + 32 * wn + 8 * nj + 2 * tq;
      store_pair(a, row, col, acc[mi][nj][0], acc[mi][nj][1]);
      store_pair(a, row + 8, col, acc[mi][nj][2], acc[mi][nj][3]);
    }
}

int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(probe_dot_mma_sync,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_dot_mma_sync<<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma_sync_route

// ------------------------------------------------------------ wgmma route
namespace wgmma_route {

constexpr int kBM = 128, kBN = 192;           // output tile of a block
constexpr int kConsumers = 256;               // two warpgroups, 64 rows each
constexpr int kProducers = 128;               // the third warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRowBytes = 128;                // K bytes a stage: one swizzle row
constexpr int kABytes = kBM * kRowBytes;      // 16 KB
constexpr int kBoxBytes = 64 * kRowBytes;     // bf16 w: [64 k][64 n], 8 KB
constexpr int kAtomBytes = kBN * kRowBytes;   // int8 stripe: 128 of K, 24 KB
constexpr int kMaxAtoms = 6;                  // int8 stripe at most 768 deep
constexpr int kAcc = kBN / 2;                 // accumulators a thread
constexpr int kEpiCols = 96;                  // columns a warp stages at a time

template <bool S8> struct Ring {
  static constexpr int kStages = 4;
  // bf16: two staging halves a warp, so the first half's box store need
  // not be read out before the second is written (int8's stripe leaves
  // room for one)
  static constexpr int kEpiBufs = S8 ? 1 : 2;
  static constexpr int kBBytes = S8 ? 0 : 3 * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // a consumer warp's staging of its 16 rows x 96 columns of out, kEpiBufs times
  static constexpr int kEpiBytes = kEpiBufs * 16 * kEpiCols * (S8 ? 1 : 2);
};

// Dynamic shared memory a launch asks for: 1 KB of slack to align the ring
// to the swizzle's 1 KB, the ring, the int8 stripe, the epilogue's staging,
// the mbarriers.
template <bool S8> int smem_bytes(int atoms) {
  return 1024 + Ring<S8>::kStages * Ring<S8>::kStageBytes + (S8 ? atoms * kAtomBytes : 0) +
         (kConsumers / 32) * Ring<S8>::kEpiBytes + 2 * Ring<S8>::kStages * 8;
}

struct Args {
  const char* x;  // (m, k)
  const char* w;  // (k, n)
  char* out;      // (m, n)
  int m, n, k;
  int k_steps;    // stages a tile: ceil(k bytes / 128)
  int m_tiles;    // row tiles
  int per;        // blocks a column stripe
  int tma;        // 1: TMA producer, 0: cp.async
  int vec_a;      // bytes a copy of x's rows (cp.async): 16, 8, 4, or 1
  int vec_b;      // the same for bf16 w's rows
  int w_load;     // int8 stripe: bytes a load of w's rows (8, 4, or 1)
  int vec_out;    // bytes a store of out's rows: 16, 8, 4, 2 or 1
  int tma_out;    // 1: out's rows take TMA stores (16-byte multiples, aligned)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}
// Until the phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Arrives on bar once every cp.async of this thread issued before it landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Generic-proxy writes to shared memory, visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// A box of shared memory to global (rows and columns past out's edges are
// not written), tracked by the thread's bulk groups.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the thread's bulk stores have read their shared memory (.read) or
// are done.
template <bool kRead> __device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? V : 0;
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(V), "r"(bytes)
                 : "memory");
  }
}

// Byte b of the 128-byte row r of a tile in the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, the descriptors' layout 1): 16-byte chunk c
// of the row lands at chunk c ^ (r % 8). The tile starts 1 KB aligned.
__device__ __forceinline__ int swz(int r, int b) {
  return r * kRowBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// rows x 128 bytes of a row-major global array (row stride g_ld bytes), from
// row r0 and byte c0, into a swizzled tile; rows >= r_end and bytes >= c_end
// read as zero. V divides g_ld (= c_end) and the base, so no copy straddles
// c_end. Issued by the producer warpgroup's thread p.
template <int V>
__device__ __forceinline__ void copy_tile_v(char* tile, const char* g, size_t g_ld, int r0,
                                            int r_end, int c0, int c_end, int rows, int p) {
  constexpr int kPerRow = kRowBytes / V;
  const uint32_t base = smem_u32(tile);
  for (int u = p; u < rows * kPerRow; u += kProducers) {
    const int r = u / kPerRow, b = (u % kPerRow) * V;
    const bool valid = r0 + r < r_end && c0 + b < c_end;
    cp_async<V>(base + swz(r, b), valid ? g + size_t(r0 + r) * g_ld + c0 + b : g, valid);
  }
}
__device__ __forceinline__ void copy_tile(char* tile, const char* g, size_t g_ld, int r0,
                                          int r_end, int c0, int c_end, int rows, int vec,
                                          int p) {
  switch (vec) {
    case 16: copy_tile_v<16>(tile, g, g_ld, r0, r_end, c0, c_end, rows, p); break;
    case 8: copy_tile_v<8>(tile, g, g_ld, r0, r_end, c0, c_end, rows, p); break;
    case 4: copy_tile_v<4>(tile, g, g_ld, r0, r_end, c0, c_end, rows, p); break;
    default: {  // byte by byte, 8 loads in flight a thread
      constexpr int kB = 8;
      const int total = rows * kRowBytes;
      for (int u0 = p; u0 < total; u0 += kB * kProducers) {
        char v[kB];
#pragma unroll
        for (int i = 0; i < kB; ++i) {
          const int u = u0 + i * kProducers, r = u / kRowBytes, b = u % kRowBytes;
          v[i] = u < total && r0 + r < r_end && c0 + b < c_end
                     ? g[size_t(r0 + r) * g_ld + c0 + b] : char(0);
        }
#pragma unroll
        for (int i = 0; i < kB; ++i) {
          const int u = u0 + i * kProducers;
          if (u < total) tile[swz(u / kRowBytes, u % kRowBytes)] = v[i];
        }
      }
    }
  }
}

// wgmma descriptor of a swizzled (128-byte) operand: start address, leading
// and stride byte offsets, all in 16-byte units; layout type 1 (128B).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators across the asynchronous products.
template <typename T> __device__ __forceinline__ void fence_acc(T (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      asm volatile("" : "+f"(d[i])::"memory");
    } else {
      asm volatile("" : "+r"(d[i])::"memory");
    }
  }
}

// d += A . B: A 64 x 16 bf16 K-major, B 16 x 192 bf16 N-major (transposed),
// f32 accumulators.
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}
// int8: the block's stripe of w, columns n0 .. n0 + 191 and K rounded up to
// 128, transposed into [atom][n][128 of k], swizzled, zero past N and K.
// Each thread reads 16 rows of W bytes (8 or 4 where w's rows and base
// allow, else 4 gathered byte by byte) and writes W columns of 16 bytes,
// turned by byte permutes. A warp takes 8 groups of 16 k down and 4 groups
// of W columns across: its loads read 4 W contiguous bytes of 8 rows, and
// each quarter warp stores 8 different chunks of one row (no bank
// conflicts). The blocks of a stripe start at different atoms (rot), so
// that they do not all ask for the same lines at once.
__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                         int j) {
  const uint32_t sel = j | (j + 4) << 4;  // byte j of the first, byte j of the second
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}
template <int W>
__device__ __forceinline__ void load_stripe_s8(char* stripe, const Args& a, int n0, int atoms,
                                               int ct, int rot) {
  constexpr int kCols = W == 8 ? 8 : 4;        // columns a thread turns
  constexpr int kWords = kCols / 4;            // 4-byte words of them a row
  constexpr int kAcross = kBN / (4 * kCols);   // warp units across the stripe
  constexpr int kBatch = W == 8 ? 2 : 3;       // units a thread has in flight
  const int warp = ct / 32, lane = ct % 32;
  const int kk = lane % 8, nn = lane / 8;
  const int units = atoms * kAcross;
  const uint8_t* w = reinterpret_cast<const uint8_t*>(a.w);
  for (int wu0 = warp; wu0 < units; wu0 += kBatch * (kConsumers / 32)) {
    uint32_t r[kBatch][16][kWords];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int wu = wu0 + b * (kConsumers / 32);
      const int atom = (wu / kAcross + rot) % atoms, ng = (wu % kAcross) * 4 + nn;
      const int k0 = (atom * 8 + kk) * 16, col = n0 + ng * kCols;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int kr = k0 + i;
        uint32_t v[kWords] = {};
        if (wu < units && kr < a.k) {
          const uint8_t* row = w + size_t(kr) * a.n;
          if constexpr (W == 8) {
            if (col < a.n) {
              const uint2 t = *reinterpret_cast<const uint2*>(row + col);
              v[0] = t.x;
              v[kWords - 1] = t.y;
            }
          } else if constexpr (W == 4) {
            if (col < a.n) v[0] = *reinterpret_cast<const uint32_t*>(row + col);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < a.n) v[0] |= uint32_t(row[col + j]) << (8 * j);
          }
        }
#pragma unroll
        for (int q = 0; q < kWords; ++q) r[b][i][q] = v[q];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int wu = wu0 + b * (kConsumers / 32);
      if (wu >= units) break;
      const int atom = (wu / kAcross + rot) % atoms, ng = (wu % kAcross) * 4 + nn;
      char* dst = stripe + atom * kAtomBytes;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int q = j / 4, c = j % 4;
        const auto& x = r[b];
        const uint4 v = make_uint4(pick(x[0][q], x[1][q], x[2][q], x[3][q], c),
                                   pick(x[4][q], x[5][q], x[6][q], x[7][q], c),
                                   pick(x[8][q], x[9][q], x[10][q], x[11][q], c),
                                   pick(x[12][q], x[13][q], x[14][q], x[15][q], c));
        *reinterpret_cast<uint4*>(dst + swz(ng * kCols + j, kk * 16)) = v;
      }
    }
  }
}

// Two output values as out's type: the arithmetic shift, then the low byte
// (the cast wraps), or one round-to-nearest-even cast.
__device__ __forceinline__ uint16_t to_out(int v0, int v1) {
  return uint16_t(uint8_t(v0 >> 7)) | uint16_t(uint8_t(v1 >> 7)) << 8;
}
__device__ __forceinline__ __nv_bfloat162 to_out(float v0, float v1) {
  return __floats2bfloat162_rn(v0, v1);
}

template <int V> struct Vec { using T = uint8_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

// A warp's 16 staged rows of `bytes` bytes (row stride the same) to out at
// row row0 and byte col0, V bytes a store, lanes along the rows; masked at
// out's edges. V divides the staged row's bytes, col0 and out's row bytes.
template <int V>
__device__ __forceinline__ void store_rows_v(const Args& a, const char* stage, int bytes,
                                             int row0, int col0, int row_bytes, int lane) {
  using T = typename Vec<V>::T;
  const int chunks = bytes / V;
  for (int u = lane; u < 16 * chunks; u += 32) {
    const int r = u / chunks, b = (u % chunks) * V;
    if (row0 + r < a.m && col0 + b < row_bytes)
      *reinterpret_cast<T*>(a.out + size_t(row0 + r) * row_bytes + col0 + b) =
          *reinterpret_cast<const T*>(stage + r * bytes + b);
  }
}

#ifdef PROBE_DOT_TRACE
// globaltimer (ns) at points of each block's run, thread 0 (a trace build).
__device__ unsigned long long g_trace[1024][10];
#define TRACE(e)                                                                   \
  do {                                                                             \
    if (threadIdx.x == 0 && blockIdx.x < 1024) {                                   \
      unsigned long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                       \
      g_trace[blockIdx.x][e] = t_;                                                 \
    }                                                                              \
  } while (0)
#else
#define TRACE(e)
#endif

template <bool S8>
__global__ void __launch_bounds__(kThreads, 1)
    probe_dot_wgmma(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_out, Args a) {
  using Acc = typename std::conditional<S8, int, float>::type;
  using R = Ring<S8>;
  constexpr int S = R::kStages;
  extern __shared__ char smem_raw[];
  char* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  char* stripe = ring + S * R::kStageBytes;  // int8 only
  const int atoms = S8 ? (a.k + 127) / 128 : 0;
  char* epi_all = stripe + atoms * kAtomBytes;  // the consumer warps' staging
  uint64_t* full = reinterpret_cast<uint64_t*>(epi_all + (kConsumers / 32) * R::kEpiBytes);
  uint64_t* empty = full + S;
  const int stripe_id = blockIdx.x / a.per, first = blockIdx.x % a.per;
  const int n0 = stripe_id * kBN;
  const int tiles = (a.m_tiles - first + a.per - 1) / a.per;
#ifdef PROBE_DOT_EMPTY
  if (tiles >= 0) return;
#endif

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], a.tma ? 1 : kProducers);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  TRACE(0);
  __syncthreads();
  TRACE(1);

  if (threadIdx.x >= kConsumers) {  // ------------------------------ producer
    const int p = threadIdx.x - kConsumers;
    const int es = S8 ? 1 : 2;
    const bool bytewise = a.vec_a == 1 || (!S8 && a.vec_b == 1);
    int it = 0;
    for (int i = 0; i < tiles && (!a.tma || p == 0); ++i) {
      const int m0 = (first + i * a.per) * kBM;
      for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        char* st = ring + s * R::kStageBytes;
        if (a.tma) {
          mbar_expect_tx(&full[s], R::kStageBytes);
          tma_load(st, &map_x, ks * (kRowBytes / es), m0, &full[s]);
          if constexpr (!S8) {
#pragma unroll
            for (int j = 0; j < 3; ++j)
              tma_load(st + kABytes + j * kBoxBytes, &map_w, n0 + 64 * j, ks * 64, &full[s]);
          }
        } else {
          copy_tile(st, a.x, size_t(a.k) * es, m0, a.m, ks * kRowBytes, a.k * es, kBM, a.vec_a,
                    p);
          if constexpr (!S8) {
            for (int j = 0; j < 3; ++j)
              copy_tile(st + kABytes + j * kBoxBytes, a.w, size_t(a.n) * 2, ks * 64, a.k,
                        (n0 + 64 * j) * 2, a.n * 2, 64, a.vec_b, p);
          }
          if (bytewise) {  // plain stores: land them, then a plain arrival
            cp_async_wait_all();
            fence_proxy_async();
            mbar_arrive(&full[s]);
          } else {
            cp_async_arrive_noinc(&full[s]);
          }
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ---------------------------------------------------------- consumers
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    char* epi = epi_all + (threadIdx.x / 32) * R::kEpiBytes;
    if constexpr (S8) {
#ifndef PROBE_DOT_NO_STRIPE
      const int rot = first % atoms;
      if (a.w_load == 8) {
        load_stripe_s8<8>(stripe, a, n0, atoms, threadIdx.x, rot);
      } else if (a.w_load == 4) {
        load_stripe_s8<4>(stripe, a, n0, atoms, threadIdx.x, rot);
      } else {
        load_stripe_s8<1>(stripe, a, n0, atoms, threadIdx.x, rot);
      }
#endif
      fence_proxy_async();
      consumer_sync();
      TRACE(2);
    }
    int it = 0;
    for (int i = 0; i < tiles; ++i) {
      const int t = first + i * a.per;
      Acc d[kAcc];
#pragma unroll
      for (int r = 0; r < kAcc; ++r) d[r] = Acc(0);
      fence_acc(d);
      for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        if (ks == 0) TRACE(3 + 3 * (i & 1));
        if (!a.tma) fence_proxy_async();
        const char* as = ring + s * R::kStageBytes + wg * (64 * kRowBytes);
        wgmma_fence();
#ifndef PROBE_DOT_NO_MMA
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of K a product
          const uint64_t da = desc(as + 32 * kk, 16, 1024);
          if constexpr (S8) {
            WgmmaS8<kBN>::ss(d, da, desc(stripe + ks * kAtomBytes + 32 * kk, 16, 1024), 1);
          } else {
            // N-major: 64-column boxes 8 KB apart (LBO), 8-deep k groups 1 KB (SBO)
            wgmma_bf16(d, da, desc(ring + s * R::kStageBytes + kABytes + 2048 * kk, kBoxBytes,
                                   1024));
          }
        }
#endif
        wgmma_commit();
        if (ks > 0) {  // the group before this one is done with its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      TRACE(4 + 3 * (i & 1));
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

#ifdef PROBE_DOT_NO_EPILOGUE
      if (t >= 0) continue;
#endif
      // Through the warp's staging, 96 columns at a time, then out by whole
      // staged rows, vec_out bytes a store.
      const int g = lane / 4, q = lane % 4, es = S8 ? 1 : 2;
      const int row0 = t * kBM + wg * 64 + warp * 16, rb = kEpiCols * es;
#pragma unroll
      for (int h = 0; h < kBN / kEpiCols; ++h) {
        char* st = epi + (h % R::kEpiBufs) * 16 * rb;
        // the staging is free once the box stores before have read it
        if (a.tma_out && (h == 0 || R::kEpiBufs == 1)) {
          if (lane == 0) tma_store_wait<true>();
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < kEpiCols / 8; ++j) {
          const int jj = h * (kEpiCols / 8) + j, b = (8 * j + 2 * q) * es;
          using P = decltype(to_out(d[0], d[1]));
          *reinterpret_cast<P*>(st + g * rb + b) = to_out(d[4 * jj], d[4 * jj + 1]);
          *reinterpret_cast<P*>(st + (g + 8) * rb + b) = to_out(d[4 * jj + 2], d[4 * jj + 3]);
        }
        if (a.tma_out) {  // one box store, left in flight
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) tma_store(&map_out, st, n0 + h * kEpiCols, row0);
          continue;
        }
        __syncwarp();
        const int col0 = (n0 + h * kEpiCols) * es, row_bytes = a.n * es;
        switch (a.vec_out) {
          case 16: store_rows_v<16>(a, st, rb, row0, col0, row_bytes, lane); break;
          case 8: store_rows_v<8>(a, st, rb, row0, col0, row_bytes, lane); break;
          case 4: store_rows_v<4>(a, st, rb, row0, col0, row_bytes, lane); break;
          case 2: store_rows_v<2>(a, st, rb, row0, col0, row_bytes, lane); break;
          default: store_rows_v<1>(a, st, rb, row0, col0, row_bytes, lane);
        }
        __syncwarp();
      }
      TRACE(5 + 3 * (i & 1));
    }
    if (a.tma_out && lane == 0) tma_store_wait<false>();
  }
  TRACE(9);
}

// The widest copy (16, 8 or 4 bytes) dividing both a row's bytes and the
// base address, else 1.
int copy_width(const void* p, long long row_bytes) {
  const unsigned long long addr = reinterpret_cast<unsigned long long>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && addr % v == 0) return v;
  return 1;
}

struct Plan {
  int route;   // 1: wgmma, 0: mma.sync
  int tma;     // wgmma route: 1 TMA producer, 0 cp.async
  int n_tiles, m_tiles, per, grid;
  int vec_a, vec_b;
};

// The host's choice, from the shapes and the pointers alone.
Plan plan(const void* x, const void* w, int m, int n, int k, int s8, int sms) {
  Plan p{};
  const int es = s8 ? 1 : 2;
  p.route = !s8 || (k + 127) / 128 <= kMaxAtoms;
  p.vec_a = copy_width(x, (long long)k * es);
  p.vec_b = copy_width(w, (long long)n * es);
  p.tma = p.route && p.vec_a == 16 && (s8 || p.vec_b == 16);
  if (p.route) {
    p.n_tiles = (n + kBN - 1) / kBN;
    p.m_tiles = (m + kBM - 1) / kBM;
    // blocks a stripe: at most one an SM, no more than the row tiles
    const int per = sms / p.n_tiles;
    p.per = per < 1 ? 1 : (per > p.m_tiles ? p.m_tiles : per);
  } else {
    p.n_tiles = (n + 127) / 128;
    p.m_tiles = (m + 127) / 128;
    p.per = 1;
  }
  p.grid = p.route ? p.n_tiles * p.per : p.n_tiles * p.m_tiles;
  return p;
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A 2-D map of a row-major (rows, cols) array, boxes of box_cols x box_rows,
// 128-byte swizzle, zeros outside.
bool encode(CUtensorMap* map, const void* p, CUtensorMapDataType type, int es, int rows,
            int cols, int box_cols, int box_rows,
            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  auto fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(cols) * es};
  cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool S8>
int launch(const Plan& p, const void* x, const void* w, void* out, int m, int n, int k,
           cudaStream_t stream) {
  const int es = S8 ? 1 : 2;
  Args a{static_cast<const char*>(x), static_cast<const char*>(w), static_cast<char*>(out),
         m, n, k, (k * es + kRowBytes - 1) / kRowBytes, p.m_tiles, p.per, p.tma, p.vec_a,
         p.vec_b, 0};
  CUtensorMap map_x{}, map_w{}, map_out{};
  const uintptr_t w_addr = reinterpret_cast<uintptr_t>(w);
  a.w_load = n % 8 == 0 && w_addr % 8 == 0 ? 8 : n % 4 == 0 && w_addr % 4 == 0 ? 4 : 1;
  a.vec_out = copy_width(out, (long long)n * es);  // 16, 8, 4 or 1
  a.tma_out = a.vec_out == 16;
  if (a.tma_out) {
    const auto type = S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode(&map_out, out, type, es, m, n, kEpiCols, 16, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -2;
  }
  if (a.vec_out == 1) a.vec_out = n * es % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 2 == 0
                                      ? 2 : 1;
  if (p.tma) {
    const auto type = S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode(&map_x, x, type, es, m, k, kRowBytes / es, kBM)) return -2;
    if (!S8 && !encode(&map_w, w, type, es, k, n, 64, 64)) return -2;
  }
  const int smem = smem_bytes<S8>(S8 ? (k + 127) / 128 : 0);
  cudaError_t err = cudaFuncSetAttribute(probe_dot_wgmma<S8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_dot_wgmma<S8><<<p.grid, kThreads, smem, stream>>>(map_x, map_w, map_out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_route

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

extern "C" {
#ifdef PROBE_DOT_TRACE
int probe_dot_trace(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, wgmma_route::g_trace, sizeof(wgmma_route::g_trace)));
}
#endif

// The host's choice for these operands: out[0] route (1 wgmma, 0 mma.sync),
// [1] producer (1 TMA, 0 cp.async), [2] column tiles, [3] row tiles,
// [4] blocks a column stripe, [5] grid, [6] and [7] the cp.async widths of
// x's and w's rows. sms <= 0: the current device's SM count.
int probe_dot_plan(const void* x, const void* w, int m, int n, int k, int s8, int sms,
                   int* out) {
  if (m <= 0 || n <= 0 || k <= 0) return -1;
  const wgmma_route::Plan p = wgmma_route::plan(x, w, m, n, k, s8, sms > 0 ? sms : sm_count());
  const int v[8] = {p.route, p.tma, p.n_tiles, p.m_tiles, p.per, p.grid, p.vec_a, p.vec_b};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// x (m, k), w (k, n), out (m, n), row-major; s8 != 0: int8, else bf16.
int probe_dot_launch(const void* x, const void* w, void* out, int m, int n, int k, int s8,
                     void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return -1;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaGetLastError());
  const wgmma_route::Plan p = wgmma_route::plan(x, w, m, n, k, s8, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.route) {
    return s8 ? wgmma_route::launch<true>(p, x, w, out, m, n, k, st)
              : wgmma_route::launch<false>(p, x, w, out, m, n, k, st);
  }
  if ((m + mma_sync_route::kBM - 1) / mma_sync_route::kBM > 65535) return -1;
  mma_sync_route::Args a{static_cast<const char*>(x), static_cast<const char*>(w),
                         static_cast<char*>(out), m, n, k, p.vec_a, p.vec_b};
  const dim3 grid((n + mma_sync_route::kBN - 1) / mma_sync_route::kBN,
                  (m + mma_sync_route::kBM - 1) / mma_sync_route::kBM);
  return mma_sync_route::launch(a, grid, st);
}

}  // extern "C"
