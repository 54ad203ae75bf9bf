// The ceiling probe's pointwise-shape matrix product, one hand-written Hopper
// kernel (sm_90a):
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
// Design, simple first (no wgmma, no TMA, no producer warp): a 256-thread
// block owns a 128 x 128 tile of out, 8 warps of 64 x 32; the K loop walks
// 64 bytes of K a stage (32 bf16 or 64 int8) through three stages in shared
// memory, each filled by cp.async two stages ahead (16, 8 or 4 bytes a copy,
// whichever divides the row; bytes one by one otherwise), zero past M, N and
// K. The B operand of mma.sync wants K contiguous per output column, w has N
// contiguous:
//  * bf16: w's [k][n] tile is staged as it is and ldmatrix.trans gives the
//    col-major fragment;
//  * int8: ldmatrix.trans moves 16-bit elements only, so the staged [k][n]
//    tile is transposed in shared memory (4 x 4 byte blocks, byte permutes)
//    into one [n][k] tile before the products, and plain ldmatrix gives the
//    fragment. w is never packed on the host: in the probe's chain it
//    changes every iteration.
// Products by mma.sync m16n8k16 bf16 -> f32 and m16n8k32 s8 -> s32. The int8
// cast wraps, as the Pallas kernel's astype does (no saturation), after an
// arithmetic shift; bf16 is rounded once from the f32 sum.
//
// C interface: probe_dot_launch returns cudaGetLastError() after the launch,
// -1 for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;          // output tile of a block
constexpr int kBKB = 64;                     // bytes of K a stage
constexpr int kStages = 3;
constexpr int kALd = kBKB + 16;              // A [m][k] row, bytes
constexpr int kBLdBf = kBN * 2 + 16;         // bf16 B [k][n] row, bytes
constexpr int kRawLd = kBN + 16;             // int8 B as staged, [k][n] row, bytes
constexpr int kBLdS8 = kBKB + 16;            // int8 B transposed, [n][k] row, bytes
constexpr int kABytes = kBM * kALd;

template <bool S8> struct Layout {
  static constexpr int kStage = kABytes + (S8 ? kBKB * kRawLd : (kBKB / 2) * kBLdBf);
  static constexpr int kSmem = kStages * kStage + (S8 ? kBN * kBLdS8 : 0);
};

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
__device__ __forceinline__ void store_pair(const Args& a, int row, int col, float v0, float v1) {
  if (row >= a.m || col >= a.n) return;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out) + size_t(row) * a.n + col;
  if (col + 1 < a.n && a.n % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16_rn(v0);
    if (col + 1 < a.n) o[1] = __float2bfloat16_rn(v1);
  }
}

template <bool S8>
__global__ void __launch_bounds__(kThreads, 2) probe_dot_kernel(Args a) {
  using Acc = typename std::conditional<S8, int, float>::type;
  using L = Layout<S8>;
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile: rows 64 wm.., columns 32 wn..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_bytes = a.k * (S8 ? 1 : 2);
  const int tiles = (k_bytes + kBKB - 1) / kBKB;

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = Acc(0);

  auto load_tile = [&](int t) {  // cp.async of K tile t into its stage
    char* st = smem + (t % kStages) * L::kStage;
    copy_rows(st, kALd, a.x, size_t(k_bytes), m0, a.m, t * kBKB, k_bytes, kBM, kBKB, a.vec_a);
    if constexpr (S8) {
      copy_rows(st + kABytes, kRawLd, a.w, size_t(a.n), t * kBKB, a.k, n0, a.n, kBKB, kBN,
                a.vec_b);
    } else {
      copy_rows(st + kABytes, kBLdBf, a.w, size_t(a.n) * 2, t * (kBKB / 2), a.k, n0 * 2,
                a.n * 2, kBKB / 2, kBN * 2, a.vec_b);
    }
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
    const char* as = smem + (t % kStages) * L::kStage;
    const char* bs = as + kABytes;
    if constexpr (S8) {
      char* bt = smem + kStages * L::kStage;
      transpose_b_s8(bt, bs);
      __syncthreads();
      bs = bt;
    }
#pragma unroll
    for (int ks = 0; ks < kBKB / 32; ++ks) {  // 32 bytes of K: one mma deep
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // two n-tiles of 8 an ldmatrix
        uint32_t r[4];
        if constexpr (S8) {
          ldmatrix_x4(r, bs + (32 * wn + 16 * p + (lane & 7) + 8 * (lane >> 4)) * kBLdS8 +
                             32 * ks + 16 * ((lane >> 3) & 1));
        } else {
          ldmatrix_x4_trans(r, bs + (16 * ks + (lane & 15)) * kBLdBf +
                                   (32 * wn + 16 * p + 8 * (lane >> 4)) * 2);
        }
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

template <bool S8>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  const int smem = Layout<S8>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(probe_dot_kernel<S8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_dot_kernel<S8><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy (16, 8 or 4 bytes) dividing both a row's bytes and the
// base address, else 1.
int copy_width(const void* p, long long row_bytes) {
  const unsigned long long addr = reinterpret_cast<unsigned long long>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && addr % v == 0) return v;
  return 1;
}

}  // namespace

extern "C" {

// x (m, k), w (k, n), out (m, n), row-major; s8 != 0: int8, else bf16.
int probe_dot_launch(const void* x, const void* w, void* out, int m, int n, int k, int s8,
                     void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535) return -1;
  const int es = s8 ? 1 : 2;
  Args a{static_cast<const char*>(x), static_cast<const char*>(w), static_cast<char*>(out),
         m, n, k, copy_width(x, (long long)k * es), 0};
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.vec_b = copy_width(w, (long long)n * es);
  return s8 ? launch<true>(a, grid, st) : launch<false>(a, grid, st);
}

}  // extern "C"
