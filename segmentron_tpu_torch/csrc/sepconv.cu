// Fused separable convolution for inference, one hand-written Hopper kernel
// family (sm_90a):
//
//   [relu] -> depthwise 3x3 (dilation d, stride 1|2, zero pad d), f32
//          -> * mid_scale + mid_bias
//          -> [round half-even, clip +-127, int8]
//          -> pointwise product (bf16*bf16->f32 | f32*f32->f32 | s8*s8->s32)
//          -> * out_scale + out_bias
//          -> [+ (x_in . skip_w) * skip_scale + skip_bias | + x_in] -> x's type
//
// x (N,H,W,C) -> out (N,H/s,W/s,Co), NHWC, bf16 or f32. Replaces the four
// Pallas kernels of segmentron_tpu/ops/sepconv.py: _kernel
// (fused_sepconv_infer), _kernel_v2 (fused_sepconv_infer_v2), _kernel_v3
// (fused_sepconv_infer_v3) and _kernel_v3_skip (fused_sepconv_infer_v3_skip).
// Inference only, both BNs folded on the host into per-channel affines.
//
// Bound on an H100, for a middle-flow layer of Xception-65 at output stride 8,
// (1,128,256,728) -> 728: 95.4 MB moved (0.0285 ms at 3.35 TB/s) and 34.7 GFLOP
// (0.0351 ms at the bf16 peak, 0.0176 ms at the int8 peak): bound by operations
// in bf16 and by bytes in int8.
//
// Design. A 256-thread block owns 8 x 16 output pixels. It walks the input
// channels in chunks of 32: the chunk of the haloed input tile comes into
// shared memory (zero outside the image), the nine taps, the mid affine (and
// the int8 rounding) run on the CUDA cores into an A chunk, and the product
// with the matching chunk of the packed pointwise weights accumulates in
// registers, 128 output channels at a time: mma.sync m16n8k16 (bf16) or
// m16n8k32 (s8) on the tensor cores, f32 FMA on the CUDA cores for f32 I/O.
// The epilogue applies the out affine and the residual; a conv skip is a second
// product over chunks of x_in (picked at the stride) with the main result
// parked in shared memory meanwhile. The accumulator of all output channels
// does not fit in registers (128 px x 728 x 4 B = 372 KB), so Co is tiled by
// 128. Two kernels share these stages:
//
//  * sepconv_resident_kernel (tensor-core products, when the tile's whole
//    depthwise result fits in shared memory: up to ~730 channels in bf16,
//    ~1400 as int8): phase 1 computes the depthwise result of ALL input
//    channels once into a resident A tile, input chunks double-buffered with
//    cp.async; phase 2 walks the Co tiles, streaming weight chunks (cp.async,
//    the next step's 2 or 4 chunks arriving while this step's are multiplied)
//    against the resident A, and sends each tile's results out through shared
//    memory in 16-byte vectors. Nothing is recomputed. Where there are fewer
//    pixel tiles than SMs, the Co tiles are split over several blocks (each
//    recomputes phase 1).
//  * sepconv_kernel (f32 products, and any shape the first does not take): a
//    block owns one Co tile and recomputes the depthwise chunk, so that work
//    is done ceil(Co/128) times; Co tiles of one pixel tile are neighbours in
//    the grid, so they find the input in L2.
//
// Channels are padded with zeros to a multiple of 32 in the packed weights,
// and read as zeros from the input. What bounds the resident kernel is not the
// tensor cores. The clock64 probe below (chip_smoke.py --probe) gave for the
// middle-flow int8 layer on an H100, per block: the taps 47 % (4,500 cycles
// per 32-channel chunk, the CUDA cores' instruction issue: a load, two
// conversions, a ReLU and two FMA per tap and channel pair), the products
// 39 % (~630 cycles per chunk and Co tile, shared-memory bandwidth: a warp's
// 32 x 64 tile reads 6 KB of fragments for 16 or 32 mma), the epilogue 14 %.
// The resident tile leaves room for one block of 8 warps per SM.
//
// C interface: sepconv_launch returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Built with -DSEPCONV_PROFILE (``chip_smoke.py --probe``), the resident
// kernel sums thread 0's clock64 cycles per phase over its blocks.
#ifdef SEPCONV_PROFILE
__device__ unsigned long long g_cycles[4];  // taps, phase 2, of which epilogue, blocks
#define PROBE(var) const long long var = clock64()
#define PROBE_ADD(slot, from, to) \
  if (threadIdx.x == 0) atomicAdd(&g_cycles[slot], static_cast<unsigned long long>((to) - (from)))
#else
#define PROBE(var)
#define PROBE_ADD(slot, from, to)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 16, kM = kTH * kTW;  // output pixels of a block
constexpr int kNT = 128;                          // output channels of a block
constexpr int kKC = 32;                           // input channels of a chunk
constexpr int kAcc = kM * kNT / kThreads;         // accumulators of a thread
constexpr int kOutLd = kNT + 8;                   // row of the staged epilogue, floats

enum Dot { kDotNative = 0, kDotS8 = 1 };  // native: x's type (bf16 mma | f32 FMA)
enum Skip { kSkipNone = 0, kSkipConv = 1, kSkipSum = 2 };

struct Args {
  const void* x;       // (n,h,w,c)
  const void* xin;     // conv: (n,h,w,cin); sum: (n,ho,wo,co); else null
  void* out;           // (n,ho,wo,co)
  const float* dwp;    // (11,cp): nine taps, mid scale, mid bias; zero padded
  const void* pw;      // bf16/s8: (cop,cp); f32: (cp,cop); zero padded
  const float* osb;    // (2,cop): out scale, out bias
  const void* skw;     // x's type, packed like pw over (cinp) or null
  const float* ska;    // (2,cop): skip scale, skip bias, or null
  int n, h, w, c, co, cin, ho, wo, d, stride, relu, skip;
  int cp, cop, cinp, tiles_x, ih, iw;
  int co_tiles_per_block;  // resident kernel: Co tiles a block walks
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// 16-byte asynchronous copy to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most the N newest groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte vector of T.
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  uint4 raw;
  __device__ T* elems() { return reinterpret_cast<T*>(&raw); }
};

// Vector kN channels from ch on of a pixel's channel row (c channels at
// src), zero past c; ReLU on request. Vector loads need c % kN == 0.
template <typename T>
__device__ __forceinline__ Vec<T> load_channels(const T* src, int ch, int c, bool relu) {
  Vec<T> v;
  if (ch + Vec<T>::kN <= c && c % Vec<T>::kN == 0) {
    v.raw = *reinterpret_cast<const uint4*>(src + ch);
  } else {
#pragma unroll
    for (int e = 0; e < Vec<T>::kN; ++e)
      v.elems()[e] = ch + e < c ? src[ch + e] : cvt<T>(0.f);
  }
  if (relu) {
#pragma unroll
    for (int e = 0; e < Vec<T>::kN; ++e) v.elems()[e] = cvt<T>(fmaxf(to_f(v.elems()[e]), 0.f));
  }
  return v;
}

// -------------------------------------------------- shared-memory layouts
// A chunk: kM pixel rows of kKC values; B chunk: the weights of kNT output
// channels for the same kKC input channels. Row strides keep 16-byte
// alignment and spread the rows of a fragment over the banks.
//   bf16: A [kM][40] bf16, B [kNT][40] bf16 (n-major: k contiguous)
//   s8:   A [kM][48] s8,   B [kNT][48] s8
//   f32:  A [kM][36] f32,  B [kKC][kNT] f32 (k-major: n contiguous)
template <typename AT> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kLd = 40, kABytes = kM * 40 * 2, kBBytes = kNT * 40 * 2;
};
template <> struct Tile<int8_t> {
  static constexpr int kLd = 48, kABytes = kM * 48, kBBytes = kNT * 48;
};
template <> struct Tile<float> {
  static constexpr int kLd = 36, kABytes = kM * 36 * 4, kBBytes = kKC * kNT * 4;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
template <typename T, int DOT> struct Smem {
  using MainA = typename std::conditional<DOT == kDotS8, int8_t, T>::type;
  // the conv skip's product runs in x's type whatever the main product's
  static constexpr int kA = cmax(Tile<MainA>::kABytes, Tile<T>::kABytes);
  static constexpr int kB = cmax(Tile<MainA>::kBBytes, Tile<T>::kBBytes);
  static constexpr int kStash = kAcc * kThreads * 4;
};

// Load the chunk of packed weights for output channels n0.. and input
// channels k0.. into the B chunk.
template <typename AT>
__device__ void load_b(const void* packed, int kp, int np, int n0, int k0, void* bsm) {
  if constexpr (std::is_same<AT, float>::value) {
    // (kp, np) f32 -> [kKC][kNT]
    const float* src = static_cast<const float*>(packed);
    float* dst = static_cast<float*>(bsm);
    for (int u = threadIdx.x; u < kKC * kNT / 4; u += kThreads) {
      const int k = u / (kNT / 4), v = u % (kNT / 4);
      *reinterpret_cast<uint4*>(dst + k * kNT + v * 4) =
          *reinterpret_cast<const uint4*>(src + size_t(k0 + k) * np + n0 + v * 4);
    }
  } else {
    // (np, kp) AT -> [kNT][kLd]
    constexpr int kVecs = kKC * sizeof(AT) / 16;  // 16-byte vectors a row
    const AT* src = static_cast<const AT*>(packed);
    AT* dst = static_cast<AT*>(bsm);
    for (int u = threadIdx.x; u < kNT * kVecs; u += kThreads) {
      const int nn = u / kVecs, v = u % kVecs;
      *reinterpret_cast<uint4*>(dst + nn * Tile<AT>::kLd + v * (16 / sizeof(AT))) =
          *reinterpret_cast<const uint4*>(src + size_t(n0 + nn) * kp + k0 + v * (16 / sizeof(AT)));
    }
  }
}

// load_b with cp.async, for the tensor-core layouts.
template <typename AT>
__device__ void load_b_async(const void* packed, int kp, int n0, int k0, void* bsm) {
  constexpr int kVecs = kKC * sizeof(AT) / 16, kN = 16 / sizeof(AT);
  const AT* src = static_cast<const AT*>(packed);
  AT* dst = static_cast<AT*>(bsm);
  for (int u = threadIdx.x; u < kNT * kVecs; u += kThreads) {
    const int nn = u / kVecs, v = u % kVecs;
    cp_async16(dst + nn * Tile<AT>::kLd + v * kN, src + size_t(n0 + nn) * kp + k0 + v * kN, true);
  }
}

// ------------------------------------------------------------- products
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator layouts. Tensor cores: warp (wm, wn) of 4 x 2 owns rows
// 32*wm.. and columns 64*wn..; acc[(mi*8 + nj)*4 + r] is row
// 32*wm + 16*mi + g + 8*(r/2), column 64*wn + 8*nj + 2*tig + r%2.
// CUDA cores: thread (tx, ty) of 16 x 16 owns rows 8*ty.. and the columns
// 4*tx.. and 64 + 4*tx..; acc[i*8 + j].
template <typename AT>
__device__ __forceinline__ void acc_pos(int idx, int& m, int& nn) {
  if constexpr (std::is_same<AT, float>::value) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int i = idx / 8, j = idx % 8;
    m = ty * 8 + i;
    nn = (j < 4 ? 0 : 60) + tx * 4 + j;
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int r = idx % 4, nj = (idx / 4) % 8, mi = idx / 32;
    m = (warp % 4) * 32 + mi * 16 + g + (r / 2) * 8;
    nn = (warp / 4) * 64 + nj * 8 + tig * 2 + (r % 2);
  }
}

// acc += A chunk x B chunk; ``lda`` is A's row stride in elements (the chunk's
// own, or the resident tile's).
__device__ __forceinline__ void dot_chunk(float (&acc)[kAcc], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b,
                                          int lda = Tile<__nv_bfloat16>::kLd) {
  constexpr int LD = Tile<__nv_bfloat16>::kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* arow = a + ((warp % 4) * 32 + g) * lda + tig * 2;
  const __nv_bfloat16* brow = b + ((warp / 4) * 64 + g) * LD + tig * 2;
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = arow + mi * 16 * lda + ks * 16;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const __nv_bfloat16* p = brow + nj * 8 * LD + ks * 16;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma_bf16(*reinterpret_cast<float(*)[4]>(&acc[(mi * 8 + nj) * 4]), af[mi], b0, b1);
    }
  }
}

__device__ __forceinline__ void dot_chunk(int (&acc)[kAcc], const int8_t* a, const int8_t* b,
                                          int lda = Tile<int8_t>::kLd) {
  constexpr int LD = Tile<int8_t>::kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int8_t* arow = a + ((warp % 4) * 32 + g) * lda + tig * 4;
  const int8_t* brow = b + ((warp / 4) * 64 + g) * LD + tig * 4;
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int8_t* p = arow + mi * 16 * lda;
    af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
    af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
    af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
  }
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int8_t* p = brow + nj * 8 * LD;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_s8(*reinterpret_cast<int(*)[4]>(&acc[(mi * 8 + nj) * 4]), af[mi], b0, b1);
  }
}

__device__ __forceinline__ void dot_chunk(float (&acc)[kAcc], const float* a, const float* b) {
  constexpr int LD = Tile<float>::kLd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* arow = a + ty * 8 * LD;
  const float* bcol = b + tx * 4;
#pragma unroll 4
  for (int k = 0; k < kKC; ++k) {
    const float4 b0 = *reinterpret_cast<const float4*>(bcol + k * kNT);
    const float4 b1 = *reinterpret_cast<const float4*>(bcol + k * kNT + 64);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float av = arow[i * LD + k];
      float* c = &acc[i * 8];
      c[0] = fmaf(av, b0.x, c[0]);
      c[1] = fmaf(av, b0.y, c[1]);
      c[2] = fmaf(av, b0.z, c[2]);
      c[3] = fmaf(av, b0.w, c[3]);
      c[4] = fmaf(av, b1.x, c[4]);
      c[5] = fmaf(av, b1.y, c[5]);
      c[6] = fmaf(av, b1.z, c[6]);
      c[7] = fmaf(av, b1.w, c[7]);
    }
  }
}

// ------------------------------------------------------------- the stages
// The chunk k0.. of the haloed input tile of image n whose first pixel is
// (ir0, ic0): [ih*iw][kKC] of T, zero outside the image and past c.
template <typename T>
__device__ void load_input(const Args& p, int n, int ir0, int ic0, int k0, T* tile) {
  constexpr int kVecs = kKC * sizeof(T) / 16, kN = Vec<T>::kN;
  const T* x = static_cast<const T*>(p.x);
  const int total = p.ih * p.iw * kVecs;
  for (int u = threadIdx.x; u < total; u += kThreads) {
    const int px = u / kVecs, v = u % kVecs;
    const int r = ir0 + px / p.iw, cc = ic0 + px % p.iw;
    Vec<T> val;
    if (r >= 0 && r < p.h && cc >= 0 && cc < p.w) {
      val = load_channels(x + ((size_t(n) * p.h + r) * p.w + cc) * p.c, k0 + v * kN, p.c,
                          p.relu != 0);
    } else {
      val.raw = make_uint4(0u, 0u, 0u, 0u);
    }
    *reinterpret_cast<uint4*>(tile + px * kKC + v * kN) = val.raw;
  }
}

// load_input with cp.async: a raw copy, so the ReLU is left to the reader.
// Needs c % (16 / sizeof(T)) == 0.
template <typename T>
__device__ void load_input_async(const Args& p, int n, int ir0, int ic0, int k0, T* tile) {
  constexpr int kVecs = kKC * sizeof(T) / 16, kN = Vec<T>::kN;
  const T* x = static_cast<const T*>(p.x);
  const int total = p.ih * p.iw * kVecs;
  for (int u = threadIdx.x; u < total; u += kThreads) {
    const int px = u / kVecs, ch = k0 + (u % kVecs) * kN;
    const int r = ir0 + px / p.iw, cc = ic0 + px % p.iw;
    const bool valid = r >= 0 && r < p.h && cc >= 0 && cc < p.w && ch < p.c;
    cp_async16(tile + px * kKC + (u % kVecs) * kN,
               valid ? x + ((size_t(n) * p.h + r) * p.w + cc) * p.c + ch : x, valid);
  }
}

// Nine taps + mid affine (+ int8 rounding) of the chunk k0.. into A (row
// stride lda; ``a`` points at the chunk's first column). Thread (cp, tc) of
// 16 x 16 owns channels 2*cp, 2*cp+1 of the tile column tc, all kTH rows.
// kRelu: the ReLU is still to apply to the tile's values. kRows: tile rows a
// thread works on at once (independent sums to hide the latency of shared
// memory; a caller with its accumulators live takes few).
template <typename T, typename AT, bool kRelu = false, int kRows = 2>
__device__ void depthwise(const Args& p, int k0, const T* tile, AT* a,
                          int lda = Tile<AT>::kLd) {
  const int cp = threadIdx.x % 16, tc = threadIdx.x / 16;
  const float* w = p.dwp + k0 + 2 * cp;
  float2 k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = __ldg(reinterpret_cast<const float2*>(w + t * p.cp));
  const float2 ms = __ldg(reinterpret_cast<const float2*>(w + 9 * p.cp));
  const float2 mb = __ldg(reinterpret_cast<const float2*>(w + 10 * p.cp));
  const int row_step = p.stride * p.iw * kKC, ky_step = p.d * p.iw * kKC, kx_step = p.d * kKC;
  const T* col = tile + (tc * p.stride) * kKC + 2 * cp;
#pragma unroll 1
  for (int tb = 0; tb < kTH; tb += kRows) {
    float2 acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          float2 v = ld2(col + (tb + j) * row_step + ky * ky_step + kx * kx_step);
          if (kRelu) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
          acc[j].x = fmaf(v.x, k[ky * 3 + kx].x, acc[j].x);
          acc[j].y = fmaf(v.y, k[ky * 3 + kx].y, acc[j].y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      // multiply and add rounded separately, as the plain version does
      const float y0 = __fadd_rn(__fmul_rn(acc[j].x, ms.x), mb.x);
      const float y1 = __fadd_rn(__fmul_rn(acc[j].y, ms.y), mb.y);
      AT* dst = a + ((tb + j) * kTW + tc) * lda + 2 * cp;
      if constexpr (std::is_same<AT, int8_t>::value) {
        const int q0 = __float2int_rn(fminf(fmaxf(y0, -127.f), 127.f));
        const int q1 = __float2int_rn(fminf(fmaxf(y1, -127.f), 127.f));
        *reinterpret_cast<char2*>(dst) = make_char2(static_cast<signed char>(q0),
                                                    static_cast<signed char>(q1));
      } else if constexpr (std::is_same<AT, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

// The chunk k0.. of x_in at the tile's (strided) pixels into the A chunk.
template <typename T>
__device__ void load_skip_a(const Args& p, int n, int r0, int c0, int k0, T* a) {
  constexpr int kVecs = kKC * sizeof(T) / 16, kN = Vec<T>::kN;
  const T* xin = static_cast<const T*>(p.xin);
  for (int u = threadIdx.x; u < kM * kVecs; u += kThreads) {
    const int m = u / kVecs, v = u % kVecs;
    const int r = (r0 + m / kTW) * p.stride, cc = (c0 + m % kTW) * p.stride;
    Vec<T> val;
    if (r < p.h && cc < p.w) {
      val = load_channels(xin + ((size_t(n) * p.h + r) * p.w + cc) * p.cin, k0 + v * kN,
                          p.cin, false);
    } else {
      val.raw = make_uint4(0u, 0u, 0u, 0u);
    }
    *reinterpret_cast<uint4*>(a + m * Tile<T>::kLd + v * kN) = val.raw;
  }
}

// The end of a Co tile: the out affine on the main product's sums, the
// conv skip (a second product in x's type over chunks of x_in, through the A
// and B chunk buffers, with the main result parked in ``stash`` meanwhile) or
// the sum skip, and the store.
// kStaged: the results go out through ``a_sm`` (kM/2 rows of kOutLd floats,
// half the tile at a time), so that a thread stores, and reads the sum skip, in
// 16-byte vectors of neighbouring channels instead of its accumulators' pairs.
template <typename T, int DOT, bool kStaged = false, typename MainAcc>
__device__ void finish_tile(const Args& p, const MainAcc (&acc)[kAcc], int n, int r0, int c0,
                            int n0, unsigned char* a_sm, unsigned char* b_sm, float* stash) {
  using MainA = typename Smem<T, DOT>::MainA;
  // s8 main product (tensor-core layout) before an f32 conv skip (CUDA-core
  // layout): the main result changes owner through shared memory
  constexpr bool kExchange = DOT == kDotS8 && std::is_same<T, float>::value;
  float res[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int m, nn;
    acc_pos<MainA>(i, m, nn);
    // multiply and add rounded separately, as the plain version does
    res[i] = __fadd_rn(__fmul_rn(static_cast<float>(acc[i]), __ldg(p.osb + n0 + nn)),
                       __ldg(p.osb + p.cop + n0 + nn));
  }

  if (p.skip == kSkipConv) {
    // park the main result in shared memory and run the skip product, in
    // x's type, in its place
    if constexpr (kExchange) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        int m, nn;
        acc_pos<MainA>(i, m, nn);
        stash[m * kNT + nn] = res[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) stash[i * kThreads + threadIdx.x] = res[i];
    }
    float sk[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sk[i] = 0.f;
    for (int k0 = 0; k0 < p.cinp; k0 += kKC) {
      load_skip_a<T>(p, n, r0, c0, k0, reinterpret_cast<T*>(a_sm));
      load_b<T>(p.skw, p.cinp, p.cop, n0, k0, b_sm);
      __syncthreads();
      dot_chunk(sk, reinterpret_cast<const T*>(a_sm), reinterpret_cast<const T*>(b_sm));
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      int m, nn;
      acc_pos<T>(i, m, nn);
      const float parked = kExchange ? stash[m * kNT + nn] : stash[i * kThreads + threadIdx.x];
      const float s = __fmul_rn(sk[i], __ldg(p.ska + n0 + nn));
      res[i] = __fadd_rn(__fadd_rn(parked, s), __ldg(p.ska + p.cop + n0 + nn));
    }
  }

  // store; the layout is that of the last product that ran. In both layouts
  // accumulators 2j and 2j+1 are neighbouring channels of one pixel.
  const bool fma_layout =
      std::is_same<T, float>::value && (DOT == kDotNative || p.skip == kSkipConv);
  T* out = static_cast<T*>(p.out);
  const T* xsum = static_cast<const T*>(p.xin);
  constexpr int kVN = 16 / sizeof(T);
  if (kStaged && p.co % kVN == 0) {
    constexpr int LD = kOutLd, kVecs = kNT / kVN;
    float* stg = reinterpret_cast<float*>(a_sm);
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // the skip product, or the other half's readers, are done
#pragma unroll
      for (int i = 0; i < kAcc; i += 2) {
        int m, nn;
        if (fma_layout)
          acc_pos<float>(i, m, nn);
        else
          acc_pos<__nv_bfloat16>(i, m, nn);
        if (m / (kM / 2) == half)
          *reinterpret_cast<float2*>(stg + (m % (kM / 2)) * LD + nn) = make_float2(res[i], res[i + 1]);
      }
      __syncthreads();
      for (int u = threadIdx.x; u < (kM / 2) * kVecs; u += kThreads) {
        const int m = u / kVecs + half * (kM / 2), v = u % kVecs;
        const int r = r0 + m / kTW, cc = c0 + m % kTW, ch = n0 + v * kVN;
        if (r >= p.ho || cc >= p.wo || ch >= p.co) continue;
        const size_t at = ((size_t(n) * p.ho + r) * p.wo + cc) * p.co + ch;
        float src[kVN];
#pragma unroll
        for (int e = 0; e < kVN; e += 4)
          *reinterpret_cast<float4*>(src + e) =
              *reinterpret_cast<const float4*>(stg + (m % (kM / 2)) * LD + v * kVN + e);
        Vec<T> o;
        if (p.skip == kSkipSum) {
          Vec<T> xs;
          xs.raw = *reinterpret_cast<const uint4*>(xsum + at);
#pragma unroll
          for (int e = 0; e < kVN; ++e) o.elems()[e] = cvt<T>(__fadd_rn(src[e], to_f(xs.elems()[e])));
        } else {
#pragma unroll
          for (int e = 0; e < kVN; ++e) o.elems()[e] = cvt<T>(src[e]);
        }
        *reinterpret_cast<uint4*>(out + at) = o.raw;
      }
    }
    return;
  }
  const bool pairs = p.co % 2 == 0;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    int m, nn;
    if (fma_layout)
      acc_pos<float>(i, m, nn);
    else
      acc_pos<__nv_bfloat16>(i, m, nn);
    const int r = r0 + m / kTW, cc = c0 + m % kTW, ch = n0 + nn;
    if (r >= p.ho || cc >= p.wo || ch >= p.co) continue;
    const size_t at = ((size_t(n) * p.ho + r) * p.wo + cc) * p.co + ch;
    float v0 = res[i], v1 = res[i + 1];
    if (pairs) {
      if (p.skip == kSkipSum) {
        const float2 sum = ld2(xsum + at);
        v0 = __fadd_rn(v0, sum.x);
        v1 = __fadd_rn(v1, sum.y);
      }
      store2(out + at, v0, v1);
    } else {
      if (p.skip == kSkipSum) v0 = __fadd_rn(v0, to_f(xsum[at]));
      out[at] = cvt<T>(v0);
      if (ch + 1 < p.co) {
        if (p.skip == kSkipSum) v1 = __fadd_rn(v1, to_f(xsum[at + 1]));
        out[at + 1] = cvt<T>(v1);
      }
    }
  }
}

template <typename T, int DOT>
__global__ void __launch_bounds__(kThreads, 2) sepconv_kernel(const Args p) {
  using MainA = typename Smem<T, DOT>::MainA;
  using MainAcc = typename std::conditional<DOT == kDotS8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_sm = smem;
  unsigned char* b_sm = a_sm + Smem<T, DOT>::kA;
  T* tile = reinterpret_cast<T*>(b_sm + Smem<T, DOT>::kB);
  float* stash = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(tile) + (size_t(p.ih) * p.iw * kKC * sizeof(T) + 15) / 16 * 16);

  const int n0 = blockIdx.x * kNT;
  const int r0 = (blockIdx.y / p.tiles_x) * kTH, c0 = (blockIdx.y % p.tiles_x) * kTW;
  const int n = blockIdx.z;

  MainAcc acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  for (int k0 = 0; k0 < p.cp; k0 += kKC) {
    load_input<T>(p, n, r0 * p.stride - p.d, c0 * p.stride - p.d, k0, tile);
    load_b<MainA>(p.pw, p.cp, p.cop, n0, k0, b_sm);
    __syncthreads();
    depthwise<T, MainA>(p, k0, tile, reinterpret_cast<MainA*>(a_sm));  // ReLU done at the load
    __syncthreads();
    dot_chunk(acc, reinterpret_cast<const MainA*>(a_sm), reinterpret_cast<const MainA*>(b_sm));
    __syncthreads();
  }
  finish_tile<T, DOT>(p, acc, n, r0, c0, n0, a_sm, b_sm, stash);
}

// ----------------------------------------------------- the resident kernel
// Shared memory: the resident A tile [kM][cp + pad], then a staging region
// (two input-tile chunks in phase 1; two steps' weight chunks in phase 2; the
// conv skip's A and B chunks; the epilogue's half tile of f32 results), then
// the conv skip's stash.
template <typename T, int DOT> struct Resident {
  using MainA = typename Smem<T, DOT>::MainA;
  static constexpr int kPad = 16 / sizeof(MainA);  // elements: 16 bytes a row
  // weight chunks a phase-2 step takes between two barriers: long enough
  // steps for the next step's copies to arrive meanwhile
  static constexpr int kStep = sizeof(MainA) == 1 ? 4 : 2;
  static constexpr int kRing = 2 * kStep * Tile<MainA>::kBBytes;  // two steps in flight
  static constexpr int kOutBytes = (kM / 2) * kOutLd * 4;  // finish_tile's staging
  __host__ __device__ static int lda(int cp) { return cp + kPad; }
  __host__ __device__ static size_t a_bytes(int cp) { return size_t(kM) * lda(cp) * sizeof(MainA); }
  __host__ __device__ static size_t tile_bytes(int ih, int iw) {
    return (size_t(ih) * iw * kKC * sizeof(T) + 15) / 16 * 16;
  }
  __host__ __device__ static size_t stage_bytes(int ih, int iw) {
    size_t b = 2 * tile_bytes(ih, iw);
    if (b < size_t(kRing)) b = kRing;
    if (b < size_t(kOutBytes)) b = kOutBytes;
    if (b < size_t(Tile<T>::kABytes + Tile<T>::kBBytes)) b = Tile<T>::kABytes + Tile<T>::kBBytes;
    return b;
  }
};

template <typename T, int DOT>
__global__ void __launch_bounds__(kThreads, 2) sepconv_resident_kernel(const Args p) {
  using R = Resident<T, DOT>;
  using MainA = typename R::MainA;
  using MainAcc = typename std::conditional<DOT == kDotS8, int, float>::type;
  static_assert(!std::is_same<MainA, float>::value, "tensor-core products only");
  extern __shared__ __align__(16) unsigned char smem[];
  MainA* a_res = reinterpret_cast<MainA*>(smem);
  unsigned char* stage = smem + R::a_bytes(p.cp);
  const size_t half = R::stage_bytes(p.ih, p.iw) / 2;
  float* stash = reinterpret_cast<float*>(stage + 2 * half);
  const int lda = R::lda(p.cp);

  const int r0 = (blockIdx.y / p.tiles_x) * kTH, c0 = (blockIdx.y % p.tiles_x) * kTW;
  const int n = blockIdx.z;
  const int ir0 = r0 * p.stride - p.d, ic0 = c0 * p.stride - p.d;
  const int chunks = p.cp / kKC;
  PROBE(t0);
  // phase 1: the depthwise result of every input channel, once. Chunk i+1
  // loads while chunk i is computed.
  load_input_async<T>(p, n, ir0, ic0, 0, reinterpret_cast<T*>(stage));
  cp_async_commit();
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i has landed, and chunk i-1's buffer is free
    if (i + 1 < chunks)
      load_input_async<T>(p, n, ir0, ic0, (i + 1) * kKC,
                          reinterpret_cast<T*>(stage + ((i + 1) & 1) * half));
    cp_async_commit();
    const T* tile = reinterpret_cast<const T*>(stage + (i & 1) * half);
    if (p.relu)
      depthwise<T, MainA, true, kTH>(p, i * kKC, tile, a_res + i * kKC, lda);
    else
      depthwise<T, MainA, false, kTH>(p, i * kKC, tile, a_res + i * kKC, lda);
  }
  // phase 2: the Co tiles of this block against the resident A, the weight
  // chunks of step st+1 arriving while step st is multiplied
  PROBE(t1);
  constexpr int kStep = R::kStep, kBBytes = Tile<MainA>::kBBytes;
  const int steps = (chunks + kStep - 1) / kStep;
  auto load_step = [&](int n0, int st) {
#pragma unroll
    for (int j = 0; j < kStep; ++j)
      if (st * kStep + j < chunks)
        load_b_async<MainA>(p.pw, p.cp, n0, (st * kStep + j) * kKC,
                            stage + ((st & 1) * kStep + j) * kBBytes);
    cp_async_commit();
  };
  const int ct0 = blockIdx.x * p.co_tiles_per_block;
  const int ct1 = min(ct0 + p.co_tiles_per_block, p.cop / kNT);
  for (int ct = ct0; ct < ct1; ++ct) {
    const int n0 = ct * kNT;
    MainAcc acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    __syncthreads();  // phase 1, or the last tile's products and epilogue, are done with the stage
    load_step(n0, 0);
    for (int st = 0; st < steps; ++st) {
      cp_async_wait<0>();
      __syncthreads();  // step st has landed, and step st-1's buffers are free
      if (st + 1 < steps) load_step(n0, st + 1);
#pragma unroll
      for (int j = 0; j < kStep; ++j)
        if (st * kStep + j < chunks)
          dot_chunk(acc, a_res + (st * kStep + j) * kKC,
                    reinterpret_cast<const MainA*>(stage + ((st & 1) * kStep + j) * kBBytes), lda);
    }
    __syncthreads();  // the epilogue reuses the stage
    PROBE(t2);
    finish_tile<T, DOT, true>(p, acc, n, r0, c0, n0, stage, stage + Tile<T>::kABytes, stash);
    PROBE(t3);
    PROBE_ADD(2, t2, t3);
  }
  PROBE(t4);
  PROBE_ADD(0, t0, t1);
  PROBE_ADD(1, t1, t4);
  PROBE_ADD(3, 0, 1);
}

template <typename K>
int launch_kernel(K kernel, const Args& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t kMaxSmem = 227 * 1024;

template <typename T, int DOT>
int launch(Args p, cudaStream_t stream) {
  const int tiles = p.tiles_x * ((p.ho + kTH - 1) / kTH);
  if (tiles > 65535 || p.n > 65535) return -1;
  const int co_tiles = p.cop / kNT;
  if constexpr (!(std::is_same<T, float>::value && DOT == kDotNative)) {
    using R = Resident<T, DOT>;
    size_t smem = R::a_bytes(p.cp) + R::stage_bytes(p.ih, p.iw);
    if (p.skip == kSkipConv) smem += Smem<T, DOT>::kStash;
    if (smem <= kMaxSmem && p.c % (16 / sizeof(T)) == 0) {
      // enough blocks to fill the card: split the Co tiles where pixel
      // tiles alone are fewer than the SMs
      static int sms = 0;
      if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
          sms = 132;
      }
      int split = sms / (tiles * p.n);  // rounded down: a second wave costs a whole phase 1
      if (split < 1) split = 1;
      if (split > co_tiles) split = co_tiles;
      p.co_tiles_per_block = (co_tiles + split - 1) / split;
      split = (co_tiles + p.co_tiles_per_block - 1) / p.co_tiles_per_block;
      return launch_kernel(sepconv_resident_kernel<T, DOT>, p, dim3(split, tiles, p.n), smem,
                           stream);
    }
  }
  size_t smem = Smem<T, DOT>::kA + Smem<T, DOT>::kB +
                (size_t(p.ih) * p.iw * kKC * sizeof(T) + 15) / 16 * 16;
  if (p.skip == kSkipConv) smem += Smem<T, DOT>::kStash;
  if (smem > kMaxSmem) return -2;  // the haloed tile does not fit: dilation too large
  return launch_kernel(sepconv_kernel<T, DOT>, p, dim3(co_tiles, tiles, p.n), smem, stream);
}

}  // namespace

extern "C" {

#ifdef SEPCONV_PROFILE
// reset != 0: zero the cycle counts; else copy the four counts to ``out``.
int sepconv_probe(unsigned long long* out, int reset) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(reset ? cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero))
                                : cudaMemcpyFromSymbol(out, g_cycles, sizeof(zero)));
}
#endif

// Padded sizes the packed buffers must have: channels in (c, cin) to a
// multiple of 32, channels out to a multiple of 128.
int sepconv_pad_in(int c) { return (c + kKC - 1) / kKC * kKC; }
int sepconv_pad_out(int co) { return (co + kNT - 1) / kNT * kNT; }

// x (n,h,w,c) -> out (n,ho,wo,co) with ho = (h-1)/stride+1, wo likewise.
// skip: 0 none, 1 conv (xin (n,h,w,cin), skw, ska), 2 sum (xin like out).
// bf16 != 0: bfloat16 I/O, else f32; int8_dot != 0: pw is s8 and the depthwise
// result is rounded to s8. Returns the CUDA error of the launch, -1 for
// arguments the kernel does not take, -2 when the haloed tile exceeds shared
// memory.
int sepconv_launch(const void* x, const void* xin, void* out, const void* dwp,
                   const void* pw, const void* osb, const void* skw, const void* ska,
                   int n, int h, int w, int c, int co, int cin, int d, int stride,
                   int relu, int skip, int bf16, int int8_dot, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || co < 1 || d < 1 || (stride != 1 && stride != 2) ||
      skip < 0 || skip > 2 || (skip == kSkipConv && cin < 1) || (skip == kSkipSum && stride != 1))
    return -1;
  Args p;
  p.x = x; p.xin = xin; p.out = out;
  p.dwp = static_cast<const float*>(dwp);
  p.pw = pw;
  p.osb = static_cast<const float*>(osb);
  p.skw = skw;
  p.ska = static_cast<const float*>(ska);
  p.n = n; p.h = h; p.w = w; p.c = c; p.co = co; p.cin = cin;
  p.ho = (h - 1) / stride + 1; p.wo = (w - 1) / stride + 1;
  p.d = d; p.stride = stride; p.relu = relu; p.skip = skip;
  p.cp = sepconv_pad_in(c); p.cop = sepconv_pad_out(co);
  p.cinp = skip == kSkipConv ? sepconv_pad_in(cin) : 0;
  p.tiles_x = (p.wo + kTW - 1) / kTW;
  p.ih = (kTH - 1) * stride + 1 + 2 * d;
  p.iw = (kTW - 1) * stride + 1 + 2 * d;
  p.co_tiles_per_block = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return int8_dot ? launch<__nv_bfloat16, kDotS8>(p, s)
                            : launch<__nv_bfloat16, kDotNative>(p, s);
  return int8_dot ? launch<float, kDotS8>(p, s) : launch<float, kDotNative>(p, s);
}

}  // extern "C"
