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
// Three kernels share this source; the host picks one a call (make_plan;
// sepconv_plan reports the choice, ops/sepconv.py::sepconv_plan mirrors it):
//
//  * sepconv_wgmma_kernel<DOT, N, D, SKIP> takes bf16 I/O at stride 1,
//    dilation D of 1 or 2, C, Co and Cin multiples of 8, without skip or with
//    either skip: every bf16 layer of _kernel_v2, _kernel_v3 (int8_dot or
//    not) and _kernel on the flagship's paths, and the stride-1 block ends of
//    _kernel_v3_skip (the middle flow's sum skips, block3's conv skip at
//    output stride 8). Persistent blocks, one an SM, walk the items (8 x 8
//    output pixels = the 64 rows of a wgmma A tile, by 2 N output channels,
//    N = 192 where 384 divides the padded Co (728 -> 768: two items a tile),
//    else 128). 384 threads: two consumer warpgroups, each one m64nNk16 bf16
//    or m64nNk32 s8 wgmma chain over its N columns with both operands in
//    shared memory (setmaxnreg: 232 registers a consumer thread, 40 a
//    producer); in the producer warpgroup one thread streams the weight
//    ring (2 N rows x 128 bytes of K a stage, 128-byte swizzled, 2-4 stages)
//    and each item's affines, another the input stages (2 or 3): the
//    haloed box of the step's channels (a 4-D TMA map over NHWC x; zeros
//    outside the image and past C replace the old kernels' clamped loads)
//    and the step's depthwise weights. Both run ahead across items. K runs in
//    steps of 128 bytes (64 bf16 or 128 s8 channels). The taps of step k + 1
//    run on the CUDA cores while step k's products are in flight: a thread
//    takes 4 channels of a 2 x 2 quad of pixels d apart, so its 16 loads feed
//    36 taps a channel; the ReLU and the bf16 -> f32 conversion run once per
//    loaded value; the result goes straight into the next of three A
//    slots, K-major and 128-byte swizzled, as wgmma reads it (both
//    warpgroups read every slot, so the slot written is step k - 2's, whose
//    products both have waited on before the barrier that closed step k's
//    taps). The epilogue stages
//    each 64-channel box of the out affine's result in an A slot (swizzled:
//    conflict-free fragment stores) and writes it out in 16-byte vectors.
//    The taps' order ((ky, kx), one fmaf a tap) and the separately rounded
//    affines are depthwise()'s: the kernels agree bitwise up to the order of
//    the products' sums.
//    The block ends read x_in (N, H, W, Co | Cin) by TMA in boxes of [64
//    channels][8][8 pixels], 128-byte swizzled, into two 8 KB x_in slots.
//    Sum skip: that is the staging box's layout, so a thread reads its pairs
//    of x_in where it writes their results, adding x_in to the out affine's
//    f32 result before the one rounding to bf16 (_sepconv_plain's order); a
//    warpgroup's boxes alternate between its x_in slot (the item's first box
//    loaded under its K steps) and its A slot (free once the products are
//    done), box bx + 1 loading while box bx is worked. Conv skip: the box is
//    a K-major A tile; after the main chain a second chain of ceil(Cin / 64)
//    bf16 steps (f32 sums) takes A from the two slots as a ring and B, the
//    packed skw, through the weight ring; the epilogue forms
//    (affine + sums * skip scale) + skip bias, then rounds once.
//    What bounds it on an H100 (chip_smoke.py --probe, --sepconv-probe):
//    shared-memory traffic and the stream of loads, not the tensor cores. A
//    step of the v2 main case moves ~190 KB through shared memory (48 KB of
//    weights written by TMA and 48 KB read by wgmma, 16 KB of A read, the
//    taps' 62 KB, the input box) against 128 bytes a cycle; the taps take
//    ~60 % of a block's cycles at ~20 % of the FMA peak. With the taps and the
//    products left out, the loads alone take ~75 % of the v3 main case's time:
//    each item re-reads its 2 N x K weights, and each 64-pixel tile reads its
//    haloed input twice (once an item), ~600 MB from L2 at v3's main case.
//
//  * sepconv_resident_kernel (the first version; f32 I/O with int8_dot, the
//    f32 block ends, the stride-2 block end (its 17 x 17-pixel input box,
//    73,984 B a 128-channel s8 step, leaves no room for two input stages
//    beside the weight ring in the wgmma kernel), and bf16 shapes the wgmma
//    kernel does not take, when the tile's whole depthwise result fits in
//    shared memory): a
//    256-thread block owns 8 x 16 output pixels and walks the input channels
//    in chunks of 32: phase 1 computes the depthwise result of ALL input
//    channels once into a resident A tile, input chunks double-buffered with
//    cp.async; phase 2 walks the Co tiles of 128, streaming weight chunks
//    against the resident A (mma.sync m16n8k16 bf16 or m16n8k32 s8), and
//    sends each tile's results out through shared memory in 16-byte vectors.
//    The epilogue applies the out affine and the residual; a conv skip is a
//    second product over chunks of x_in (picked at the stride) with the main
//    result parked in shared memory meanwhile. Where there are fewer pixel
//    tiles than SMs, the Co tiles are split over several blocks (each
//    recomputes phase 1).
//  * sepconv_kernel (the first version; f32 products, and any shape the others do not
//    take): a block owns one Co tile and recomputes the depthwise chunk, so
//    that work is done ceil(Co/128) times; f32 FMA on the CUDA cores.
//
// Channels are padded with zeros to a multiple of 32 in the packed weights,
// and read as zeros from the input. The clock64 probe (chip_smoke.py
// --probe) gave for the resident kernel at the middle-flow int8 layer on an
// H100, per block: the taps 47 % (4,500 cycles per 32-channel chunk: a load,
// two conversions, a ReLU and two FMA per tap and channel pair), the products
// 39 % (shared-memory bandwidth under mma.sync), the epilogue 14 %.
//
// C interface: sepconv_launch returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma (bf16 and s8), tensor maps

// Built with -DSEPCONV_PROFILE (``chip_smoke.py --probe``), the resident
// kernel and the wgmma kernel sum thread 0's clock64 cycles per phase over
// their blocks.
#ifdef SEPCONV_PROFILE
__device__ unsigned long long g_cycles[4];     // resident: taps, phase 2, of which epilogue, blocks
// wgmma: taps (of which waits for the input, and the barrier after), waits on
// products, epilogue, all, blocks
__device__ unsigned long long g_cycles_wg[7];
#define PROBE(var) const long long var = clock64()
#define PROBE_ADD(slot, from, to) \
  if (threadIdx.x == 0) atomicAdd(&g_cycles[slot], static_cast<unsigned long long>((to) - (from)))
#define PROBE_WG_ADD(slot, from, to) \
  if (threadIdx.x == 0)                \
  atomicAdd(&g_cycles_wg[slot], static_cast<unsigned long long>((to) - (from)))
#else
#define PROBE(var)
#define PROBE_ADD(slot, from, to)
#define PROBE_WG_ADD(slot, from, to)
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

// ------------------------------------------------------ the wgmma kernel
// sepconv_wgmma_kernel<DOT, N, D, SKIP>: bf16 I/O, stride 1, dilation D (1
// or 2), no skip, the sum skip or the conv skip, C, Co and Cin multiples of 8
// (the design is described at the top).
constexpr int kWgTH = 8, kWgTW = 8, kWgM = kWgTH * kWgTW;  // a block's pixels: A's 64 rows
constexpr int kWgRow = 128;                   // bytes of K a step: one 128-byte swizzle row
constexpr int kWgConsumers = 256;             // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
// 384 threads cap a thread at 168 registers at launch; setmaxnreg then moves
// them from the producer (40 a thread) to the consumers (232): 64,512 of 65,536
constexpr int kWgConsumerRegs = 232, kWgProducerRegs = 40;
constexpr int kWgABytes = kWgM * kWgRow;      // an A slot, an epilogue box, an x_in box: 8 KB
constexpr int kWgASlots = 3;                  // A slots: steps k - 1, k, k + 1
constexpr int kWgMaxStages = 4;               // weight-ring stages at most
constexpr int kWgMaxInStages = 3;             // input stages at most
constexpr int kWgBarBytes = 8 * (2 * kWgMaxInStages + 4 + 2 * kWgMaxStages);
constexpr int kWgXinC = 64;                   // channels of an x_in box: one 128-byte row

// Input channels a K step: one 128-byte row of A (64 bf16 or 128 s8).
__host__ __device__ constexpr int wg_kc(int dot) { return dot == kDotS8 ? 128 : 64; }
// Bytes of a step's input stage: the haloed input box, [8 + 2d][8 + 2d][kc]
// bf16, then the step's depthwise weights, [11][kc] f32 (taps, mid scale, mid
// bias).
__host__ __device__ constexpr int wg_box_bytes(int d, int dot) {
  return (kWgTH + 2 * d) * (kWgTW + 2 * d) * wg_kc(dot) * 2;
}
__host__ __device__ constexpr int wg_in_bytes(int d, int dot) {
  return wg_box_bytes(d, dot) + 11 * wg_kc(dot) * 4;
}
// Bytes of the affines of an item's 2 N channels: the out affine, [2
// warpgroups][2][N] f32, and with the conv skip its affine after it, [2][2][N].
__host__ __device__ constexpr int wg_osb_bytes(int n, int skip) {
  return (skip == kSkipConv ? 32 : 16) * n;
}
// Shared memory besides the weight ring and the input stages: 1 KB of
// alignment slack, three A slots (the epilogue's staging too), two slots of
// the affines, the mbarriers; with a skip two x_in boxes and their four
// mbarriers.
__host__ __device__ constexpr int wg_fixed_bytes(int n, int skip) {
  return 1024 + kWgASlots * kWgABytes + 2 * wg_osb_bytes(n, skip) + kWgBarBytes +
         (skip != kSkipNone ? 2 * kWgABytes + 32 : 0);
}
// Bytes of a weight-ring stage: 2 N rows (both warpgroups' columns) of a step.
__host__ __device__ constexpr int wg_stage_bytes(int n) { return 2 * n * kWgRow; }

struct WgArgs {
  int co, relu;
  int tiles_x;       // 8-column tiles across the image
  int tiles;         // 8 x 8 tiles of an image
  int co_blocks;     // 2 N output channels each
  int items;         // co_blocks x tiles x n: (Co block, tile, image), Co block fastest
  int steps;         // K steps: ceil(c / kc)
  int skip_steps;    // the conv skip's K steps: ceil(cin / 64)
  int stages;        // weight-ring stages
  int in_stages;     // input stages
  int h, w;          // the image
  void* out;         // (n, h, w, co) bf16
};

// Nine taps, the mid affine (and the int8 rounding) of a K step into the A
// slot a: 64 pixel rows of kc channels, K-major, 128-byte swizzled, as wgmma
// reads it. The step's input stage (zeros outside the image and past c, by
// TMA) is the box [8 + 2d][8 + 2d][kc] bf16 from (r0 - d, c0 - d), then the
// step's weights [11][kc] f32. A thread takes 4 channels of a 2 x 2 quad of
// output pixels d apart (rows rb, rb + d, columns cb, cb + d): the 16 input
// pixels it loads, rows rb + m d and columns cb + n d (m, n < 4), each feed
// every tap of the quad that reads them, the ReLU and the bf16 -> f32
// conversion run once per loaded value, and the 16 loads issue before any
// of their uses. 16 quads tile the 8 x 8 pixels for d in {1, 2}. Each
// output's sum runs over (ky, kx) in order, one fmaf a tap, and the affine
// rounds the product and the sum separately: the arithmetic of depthwise().
template <int DOT, int D>
__device__ __forceinline__ void wg_depthwise(const WgArgs& p, const char* stage, char* a) {
#ifdef SEPCONV_WG_NO_TAPS
  if (p.steps > 0) return;  // probe build: the products of whatever A holds
#endif
  constexpr int KC = wg_kc(DOT), kVecs = KC / 4, kQuadStep = kWgConsumers / kVecs;
  const int v = threadIdx.x % kVecs;
  const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(stage);
  float w[9][4], ms[4], mb[4];
  {
    const float* src = reinterpret_cast<const float*>(stage + wg_box_bytes(D, DOT)) + 4 * v;
    float4 t[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) t[i] = *reinterpret_cast<const float4*>(src + i * KC);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      w[i][0] = t[i].x; w[i][1] = t[i].y; w[i][2] = t[i].z; w[i][3] = t[i].w;
    }
    ms[0] = t[9].x; ms[1] = t[9].y; ms[2] = t[9].z; ms[3] = t[9].w;
    mb[0] = t[10].x; mb[1] = t[10].y; mb[2] = t[10].z; mb[3] = t[10].w;
  }
  constexpr int d = D, iw = kWgTW + 2 * D;
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll 1
  for (int quad = threadIdx.x / kVecs; quad < 16; quad += kQuadStep) {
    const int qr = quad / 4, qc = quad % 4;
    const int rb = (qr / d) * 2 * d + qr % d, cb = (qc / d) * 2 * d + qc % d;
    float acc[2][2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[jj][ii][c] = 0.f;
    const __nv_bfloat16* corner = in + (rb * iw + cb) * KC + 4 * v;
    uint2 raw[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        raw[m][n] = *reinterpret_cast<const uint2*>(corner + (m * d * iw + n * d) * KC);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float x[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw[m][n].x);
        __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw[m][n].y);
        if (p.relu) {
          lo = __hmax2(lo, zero2);
          hi = __hmax2(hi, zero2);
        }
        const float2 f0 = __bfloat1622float2(lo), f1 = __bfloat1622float2(hi);
        x[n][0] = f0.x; x[n][1] = f0.y; x[n][2] = f1.x; x[n][3] = f1.y;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int ky = m - jj;  // input row m feeds output row jj through tap row ky
        if (ky < 0 || ky > 2) continue;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[jj][ii][c] = fmaf(x[ii + kx][c], w[ky * 3 + kx][c], acc[jj][ii][c]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int mrow = (rb + jj * d) * kWgTW + cb + ii * d;  // the pixel's row of A
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = __fadd_rn(__fmul_rn(acc[jj][ii][c], ms[c]), mb[c]);
        char* dst = a + mrow * kWgRow;
        if constexpr (DOT == kDotS8) {
          uint32_t packed = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            packed |= (uint32_t(__float2int_rn(fminf(fmaxf(y[c], -127.f), 127.f))) & 0xFFu)
                      << (8 * c);
          *reinterpret_cast<uint32_t*>(dst + ((((v / 4) ^ mrow) & 7) << 4) + (v % 4) * 4) = packed;
        } else {
          *reinterpret_cast<uint2*>(dst + ((((v / 2) ^ mrow) & 7) << 4) + (v % 2) * 8) =
              make_uint2(bf16x2(y[0], y[1]), bf16x2(y[2], y[3]));
        }
      }
  }
}

template <int DOT, int N, int D, int SKIP>
__global__ void __launch_bounds__(kWgThreads, 1)
    sepconv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_dw,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_osb,
                         const __grid_constant__ CUtensorMap map_xin,
                         const __grid_constant__ CUtensorMap map_skw,
                         const __grid_constant__ CUtensorMap map_ska, const WgArgs p) {
  using Acc = typename std::conditional<DOT == kDotS8, int, float>::type;
  constexpr int KC = wg_kc(DOT), kStage = wg_stage_bytes(N), kAccN = N / 2, kBoxes = N / 64;
  constexpr int kIn = wg_in_bytes(D, DOT), kBox = wg_box_bytes(D, DOT);
  constexpr int kOsb = wg_osb_bytes(N, SKIP) / 4;  // floats of an affine slot
#ifdef SEPCONV_WG_NO_SKIP
  constexpr int SK = kSkipNone;  // probe build: a skip plan's layout, its skip left out
#else
  constexpr int SK = SKIP;
#endif
  extern __shared__ char smem_raw[];
  char* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  char* a_sm = ring + p.stages * kStage;
  // a skip's two x_in boxes, 1024-byte aligned for the 128-byte swizzle: the
  // sum skip's one a warpgroup, the conv skip's A tiles a ring of two
  char* x_sm = a_sm + kWgASlots * kWgABytes;
  char* in_sm = x_sm + (SKIP != kSkipNone ? 2 * kWgABytes : 0);
  float* osb_sm = reinterpret_cast<float*>(in_sm + p.in_stages * kIn);
  uint64_t* full_in = reinterpret_cast<uint64_t*>(osb_sm + 2 * kOsb);
  uint64_t* empty_in = full_in + kWgMaxInStages;
  uint64_t* full_osb = empty_in + kWgMaxInStages;
  uint64_t* empty_osb = full_osb + 2;
  uint64_t* full_w = empty_osb + 2;
  uint64_t* empty_w = full_w + kWgMaxStages;
  // the x_in boxes' barriers. Sum: full_x[wg] of the box in the warpgroup's
  // x_in slot, aux_x[wg] of the box in its A slot; conv: the ring's full and
  // empty barriers
  uint64_t* full_x = empty_w + kWgMaxStages;
  uint64_t* aux_x = full_x + 2;
  const int S = p.stages, SI = p.in_stages, steps = p.steps;
  // item it: output channels n0.., pixels (r0.., c0..) of image img
  auto coords = [&](int it, int& n0, int& r0, int& c0, int& img) {
    const int tile = (it / p.co_blocks) % p.tiles;
    n0 = (it % p.co_blocks) * 2 * N;
    r0 = (tile / p.tiles_x) * kWgTH;
    c0 = (tile % p.tiles_x) * kWgTW;
    img = it / (p.co_blocks * p.tiles);
  };
  PROBE(t0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < SI; ++s) {
      mbar_init(&full_in[s], 1);
      mbar_init(&empty_in[s], kWgConsumers / 32);  // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full_osb[s], 1);
      mbar_init(&empty_osb[s], kWgConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_w[s], 1);
      mbar_init(&empty_w[s], kWgConsumers / 32);
    }
    if constexpr (SKIP != kSkipNone) {
      for (int s = 0; s < 2; ++s) {
        mbar_init(&full_x[s], 1);
        mbar_init(&aux_x[s], SKIP == kSkipConv ? kWgConsumers / 32 : 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {  // ---------------------------- producers
    setmaxnreg_dec<kWgProducerRegs>();
    // Two threads issue every load, each stream in the order the consumers
    // take it, running ahead across items as far as its slots allow: the
    // first warp the weight ring (the conv skip's weights after an item's
    // steps) and each item's affines, the second the input stages (haloed
    // box and depthwise weights; then the conv skip's x_in boxes).
    if (threadIdx.x == kWgConsumers) {
      for (int it = blockIdx.x, t = 0, w = 0; it < p.items; it += gridDim.x, ++t) {
        const int n0 = (it % p.co_blocks) * 2 * N;
        const int o = t & 1;
        mbar_wait(&empty_osb[o], ((t >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_osb[o], wg_osb_bytes(N, SK));
        tma_load_3d(osb_sm + o * kOsb, &map_osb, n0, 0, 0, &full_osb[o]);
        tma_load_3d(osb_sm + o * kOsb + 2 * N, &map_osb, n0 + N, 0, 0, &full_osb[o]);
        if constexpr (SK == kSkipConv) {
          tma_load_3d(osb_sm + o * kOsb + 4 * N, &map_ska, n0, 0, 0, &full_osb[o]);
          tma_load_3d(osb_sm + o * kOsb + 6 * N, &map_ska, n0 + N, 0, 0, &full_osb[o]);
        }
        for (int j = 0; j < steps; ++j, ++w) {
          const int s = w % S;
          mbar_wait(&empty_w[s], ((w / S) & 1) ^ 1);
#ifdef SEPCONV_WG_NO_W
          mbar_arrive(&full_w[s]);
#else
          mbar_arrive_expect_tx(&full_w[s], kStage);
          // rows past cop, and columns past cp, arrive as zeros
          tma_load_3d(ring + s * kStage, &map_w, j * KC, n0, 0, &full_w[s]);
          tma_load_3d(ring + s * kStage + N * kWgRow, &map_w, j * KC, n0 + N, 0, &full_w[s]);
#endif
        }
        if constexpr (SK == kSkipConv) {
          for (int j = 0; j < p.skip_steps; ++j, ++w) {  // 2 N rows x 64 bf16 a step
            const int s = w % S;
            mbar_wait(&empty_w[s], ((w / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full_w[s], kStage);
            tma_load_3d(ring + s * kStage, &map_skw, j * kWgXinC, n0, 0, &full_w[s]);
            tma_load_3d(ring + s * kStage + N * kWgRow, &map_skw, j * kWgXinC, n0 + N, 0,
                        &full_w[s]);
          }
        }
      }
    } else if (threadIdx.x == kWgConsumers + 32) {
      [[maybe_unused]] int v = 0;  // conv: x_in boxes issued
      for (int it = blockIdx.x, u = 0; it < p.items; it += gridDim.x) {
        int n0, r0, c0, img;
        coords(it, n0, r0, c0, img);
        for (int j = 0; j < steps; ++j, ++u) {
          const int s = u % SI;
          mbar_wait(&empty_in[s], ((u / SI) & 1) ^ 1);
#ifdef SEPCONV_WG_NO_X
          mbar_arrive_expect_tx(&full_in[s], kIn - kBox);
#else
          mbar_arrive_expect_tx(&full_in[s], kIn);
          tma_load_4d(in_sm + s * kIn, &map_x, j * KC, c0 - D, r0 - D, img, &full_in[s]);
#endif
          tma_load_3d(in_sm + s * kIn + kBox, &map_dw, j * KC, 0, 0, &full_in[s]);
        }
        if constexpr (SK == kSkipConv) {
          for (int j = 0; j < p.skip_steps; ++j, ++v) {  // 64 channels of the item's pixels
            const int s = v % 2;
            mbar_wait(&aux_x[s], ((v / 2) & 1) ^ 1);
            mbar_arrive_expect_tx(&full_x[s], kWgABytes);
            tma_load_4d(x_sm + s * kWgABytes, &map_xin, j * kWgXinC, c0, r0, img, &full_x[s]);
          }
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<kWgConsumerRegs>();
  // the warpgroup, uniform over its warps for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, wt = threadIdx.x % 128;
  const int g = lane / 4, q = lane % 4, row = (wt / 32) * 16 + g;
  Acc acc[kAccN];
#pragma unroll
  for (int i = 0; i < kAccN; ++i) acc[i] = Acc(0);
  fence_regs(acc);
#ifdef SEPCONV_PROFILE
  long long taps_cycles = 0, wait_cycles = 0, in_cycles = 0, sync_cycles = 0, epi_cycles = 0;
  int n_items = 0;
#endif
  int u = 0, w = 0;  // input stages and ring stages taken, as the producers count them
  // x_in boxes waited on: sum, those in the warpgroup's x_in slot and in its
  // A slot; conv, those of the ring
  [[maybe_unused]] int xs = 0, xa = 0;
  char* const a_own = a_sm + wg * kWgABytes;  // the warpgroup's A slot: its epilogue's staging
  char* const x_own = x_sm + wg * kWgABytes;  // sum: its x_in slot
  // sum: one thread loads the x_in box of the item's channels n0 + ch.. into
  // dst: 64 channels at 8 x 8 pixels, 128-byte swizzled as the staging is
  auto load_xin = [&](char* dst, uint64_t* bar, int it, int ch) {
    int n0, r0, c0, img;
    coords(it, n0, r0, c0, img);
    mbar_arrive_expect_tx(bar, kWgABytes);
    tma_load_4d(dst, &map_xin, n0 + ch, c0, r0, img, bar);
  };
  if constexpr (SK == kSkipSum) {
    if (wt == 0) load_xin(x_own, &full_x[wg], blockIdx.x, wg * N);
  }
  // input stage u's taps into A slot u % 3, then both warpgroups meet: the
  // slot is complete and visible to wgmma. The slot last held step u - 3,
  // whose products both warpgroups waited on before the barrier that closed
  // step u - 1's taps (or, across items, before the epilogue).
  auto taps = [&]() {
    PROBE(ta);
    const int s = u % SI;
    mbar_wait(&full_in[s], (u / SI) & 1);
    PROBE(tw);
    wg_depthwise<DOT, D>(p, in_sm + s * kIn, a_sm + (u % kWgASlots) * kWgABytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_in[s]);
    fence_proxy_async();
    PROBE(tc);
    named_sync(1, kWgConsumers);
    PROBE(tb);
#ifdef SEPCONV_PROFILE
    taps_cycles += tb - ta;
    in_cycles += tw - ta;
    sync_cycles += tb - tc;
#endif
    ++u;
  };
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int it = blockIdx.x, t = 0; it < p.items; it += gridDim.x, ++t) {
    int n0, r0, c0, img;
    coords(it, n0, r0, c0, img);
    taps();
    for (int k = 0; k < steps; ++k, ++w) {
      const int s = w % S;
      PROBE(wa);
      mbar_wait(&full_w[s], (w / S) & 1);
      PROBE(wb);
#ifdef SEPCONV_PROFILE
      wait_cycles += wb - wa;
#endif
      const char* a = a_sm + ((u - 1) % kWgASlots) * kWgABytes;  // step k's taps: the last taken
      const char* b = ring + s * kStage + wg * N * kWgRow;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of K a product; the item's first sets d
        const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
        const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
        const int keep = k > 0 || kk > 0;
#ifndef SEPCONV_WG_NO_MMA
        if constexpr (DOT == kDotS8) {
          WgmmaS8<N>::ss(acc, da, db, keep);
        } else {
          Wgmma<N>::template ss<0>(acc, da, db, keep);
        }
#endif
      }
      wgmma_commit();
      if (k > 0) {
        // this warpgroup's step k - 1 products are done: its ring stage is
        // free once all 8 consumer warps arrive; step k's products run on the
        // tensor cores while step k + 1's taps run here (into step k - 2's A
        // slot: the other warpgroup may still read step k - 1's)
        PROBE(wc);
        wgmma_wait<1>();
        PROBE(wd);
#ifdef SEPCONV_PROFILE
        wait_cycles += wd - wc;
#endif
        if (lane == 0) mbar_arrive(&empty_w[(w - 1) % S]);
      }
      if (k + 1 < steps) taps();
    }
    PROBE(we);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty_w[(w - 1) % S]);
    // both warpgroups' products are done: the A slots are free for the staging
    named_sync(1, kWgConsumers);
    PROBE(t1);

    // The conv skip: a second chain of ceil(cin / 64) steps, m64nNk16 bf16
    // products into f32 sums, A the x_in box of the item's pixels (a K-major
    // tile as TMA swizzles it) from the ring of two, B the step's 2 N rows of
    // skw from the weight ring. The first product writes the sums only, so
    // that they hold no registers outside the epilogue.
    [[maybe_unused]] float sk[kAccN];
    if constexpr (SK == kSkipConv) {
      auto skip_step = [&](auto first) {
        const int s = w % S, x = xs % 2;
        mbar_wait(&full_w[s], (w / S) & 1);
        mbar_wait(&full_x[x], (xs / 2) & 1);
        const char* a = x_sm + x * kWgABytes;
        const char* b = ring + s * kStage + wg * N * kWgRow;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
          const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
          if (decltype(first)::value && kk == 0)
            Wgmma<N>::ss0(sk, da, db);
          else
            Wgmma<N>::template ss<0>(sk, da, db, 1);
        }
        wgmma_commit();
        if constexpr (!decltype(first)::value) {
          wgmma_wait<1>();  // the step before's products: its stage and box are free
          if (lane == 0) {
            mbar_arrive(&empty_w[(w - 1) % S]);
            mbar_arrive(&aux_x[(xs - 1) % 2]);
          }
        }
        ++w;
        ++xs;
      };
      skip_step(std::true_type{});
      for (int j = 1; j < p.skip_steps; ++j) skip_step(std::false_type{});
      wgmma_wait<0>();
      fence_regs(sk);
      if (lane == 0) {
        mbar_arrive(&empty_w[(w - 1) % S]);
        mbar_arrive(&aux_x[(xs - 1) % 2]);
      }
    }

    // Epilogue: the out affine, with the conv skip's product times its affine
    // or x_in added (in _sepconv_plain's order, one rounding to bf16), a box
    // of [64 pixels][64 channels] at a time through the warpgroup's A slot
    // (128-byte swizzled: conflict-free stores of the fragment), then out in
    // 16-byte vectors, a pixel's 128 bytes by 8 neighbouring lanes, masked at
    // the image's and Co's ends. The sum skip's x_in box has the staging's
    // layout: a thread reads its pairs of x_in where it then writes their
    // results. Its boxes take turns in the warpgroup's x_in slot (even) and
    // A slot (odd); box bx + 1 is loaded while box bx is worked, and an
    // item's first box during the item's K steps.
    const int o = t & 1;
    mbar_wait(&full_osb[o], (t >> 1) & 1);
    const float* scale = osb_sm + o * kOsb + wg * 2 * N;  // [2][N]: scale, bias; zeros past cop
    [[maybe_unused]] const float* sk_scale = scale + 4 * N;  // conv: [2][N] the skip's affine
    const int col0 = n0 + wg * N;
#pragma unroll
    for (int bx = 0; bx < kBoxes; ++bx) {
      if (bx > 0) named_sync(2 + wg, 128);  // the box before has been read out
      char* box = a_own;
      if constexpr (SK == kSkipSum) {
        if (wt == 0 && bx + 1 < kBoxes)  // into the slot box bx - 1 has left
          load_xin((bx + 1) % 2 ? a_own : x_own, (bx + 1) % 2 ? &aux_x[wg] : &full_x[wg], it,
                   wg * N + 64 * (bx + 1));
        if (bx % 2) {
          box = a_own;
          mbar_wait(&aux_x[wg], xa & 1);
          ++xa;
        } else {
          box = x_own;
          mbar_wait(&full_x[wg], xs & 1);
          ++xs;
        }
      }
#pragma unroll
      for (int j = 8 * bx; j < 8 * bx + 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * j + 2 * q);
        const float2 bi = *reinterpret_cast<const float2*>(scale + N + 8 * j + 2 * q);
        // multiply and add rounded separately, as the plain version does
        float v00 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j]), sc.x), bi.x);
        float v01 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 1]), sc.y), bi.y);
        float v10 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2]), sc.x), bi.x);
        float v11 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 3]), sc.y), bi.y);
        const int off = (((j % 8) ^ g) << 4) + 4 * q;  // rows row and row + 8 share row % 8 = g
        uint32_t* p0 = reinterpret_cast<uint32_t*>(box + row * kWgRow + off);
        uint32_t* p1 = reinterpret_cast<uint32_t*>(box + (row + 8) * kWgRow + off);
        if constexpr (SK == kSkipConv) {
          const float2 ks = *reinterpret_cast<const float2*>(sk_scale + 8 * j + 2 * q);
          const float2 kb = *reinterpret_cast<const float2*>(sk_scale + N + 8 * j + 2 * q);
          v00 = __fadd_rn(__fadd_rn(v00, __fmul_rn(sk[4 * j], ks.x)), kb.x);
          v01 = __fadd_rn(__fadd_rn(v01, __fmul_rn(sk[4 * j + 1], ks.y)), kb.y);
          v10 = __fadd_rn(__fadd_rn(v10, __fmul_rn(sk[4 * j + 2], ks.x)), kb.x);
          v11 = __fadd_rn(__fadd_rn(v11, __fmul_rn(sk[4 * j + 3], ks.y)), kb.y);
        } else if constexpr (SK == kSkipSum) {
          const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p0));
          const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p1));
          v00 = __fadd_rn(v00, x0.x);
          v01 = __fadd_rn(v01, x0.y);
          v10 = __fadd_rn(v10, x1.x);
          v11 = __fadd_rn(v11, x1.y);
        }
        *p0 = bf16x2(v00, v01);
        *p1 = bf16x2(v10, v11);
      }
      if constexpr (SK == kSkipSum) fence_proxy_async();  // TMA writes the slot next
      named_sync(2 + wg, 128);
      const int ch = col0 + 64 * bx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = i * 16 + wt / 8, c8 = wt % 8;  // pixel, 16-byte chunk
        const int r = r0 + m / kWgTW, c = c0 + m % kWgTW;
        const uint4 v = *reinterpret_cast<const uint4*>(box + m * kWgRow + (((c8 ^ m) & 7) << 4));
        if (r < p.h && c < p.w && ch + 8 * c8 < p.co)  // co % 8 == 0: a chunk is in or out
          *reinterpret_cast<uint4*>(out + ((size_t(img) * p.h + r) * p.w + c) * p.co + ch +
                                    8 * c8) = v;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_osb[o]);
    // the staging is read out before the next item's taps write the A slots
    named_sync(1, kWgConsumers);
    if constexpr (SK == kSkipSum) {  // the next item's first x_in box, under its K steps
      if (wt == 0 && it + int(gridDim.x) < p.items)
        load_xin(x_own, &full_x[wg], it + gridDim.x, wg * N);
    }
    PROBE(t2);
#ifdef SEPCONV_PROFILE
    wait_cycles += t1 - we;
    epi_cycles += t2 - t1;
    ++n_items;
#endif
  }
  PROBE(t3);
#ifdef SEPCONV_PROFILE
  PROBE_WG_ADD(0, 0, taps_cycles);
  PROBE_WG_ADD(1, 0, wait_cycles);
  PROBE_WG_ADD(2, 0, epi_cycles);
  PROBE_WG_ADD(3, t0, t3);
  PROBE_WG_ADD(4, 0, n_items);
  PROBE_WG_ADD(5, 0, in_cycles);
  PROBE_WG_ADD(6, 0, sync_cycles);
#endif
}

// ------------------------------------------------------------------ host
constexpr int kMaxSmem = 227 * 1024;  // 232,448 bytes a block

enum KernelId { kRecompute = 0, kResident = 1, kWgmmaKernel = 2 };

// The host's choice for a call (sepconv_plan reports it; ops/sepconv.py's
// sepconv_plan mirrors it).
struct Plan {
  int kernel;             // KernelId
  int tile_h, tile_w;     // output pixels of a block (the wgmma kernel: of an item)
  // the older kernels: blocks over Co, pixel tiles, images; the wgmma kernel:
  // persistent blocks, at most one an SM, walking the items
  int grid_x, grid_y, grid_z;
  int co_split;           // blocks (items) a pixel tile's output channels take
  int co_block;           // output channels a block (an item)
  int n_wg;               // wgmma kernel: output channels a consumer warpgroup
  int stages;             // wgmma kernel: weight-ring stages
  int in_stages;          // wgmma kernel: input stages
  int smem;               // dynamic shared memory, bytes
};

// The older kernels' routes: the resident kernel where the depthwise result of all
// channels fits (tensor-core products), else the recompute kernel.
template <typename T, int DOT>
int old_plan(const Args& p, int sms, Plan& pl) {
  const int tiles = p.tiles_x * ((p.ho + kTH - 1) / kTH);
  if (tiles > 65535 || p.n > 65535) return -1;
  const int co_tiles = p.cop / kNT;
  pl = Plan{};
  pl.tile_h = kTH;
  pl.tile_w = kTW;
  pl.grid_y = tiles;
  pl.grid_z = p.n;
  if constexpr (!(std::is_same<T, float>::value && DOT == kDotNative)) {
    using R = Resident<T, DOT>;
    size_t smem = R::a_bytes(p.cp) + R::stage_bytes(p.ih, p.iw);
    if (p.skip == kSkipConv) smem += Smem<T, DOT>::kStash;
    if (smem <= size_t(kMaxSmem) && p.c % (16 / sizeof(T)) == 0) {
      // enough blocks to fill the card: split the Co tiles where pixel
      // tiles alone are fewer than the SMs
      int split = sms / (tiles * p.n);  // rounded down: a second wave costs a whole phase 1
      if (split < 1) split = 1;
      if (split > co_tiles) split = co_tiles;
      const int per = (co_tiles + split - 1) / split;
      pl.kernel = kResident;
      pl.grid_x = pl.co_split = (co_tiles + per - 1) / per;
      pl.co_block = per * kNT;
      pl.smem = static_cast<int>(smem);
      return 0;
    }
  }
  size_t smem = Smem<T, DOT>::kA + Smem<T, DOT>::kB +
                (size_t(p.ih) * p.iw * kKC * sizeof(T) + 15) / 16 * 16;
  if (p.skip == kSkipConv) smem += Smem<T, DOT>::kStash;
  if (smem > size_t(kMaxSmem)) return -2;  // the haloed tile does not fit: dilation too large
  pl.kernel = kRecompute;
  pl.grid_x = pl.co_split = co_tiles;
  pl.co_block = kNT;
  pl.smem = static_cast<int>(smem);
  return 0;
}

// The wgmma kernel takes bf16 I/O at stride 1, dilation 1 or 2 (the
// flagship's fused layers), without skip, with the sum skip or with the conv
// skip, C, Co and Cin multiples of 8 (16-byte TMA strides), where two weight
// stages fit beside the rest; everything else (stride 2, f32) keeps the older
// kernels' routes. 192 output channels a warpgroup where they tile the padded
// Co by twos (768 = 2 x 384), else 128; one persistent block an SM.
int make_plan(const Args& p, int bf16, int s8, int sms, Plan& pl) {
  if (bf16 && p.stride == 1 && (p.d == 1 || p.d == 2) && p.c % 8 == 0 && p.co % 8 == 0 &&
      (p.skip != kSkipConv || p.cin % 8 == 0)) {
    const int dot = s8 ? kDotS8 : kDotNative;
    const int n_wg = p.cop % 384 == 0 ? 192 : 128;
    // two input stages, as many weight stages as fit (up to 4), then a third
    // input stage where it fits
    const int in_b = wg_in_bytes(p.d, dot), stage_b = wg_stage_bytes(n_wg);
    const int fixed = wg_fixed_bytes(n_wg, p.skip) + 2 * in_b;
    int stages = (kMaxSmem - fixed) / stage_b;
    if (stages > kWgMaxStages) stages = kWgMaxStages;
    const int in_stages = kMaxSmem - fixed - stages * stage_b >= in_b ? 3 : 2;
    const long long co_blocks = (p.cop + 2 * n_wg - 1) / (2 * n_wg);
    const long long items = co_blocks * ((p.h + kWgTH - 1) / kWgTH) *
                            ((p.w + kWgTW - 1) / kWgTW) * p.n;
    if (stages >= 2 && items < (1ll << 31)) {
      pl = Plan{kWgmmaKernel, kWgTH, kWgTW, static_cast<int>(items < sms ? items : sms), 1, 1,
                static_cast<int>(co_blocks), 2 * n_wg, n_wg, stages, in_stages,
                fixed + stages * stage_b + (in_stages - 2) * in_b};
      return 0;
    }
  }
  if (bf16) return s8 ? old_plan<__nv_bfloat16, kDotS8>(p, sms, pl)
                      : old_plan<__nv_bfloat16, kDotNative>(p, sms, pl);
  return s8 ? old_plan<float, kDotS8>(p, sms, pl) : old_plan<float, kDotNative>(p, sms, pl);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename K>
int launch_kernel(K kernel, const Args& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DOT>
int launch_old(Args p, const Plan& pl, cudaStream_t stream) {
  const dim3 grid(pl.grid_x, pl.grid_y, pl.grid_z);
  if constexpr (!(std::is_same<T, float>::value && DOT == kDotNative)) {
    if (pl.kernel == kResident) {
      p.co_tiles_per_block = pl.co_block / kNT;
      return launch_kernel(sepconv_resident_kernel<T, DOT>, p, grid, pl.smem, stream);
    }
  }
  return launch_kernel(sepconv_kernel<T, DOT>, p, grid, pl.smem, stream);
}

// A tensor map of a contiguous array, boxes of `box`, zeros past every edge.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  auto fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DOT, int N, int D, int SKIP>
int launch_wgmma(const Args& a, const Plan& pl, cudaStream_t stream) {
  constexpr int KC = wg_kc(DOT);
  const int tiles_x = (a.w + kWgTW - 1) / kWgTW, tiles = tiles_x * ((a.h + kWgTH - 1) / kWgTH);
  const WgArgs p{a.co, a.relu, tiles_x, tiles, pl.co_split, pl.co_split * tiles * a.n,
                 (a.c + KC - 1) / KC, (a.cin + kWgXinC - 1) / kWgXinC, pl.stages, pl.in_stages,
                 a.h, a.w, a.out};
  CUtensorMap map_x{}, map_dw{}, map_w{}, map_osb{}, map_xin{}, map_skw{}, map_ska{};
  const cuuint64_t n = a.n, h = a.h, w = a.w, c = a.c;
  const cuuint64_t es = DOT == kDotS8 ? 1 : 2;  // bytes of a packed weight
  // x (n, h, w, c): boxes of KC channels x (8 + 2d) x (8 + 2d) pixels
  const cuuint64_t x_dims[4] = {c, w, h, n}, x_strides[3] = {c * 2, w * c * 2, h * w * c * 2};
  const cuuint32_t x_box[4] = {cuuint32_t(KC), cuuint32_t(kWgTW + 2 * a.d),
                               cuuint32_t(kWgTH + 2 * a.d), 1};
  // packed weights (cop, cp): boxes of N rows x 128 bytes, swizzled for wgmma
  const cuuint64_t w_dims[3] = {cuuint64_t(a.cp), cuuint64_t(a.cop), 1};
  const cuuint64_t w_strides[2] = {cuuint64_t(a.cp) * es, cuuint64_t(a.cp) * a.cop * es};
  const cuuint32_t w_box[3] = {cuuint32_t(KC), cuuint32_t(N), 1};
  // depthwise weights (11, cp) and out affine (2, cop), f32: boxes of a step's
  // KC channels, and of N channels; the conv skip's affine (2, cop) likewise
  const cuuint64_t dw_dims[3] = {cuuint64_t(a.cp), 11, 1}, osb_dims[3] = {cuuint64_t(a.cop), 2, 1};
  const cuuint64_t dw_strides[2] = {cuuint64_t(a.cp) * 4, cuuint64_t(a.cp) * 44};
  const cuuint64_t osb_strides[2] = {cuuint64_t(a.cop) * 4, cuuint64_t(a.cop) * 8};
  const cuuint32_t dw_box[3] = {cuuint32_t(KC), 11, 1}, osb_box[3] = {cuuint32_t(N), 2, 1};
  // x_in (n, h, w, co) of the sum skip, (n, h, w, cin) of the conv skip:
  // boxes of 64 channels x 8 x 8 pixels, 128-byte swizzled (the epilogue's
  // staging box; a K-major A tile)
  const cuuint64_t xc = SKIP == kSkipSum ? a.co : a.cin;
  const cuuint64_t xin_dims[4] = {xc, w, h, n};
  const cuuint64_t xin_strides[3] = {xc * 2, w * xc * 2, h * w * xc * 2};
  const cuuint32_t xin_box[4] = {kWgXinC, kWgTW, kWgTH, 1};
  // packed conv-skip weights (cop, cinp) bf16: boxes of N rows x 64 channels
  const cuuint64_t skw_dims[3] = {cuuint64_t(a.cinp), cuuint64_t(a.cop), 1};
  const cuuint64_t skw_strides[2] = {cuuint64_t(a.cinp) * 2, cuuint64_t(a.cinp) * a.cop * 2};
  const cuuint32_t skw_box[3] = {kWgXinC, cuuint32_t(N), 1};
  if (!encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.x, x_dims, x_strides, x_box,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&map_dw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.dwp, dw_dims, dw_strides, dw_box,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&map_osb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.osb, osb_dims, osb_strides,
              osb_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&map_w, DOT == kDotS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              3, a.pw, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (SKIP != kSkipNone &&
       !encode(&map_xin, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.xin, xin_dims, xin_strides,
               xin_box, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (SKIP == kSkipConv &&
       (!encode(&map_skw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.skw, skw_dims, skw_strides,
                skw_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode(&map_ska, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.ska, osb_dims, osb_strides,
                osb_box, CU_TENSOR_MAP_SWIZZLE_NONE))))
    return -3;
  auto kernel = sepconv_wgmma_kernel<DOT, N, D, SKIP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(pl.grid_x, pl.grid_y, pl.grid_z), kWgThreads, pl.smem, stream>>>(
      map_x, map_dw, map_w, map_osb, map_xin, map_skw, map_ska, p);
  return static_cast<int>(cudaGetLastError());
}

template <int DOT, int N, int SKIP>
int launch_wgmma_d(const Args& p, const Plan& pl, cudaStream_t s) {
  return p.d == 1 ? launch_wgmma<DOT, N, 1, SKIP>(p, pl, s)
                  : launch_wgmma<DOT, N, 2, SKIP>(p, pl, s);
}
template <int SKIP>
int launch_wgmma_n(const Args& p, const Plan& pl, int s8, cudaStream_t s) {
  if (s8) return pl.n_wg == 192 ? launch_wgmma_d<kDotS8, 192, SKIP>(p, pl, s)
                                : launch_wgmma_d<kDotS8, 128, SKIP>(p, pl, s);
  return pl.n_wg == 192 ? launch_wgmma_d<kDotNative, 192, SKIP>(p, pl, s)
                        : launch_wgmma_d<kDotNative, 128, SKIP>(p, pl, s);
}
int launch_wgmma_route(const Args& p, const Plan& pl, int s8, cudaStream_t s) {
  if (p.skip == kSkipSum) return launch_wgmma_n<kSkipSum>(p, pl, s8, s);
  if (p.skip == kSkipConv) return launch_wgmma_n<kSkipConv>(p, pl, s8, s);
  return launch_wgmma_n<kSkipNone>(p, pl, s8, s);
}

// The arguments of a call, checked; -1 for those no kernel takes.
int make_args(Args& p, const void* x, const void* xin, void* out, const void* dwp,
              const void* pw, const void* osb, const void* skw, const void* ska, int n, int h,
              int w, int c, int co, int cin, int d, int stride, int relu, int skip) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || co < 1 || d < 1 || (stride != 1 && stride != 2) ||
      skip < 0 || skip > 2 || (skip == kSkipConv && cin < 1) || (skip == kSkipSum && stride != 1))
    return -1;
  p.x = x; p.xin = xin; p.out = out;
  p.dwp = static_cast<const float*>(dwp);
  p.pw = pw;
  p.osb = static_cast<const float*>(osb);
  p.skw = skw;
  p.ska = static_cast<const float*>(ska);
  p.n = n; p.h = h; p.w = w; p.c = c; p.co = co; p.cin = cin;
  p.ho = (h - 1) / stride + 1; p.wo = (w - 1) / stride + 1;
  p.d = d; p.stride = stride; p.relu = relu; p.skip = skip;
  p.cp = (c + kKC - 1) / kKC * kKC; p.cop = (co + kNT - 1) / kNT * kNT;
  p.cinp = skip == kSkipConv ? (cin + kKC - 1) / kKC * kKC : 0;
  p.tiles_x = (p.wo + kTW - 1) / kTW;
  p.ih = (kTH - 1) * stride + 1 + 2 * d;
  p.iw = (kTW - 1) * stride + 1 + 2 * d;
  p.co_tiles_per_block = 1;
  return 0;
}

}  // namespace

extern "C" {

#ifdef SEPCONV_PROFILE
// reset != 0: zero the cycle counts; else copy them to ``out``: the resident
// kernel's four (taps, phase 2, of which epilogue, blocks), then the wgmma
// kernel's seven (taps, waits on products, epilogue, all, blocks, the taps'
// waits for their input, the taps' closing barrier).
int sepconv_probe(unsigned long long* out, int reset) {
  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  if (reset) {
    cudaError_t err = cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_cycles_wg, zero, sizeof(g_cycles_wg));
    return static_cast<int>(err);
  }
  cudaError_t err = cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out + 4, g_cycles_wg, sizeof(g_cycles_wg));
  return static_cast<int>(err);
}
#endif

// Padded sizes the packed buffers must have: channels in (c, cin) to a
// multiple of 32, channels out to a multiple of 128.
int sepconv_pad_in(int c) { return (c + kKC - 1) / kKC * kKC; }
int sepconv_pad_out(int co) { return (co + kNT - 1) / kNT * kNT; }

// The host's choice for a call of these shapes (sms <= 0: the current
// device's SM count): out[0] kernel (0 recompute, 1 resident, 2 wgmma),
// [1] [2] tile rows and columns, [3] [4] [5] grid, [6] Co split, [7] output
// channels a block (an item), [8] wgmma N a warpgroup, [9] weight stages,
// [10] input stages, [11] shared memory bytes. Returns what sepconv_launch
// would return before launching: 0, -1 or -2.
int sepconv_plan(int n, int h, int w, int c, int co, int cin, int d, int stride, int relu,
                 int skip, int bf16, int int8_dot, int sms, int* out) {
  Args p;
  int rc = make_args(p, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     n, h, w, c, co, cin, d, stride, relu, skip);
  Plan pl{};
  if (rc == 0) rc = make_plan(p, bf16, int8_dot, sms > 0 ? sms : sm_count(), pl);
  const int v[12] = {pl.kernel,   pl.tile_h,   pl.tile_w, pl.grid_x, pl.grid_y,    pl.grid_z,
                     pl.co_split, pl.co_block, pl.n_wg,   pl.stages, pl.in_stages, pl.smem};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return rc;
}

// x (n,h,w,c) -> out (n,ho,wo,co) with ho = (h-1)/stride+1, wo likewise.
// skip: 0 none, 1 conv (xin (n,h,w,cin), skw, ska), 2 sum (xin like out).
// bf16 != 0: bfloat16 I/O, else f32; int8_dot != 0: pw is s8 and the depthwise
// result is rounded to s8. Returns the CUDA error of the launch, -1 for
// arguments the kernel does not take, -2 when the haloed tile exceeds shared
// memory, -3 when a TMA tensor map cannot be made.
int sepconv_launch(const void* x, const void* xin, void* out, const void* dwp,
                   const void* pw, const void* osb, const void* skw, const void* ska,
                   int n, int h, int w, int c, int co, int cin, int d, int stride,
                   int relu, int skip, int bf16, int int8_dot, void* stream) {
  Args p;
  int rc = make_args(p, x, xin, out, dwp, pw, osb, skw, ska, n, h, w, c, co, cin, d, stride,
                     relu, skip);
  if (rc != 0) return rc;
  Plan pl;
  rc = make_plan(p, bf16, int8_dot, sm_count(), pl);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.kernel == kWgmmaKernel) return launch_wgmma_route(p, pl, int8_dot, s);
  if (bf16) return int8_dot ? launch_old<__nv_bfloat16, kDotS8>(p, pl, s)
                            : launch_old<__nv_bfloat16, kDotNative>(p, pl, s);
  return int8_dot ? launch_old<float, kDotS8>(p, pl, s) : launch_old<float, kDotNative>(p, pl, s);
}

}  // extern "C"
