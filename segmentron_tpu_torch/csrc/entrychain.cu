// Xception-65 entry chain as two hand-written Hopper kernels (sm_90a).
//
//   entry_stem         image (N,H,W,3) -> conv1 3x3 s2 +BN+ReLU -> conv2 3x3 s1
//                      +BN+ReLU -> (N,H/2,W/2,64)
//   entry_stem_block1  the stem, then block1: three separable convs
//                      64->128->128->128 (dw3x3 +BN, pw1x1 +BN, no ReLU, the
//                      last dw stride 2) plus the 1x1 s2 conv skip +BN on the
//                      conv2 output, summed -> (N,H/4,W/4,128)
//
// Replaces segmentron_tpu/ops/entrychain.py::_stem_kernel (fused_stem) and
// ::_stem_block1_kernel (fused_stem_block1). Inference only, BN folded on the
// host into per-channel affines (y = a*x + b).
//
// Bound on an H100: stem+block1 at 1024x2048 does ~27.3 G MAC per image and
// moves ~46 MB (bf16), so it is bound by operations; the stem alone (~10.1 G
// MAC, ~80 MB) is bound by bytes. Design: one thread block per output tile
// builds the tile's receptive field stage by stage in shared memory (image
// patch -> conv1 -> conv2 -> sep1 -> sep2 -> sep3 + skip), recomputing the
// halos, so no intermediate touches device memory. In bf16 the convs that
// are matrix products (conv1 through an im2col copy, conv2 as an implicit
// im2col GEMM, the pointwise convs, the skip) run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), A fragments gathered from
// shared memory with ldmatrix; the depthwise convs are f32 FMA on the CUDA
// cores. In f32 every stage is f32 FMA. Stages are stored in the I/O type, at
// the same rounding points as the plain PyTorch version. What bounds this
// version is not the tensor cores: the stages of a tile run one after the
// other between barriers, each short and latency-bound, and conv2 computes
// 2.1x its useful pixels (halos of a 4 x 8 output tile).
//
// Zero padding: every stage's values at positions outside the image are set
// to 0 before the next 3x3 reads them (rows and columns, both edges).
//
// C interface: each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Packed f32 parameter buffer, in this order (ops/entrychain.py::_pack):
// conv weights HWIO, depthwise (3,3,C), pointwise (Cin,Cout), affines (C,).
// Conv weights hold values of the I/O type.
constexpr int kK1 = 0;              // conv1 (3,3,3,32)
constexpr int kA1 = kK1 + 864;
constexpr int kB1 = kA1 + 32;
constexpr int kK2 = kB1 + 32;       // conv2 (3,3,32,64)
constexpr int kA2 = kK2 + 18432;
constexpr int kB2 = kA2 + 64;
constexpr int kStemEnd = kB2 + 64;
constexpr int kDW1 = kStemEnd;      // sep1 dw (3,3,64)
constexpr int kAD1 = kDW1 + 576;
constexpr int kBD1 = kAD1 + 64;
constexpr int kPW1 = kBD1 + 64;     // sep1 pw (64,128)
constexpr int kAP1 = kPW1 + 8192;
constexpr int kBP1 = kAP1 + 128;
constexpr int kDW2 = kBP1 + 128;    // sep2 dw (3,3,128)
constexpr int kAD2 = kDW2 + 1152;
constexpr int kBD2 = kAD2 + 128;
constexpr int kPW2 = kBD2 + 128;    // sep2 pw (128,128)
constexpr int kAP2 = kPW2 + 16384;
constexpr int kBP2 = kAP2 + 128;
constexpr int kDW3 = kBP2 + 128;    // sep3 dw (3,3,128), stride 2
constexpr int kAD3 = kDW3 + 1152;
constexpr int kBD3 = kAD3 + 128;
constexpr int kPW3 = kBD3 + 128;    // sep3 pw (128,128)
constexpr int kAP3 = kPW3 + 16384;
constexpr int kBP3 = kAP3 + 128;
constexpr int kWSK = kBP3 + 128;    // skip (64,128), stride 2
constexpr int kAS = kWSK + 8192;
constexpr int kBS = kAS + 128;
constexpr int kBlock1End = kBS + 128;

// Shared-memory stages are HWC with each pixel's C channels padded to C + 8
// elements: 16-byte aligned rows for ldmatrix, and consecutive pixels land on
// different bank groups.
template <int C> constexpr int kLd = C + 8;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T (the cast the plain version makes between stages)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  const T t = cvt<T>(v);
  return ld(&t);
}

// Copy the image rows [r0, r0+PH) x cols [c0, c0+PW) of image n into
// shared memory (HWC, 3 channels unpadded), zero outside the image
// (conv1's padding). Each thread issues all its loads before its first
// store, so their latencies overlap.
template <int PH, int PW, typename T>
__device__ void load_patch(const T* __restrict__ x, int H, int W, int n, int r0,
                           int c0, T* dst) {
  constexpr int kTotal = PH * PW * 3;
  constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  T v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int p = i / 3, ch = i - p * 3;
    const int r = r0 + p / PW, c = c0 + p % PW;
    v[j] = (i < kTotal && r >= 0 && r < H && c >= 0 && c < W)
               ? x[((size_t(n) * H + r) * W + c) * 3 + ch]
               : cvt<T>(0.f);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kTotal) dst[i] = v[j];
  }
}

// ------------------------------------------------------------ CUDA cores
// out[p][oc] = sum over (dy, dx, ci) of in[(r*S+dy)*in_w + c*S+dx][ci] *
// w[dy][dx][ci][oc], for the out_h x out_w pixels p = r*out_w + c of a tile in
// shared memory (pixel stride LDI). Each thread owns PT pixels and 4
// consecutive output channels and hands its f32 sums to epi(p, oc, v, 4).
template <int CI, int OC, int KS, int S, int LDI, int PT, typename T, typename Epi>
__device__ void fma_stage(const T* in, int in_w, int out_h, int out_w,
                          const float* __restrict__ w, const Epi& epi) {
  constexpr int kLanes = OC / 4;
  constexpr int kGroups = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int P = out_h * out_w;
  for (int p0 = grp * PT; p0 < P; p0 += kGroups * PT) {
    int base[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = min(p0 + i, P - 1);
      const int r = p / out_w, c = p - r * out_w;
      base[i] = (r * S * in_w + c * S) * LDI;
    }
    float acc[PT][4];
#pragma unroll
    for (int i = 0; i < PT; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int dy = 0; dy < KS; ++dy) {
      for (int dx = 0; dx < KS; ++dx) {
        const float* wp = w + (dy * KS + dx) * CI * OC + lane * 4;
        const int off = (dy * in_w + dx) * LDI;
#pragma unroll 4
        for (int ci = 0; ci < CI; ++ci) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(wp + ci * OC));
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const float v = ld(in + base[i] + off + ci);
            acc[i][0] = fmaf(v, wv.x, acc[i][0]);
            acc[i][1] = fmaf(v, wv.y, acc[i][1]);
            acc[i][2] = fmaf(v, wv.z, acc[i][2]);
            acc[i][3] = fmaf(v, wv.w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i)
      if (p0 + i < P) epi(p0 + i, lane * 4, acc[i], 4);
  }
}

// Depthwise 3x3 (stride S) + affine, rounded to T, two channels a thread:
// out[p][ch] for the out_h x out_w pixels of a tile in shared memory, both
// with pixel stride kLd<C>. A thread's channel pair is the same for all its
// pixels (kThreads is a multiple of C/2), so its taps stay in registers.
template <int C, int S, typename T>
__device__ void dw_stage(const T* in, int in_w, int out_h, int out_w,
                         const float* __restrict__ w, const float* __restrict__ a,
                         const float* __restrict__ b, T* out) {
  constexpr int LD = kLd<C>;
  constexpr int C2 = C / 2;
  static_assert(kThreads % C2 == 0, "a thread keeps one channel pair");
  const int ch = (threadIdx.x % C2) * 2;
  float2 k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = __ldg(reinterpret_cast<const float2*>(w + t * C + ch));
  const float2 sa = __ldg(reinterpret_cast<const float2*>(a + ch));
  const float2 sb = __ldg(reinterpret_cast<const float2*>(b + ch));
  const int P = out_h * out_w;
  for (int p = threadIdx.x / C2; p < P; p += kThreads / C2) {
    const int r = p / out_w, c = p - r * out_w;
    const T* src = in + (r * S * in_w + c * S) * LD + ch;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 v = ld2(src + (dy * in_w + dx) * LD);
        acc.x = fmaf(v.x, k[dy * 3 + dx].x, acc.x);
        acc.y = fmaf(v.y, k[dy * 3 + dx].y, acc.y);
      }
    T* dst = out + p * LD + ch;
    dst[0] = cvt<T>(fmaf(acc.x, sa.x, sb.x));
    dst[1] = cvt<T>(fmaf(acc.y, sa.y, sb.y));
  }
}

// ---------------------------------------------------------- tensor cores
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The product of fma_stage on the tensor cores (bf16 tiles in shared
// memory): an implicit GEMM of M = out_h*out_w pixels, K = KS*KS*CI, N = OC;
// weight rows from KV on read as 0.
// Warps split N into groups of NT n8-tiles and M into the rest; each warp
// keeps its B fragments (weights, exact in bf16) in registers for the whole
// stage and walks its m16 tiles, gathering A rows (im2col) with ldmatrix.
// Sums go to epi(p, oc, v, 2) for two consecutive channels.
template <int CI, int OC, int KS, int S, int LDI, int NT, int KV = KS * KS * CI,
          typename Epi>
__device__ void mma_stage(const __nv_bfloat16* in, int in_w, int out_h, int out_w,
                          const float* __restrict__ w, const Epi& epi) {
  constexpr int K = KS * KS * CI;
  constexpr int kSteps = K / 16;
  constexpr int kNGroups = OC / (8 * NT);
  constexpr int kMGroups = kWarps / kNGroups;
  static_assert(CI % 16 == 0 && LDI % 8 == 0, "ldmatrix rows need 16 channels, 16 B");
  static_assert(kNGroups * kMGroups == kWarps, "warps must tile N");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = (warp % kNGroups) * NT * 8;
  const int mg = warp / kNGroups;

  uint32_t bfrag[kSteps][NT][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int k0 = ks * 16 + tig * 2;
      const float* wp = w + k0 * OC + n0 + j * 8 + g;
      auto wk = [&](int dk) { return k0 + dk < KV ? __ldg(wp + dk * OC) : 0.f; };
      bfrag[ks][j][0] = pack_bf16x2(wk(0), wk(1));
      bfrag[ks][j][1] = pack_bf16x2(wk(8), wk(9));
    }

  const int P = out_h * out_w;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix: row of A
  const int lk = (lane >> 4) * 8;                       // and its k offset
  for (int m0 = mg * 16; m0 < P; m0 += kMGroups * 16) {
    const int p = min(m0 + lrow, P - 1);
    const int r = p / out_w, c = p - r * out_w;
    const __nv_bfloat16* arow = in + (r * S * in_w + c * S) * LDI + lk;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int tap = ks * 16 / CI, ci0 = ks * 16 % CI;
      uint32_t a[4];
      ldmatrix_x4(a, arow + ((tap / KS) * in_w + tap % KS) * LDI + ci0);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, bfrag[ks][j][0], bfrag[ks][j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int oc = n0 + j * 8 + tig * 2;
      if (m0 + g < P) epi(m0 + g, oc, &acc[j][0], 2);
      if (m0 + g + 8 < P) epi(m0 + g + 8, oc, &acc[j][2], 2);
    }
  }
}

// A matrix-product stage: tensor cores for bf16 (NT n8-tiles a warp), CUDA
// cores for f32 (PT pixels a thread).
template <int CI, int OC, int KS, int S, int LDI, int NT, int PT, typename T, typename Epi>
__device__ void gemm_stage(const T* in, int in_w, int out_h, int out_w,
                           const float* __restrict__ w, const Epi& epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    mma_stage<CI, OC, KS, S, LDI, NT>(in, in_w, out_h, out_w, w, epi);
  else
    fma_stage<CI, OC, KS, S, LDI, PT>(in, in_w, out_h, out_w, w, epi);
}

// conv1, 3x3 stride 2 over the 3-channel image patch (pixel stride 3,
// img_w pixels a row) to out_h x out_w pixels. bf16: im2col of the 27 taps
// (zero-padded to K = 32) into ``scratch`` (out_h*out_w rows of kLd<32>),
// then the tensor cores; f32: FMA straight from the patch.
template <typename T, typename Epi>
__device__ void conv1_stage(const T* img, int img_w, int out_h, int out_w, T* scratch,
                            const float* __restrict__ w, const Epi& epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int LD = kLd<32>;
    const int P = out_h * out_w;
    // one unit per (pixel, tap row dy): the 9 taps k = 9*dy .. 9*dy+8 are
    // the 3 pixels x 3 channels of image row 2r+dy from column 2c on
    for (int u = threadIdx.x; u < P * 3; u += kThreads) {
      const int p = u / 3, dy = u - p * 3;
      const int r = p / out_w, c = p - r * out_w;
      const T* src = img + ((2 * r + dy) * img_w + 2 * c) * 3;
      T* dst = scratch + p * LD + 9 * dy;
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k] = src[k];
      if (dy == 2) {
#pragma unroll
        for (int k = 9; k < 14; ++k) dst[k] = cvt<T>(0.f);  // K padding 27..31
      }
    }
    __syncthreads();
    mma_stage<32, 32, 1, 1, LD, 1, 27>(scratch, out_w, out_h, out_w, w, epi);
  } else {
    fma_stage<3, 32, 3, 2, 3, 4>(img, img_w, out_h, out_w, w, epi);
  }
}

// Epilogue into a shared-memory stage (pixel stride LDO): affine, optional
// ReLU, rounded to T, and 0 where the pixel (tile origin (r0, c0) at a
// resolution of h x w) lies outside the image -- the zero padding the next
// 3x3 must read.
template <int LDO, bool kRelu, typename T>
struct ToStage {
  T* out;
  int out_w, r0, c0, h, w;
  const float* a;
  const float* b;
  __device__ void operator()(int p, int oc, const float* v, int nv) const {
    const int r = r0 + p / out_w, c = c0 + p % out_w;
    const bool inside = r >= 0 && r < h && c >= 0 && c < w;
    for (int j = 0; j < nv; ++j) {
      float y = fmaf(v[j], __ldg(a + oc + j), __ldg(b + oc + j));
      if (kRelu) y = fmaxf(y, 0.f);
      out[p * LDO + oc + j] = cvt<T>(inside ? y : 0.f);
    }
  }
};

// Epilogue into device memory (NHWC, OC channels), for the pixels inside the
// output: affine, optional ReLU, optional residual (a T-rounded stage in
// shared memory with pixel stride OC, added to the T-rounded result), rounded
// to T.
template <int OC, bool kRelu, typename T>
struct ToOutput {
  T* y;
  const T* residual;  // (tile pixels, OC) or nullptr
  int n, out_w, r0, c0, h, w;
  const float* a;
  const float* b;
  __device__ void operator()(int p, int oc, const float* v, int nv) const {
    const int r = r0 + p / out_w, c = c0 + p % out_w;
    if (r >= h || c >= w) return;
    T* dst = y + ((size_t(n) * h + r) * w + c) * OC + oc;
    for (int j = 0; j < nv; ++j) {
      float o = fmaf(v[j], __ldg(a + oc + j), __ldg(b + oc + j));
      if (kRelu) o = fmaxf(o, 0.f);
      if (residual != nullptr) o = rnd<T>(o) + ld(residual + p * OC + oc + j);
      dst[j] = cvt<T>(o);
    }
  }
};

// ---------------------------------------------------------------- stem
// Output tile: 8 x 16 pixels at 1/2 resolution, all 64 channels.
constexpr int kStemTH = 8, kStemTW = 16;
constexpr int kStemC1H = kStemTH + 2, kStemC1W = kStemTW + 2;            // 10 x 18
constexpr int kStemImH = 2 * kStemC1H + 1, kStemImW = 2 * kStemC1W + 1;  // 21 x 37
constexpr int kStemImg = (kStemImH * kStemImW * 3 + 7) / 8 * 8;
// c1, then conv1's im2col scratch (bf16) of the same size
constexpr int kStemSmem = kStemImg + 2 * kStemC1H * kStemC1W * kLd<32>;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    stem_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float* __restrict__ prm, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* img = reinterpret_cast<T*>(smem_raw);
  T* c1 = img + kStemImg;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kStemTH, c0 = blockIdx.x * kStemTW;
  const int H2 = H / 2, W2 = W / 2;
  // conv1 rows r0-1 .. r0+TH tap image rows 2(r0-1)-1 ..
  load_patch<kStemImH, kStemImW>(x, H, W, n, 2 * r0 - 3, 2 * c0 - 3, img);
  __syncthreads();
  conv1_stage(
      img, kStemImW, kStemC1H, kStemC1W, c1 + kStemC1H * kStemC1W * kLd<32>, prm + kK1,
      ToStage<kLd<32>, true, T>{c1, kStemC1W, r0 - 1, c0 - 1, H2, W2,
                                     prm + kA1, prm + kB1});
  __syncthreads();
  gemm_stage<32, 64, 3, 1, kLd<32>, 2, 8>(
      c1, kStemC1W, kStemTH, kStemTW, prm + kK2,
      ToOutput<64, true, T>{y, nullptr, n, kStemTW, r0, c0, H2, W2, prm + kA2, prm + kB2});
}

// ------------------------------------------------------- stem + block1
// Output tile: 4 x 8 pixels at 1/4 resolution. Stage extents (rows x cols,
// origin at 1/2 resolution relative to (2*t0, 2*u0)):
//   x4 = sep2 out  9 x 17 at (-1, -1)   read by sep3's dw (stride 2, pad 1)
//   x3 = sep1 out 11 x 19 at (-2, -2)
//   x2 = conv2    13 x 21 at (-3, -3)   the skip reads it at (2j+3, 2i+3)
//   c1 = conv1    15 x 23 at (-4, -4)
//   image patch   31 x 47 at full resolution (4*t0-9, 4*u0-9)
// Shared memory, in elements of T, reused as the stages retire:
//   S : skip result (4 x 8 x 128, unpadded)
//   P : image patch + c1, then dw1 out, dw2 out, dw3 out
//   Q : conv1's im2col (bf16), then x2, then x3, then x4
constexpr int kB1TH = 4, kB1TW = 8;
constexpr int kSkipN = kB1TH * kB1TW * 128;
constexpr int kB1Img = (31 * 47 * 3 + 7) / 8 * 8;
constexpr int kPN = 9 * 17 * kLd<128>;
constexpr int kQN = 11 * 19 * kLd<128>;
constexpr int kB1Smem = kSkipN + kPN + kQN;
static_assert(kB1Img + 15 * 23 * kLd<32> <= kPN, "patch + c1 must fit in P");
static_assert(13 * 21 * kLd<64> <= kQN && 11 * 19 * kLd<64> <= kPN &&
                  15 * 23 * kLd<32> <= kQN,
              "x2 / dw1 / conv1 im2col must fit");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    stem_block1_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ prm, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* skip = reinterpret_cast<T*>(smem_raw);
  T* P = skip + kSkipN;
  T* Q = P + kPN;
  T* img = P;
  T* c1 = P + kB1Img;
  constexpr int L32 = kLd<32>, L64 = kLd<64>, L128 = kLd<128>;
  const int n = blockIdx.z;
  const int t0 = blockIdx.y * kB1TH, u0 = blockIdx.x * kB1TW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int R = 2 * t0, C = 2 * u0;  // tile origin at 1/2 resolution

  load_patch<31, 47>(x, H, W, n, 4 * t0 - 9, 4 * u0 - 9, img);
  __syncthreads();
  conv1_stage(
      img, 47, 15, 23, Q, prm + kK1,
      ToStage<L32, true, T>{c1, 23, R - 4, C - 4, H2, W2, prm + kA1, prm + kB1});
  __syncthreads();
  gemm_stage<32, 64, 3, 1, L32, 2, 8>(
      c1, 23, 13, 21, prm + kK2,
      ToStage<L64, true, T>{Q, 21, R - 3, C - 3, H2, W2, prm + kA2, prm + kB2});
  __syncthreads();
  // skip: 1x1 stride 2 on x2 (never outside the image), and sep1's dw
  gemm_stage<64, 128, 1, 2, L64, 2, 4>(
      Q + (3 * 21 + 3) * L64, 21, kB1TH, kB1TW, prm + kWSK,
      ToStage<128, false, T>{skip, kB1TW, 0, 0, 1 << 30, 1 << 30, prm + kAS, prm + kBS});
  dw_stage<64, 1>(Q, 21, 11, 19, prm + kDW1, prm + kAD1, prm + kBD1, P);
  __syncthreads();
  gemm_stage<64, 128, 1, 1, L64, 4, 8>(
      P, 19, 11, 19, prm + kPW1,
      ToStage<L128, false, T>{Q, 19, R - 2, C - 2, H2, W2, prm + kAP1, prm + kBP1});
  __syncthreads();
  dw_stage<128, 1>(Q, 19, 9, 17, prm + kDW2, prm + kAD2, prm + kBD2, P);
  __syncthreads();
  gemm_stage<128, 128, 1, 1, L128, 4, 8>(
      P, 17, 9, 17, prm + kPW2,
      ToStage<L128, false, T>{Q, 17, R - 1, C - 1, H2, W2, prm + kAP2, prm + kBP2});
  __syncthreads();
  dw_stage<128, 2>(Q, 17, kB1TH, kB1TW, prm + kDW3, prm + kAD3, prm + kBD3, P);
  __syncthreads();
  gemm_stage<128, 128, 1, 1, L128, 2, 4>(
      P, kB1TW, kB1TH, kB1TW, prm + kPW3,
      ToOutput<128, false, T>{y, skip, n, kB1TW, t0, u0, H4, W4, prm + kAP3, prm + kBP3});
}

template <typename T>
int launch_stem(const void* x, void* y, const float* prm, int n, int h, int w,
                cudaStream_t stream) {
  const size_t smem = size_t(kStemSmem) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w / 2 + kStemTW - 1) / kStemTW, (h / 2 + kStemTH - 1) / kStemTH, n);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), prm, h, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stem_block1(const void* x, void* y, const float* prm, int n, int h,
                       int w, cudaStream_t stream) {
  const size_t smem = size_t(kB1Smem) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      stem_block1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w / 4 + kB1TW - 1) / kB1TW, (h / 4 + kB1TH - 1) / kB1TH, n);
  stem_block1_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), prm, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of floats in the packed parameter buffer of each entry.
int entry_param_count(int block1) { return block1 ? kBlock1End : kStemEnd; }

// x (n,h,w,3) -> y (n,h/2,w/2,64); bf16 != 0 selects bfloat16 I/O, else f32.
int entry_stem(const void* x, void* y, const void* prm, int n, int h, int w,
               int bf16, void* stream) {
  const float* p = static_cast<const float*>(prm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stem<__nv_bfloat16>(x, y, p, n, h, w, s)
              : launch_stem<float>(x, y, p, n, h, w, s);
}

// x (n,h,w,3) -> y (n,h/4,w/4,128)
int entry_stem_block1(const void* x, void* y, const void* prm, int n, int h,
                      int w, int bf16, void* stream) {
  const float* p = static_cast<const float*>(prm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stem_block1<__nv_bfloat16>(x, y, p, n, h, w, s)
              : launch_stem_block1<float>(x, y, p, n, h, w, s);
}

}  // extern "C"
