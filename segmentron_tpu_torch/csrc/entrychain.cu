// Xception-65 entry chain as hand-written Hopper kernels (sm_90a).
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
// host into per-channel affines (y = a*x + b). Every stage is rounded to the
// I/O type at the plain PyTorch version's points.
//
// Bound on an H100: stem+block1 at 1024x2048 does ~27.3 G MAC per image and
// moves ~46 MB (bf16), so it is bound by operations (0.0552 ms at the dense
// bf16 peak); the stem alone (~10.1 G MAC, 12.6 MB in and 67.1 MB out in
// bf16) is bound by bytes (0.0238 ms; f32: by operations, 0.302 ms on the
// CUDA cores).
//
// The stem in bf16: stem_wgmma_kernel. Its output, written once, is its
// bound, so it is built to keep the stores in flight under the products.
// Persistent blocks, one an SM, of four warpgroups walk output tiles of 8
// rows x 62 columns at 1/2 resolution (1,088 tiles at 1024x2048, 8 or 9 a
// block). conv2 runs over a raster 64 wide (columns 62, 63 of each row
// spare), so that each c1 raster row is one 64-row M tile of conv1 and each
// tap of conv2 a descriptor 16 (64 dy + dx) bytes on (no im2col). Two
// producer warpgroups run conv1 (wgmma m64n32k16, A gathered into registers
// from the image patch, K 27 -> 32; five M tiles each, three then two in
// flight) into one of two c1 buffers (four planes of 8 channels, no
// swizzle) while two consumer warpgroups run conv2 on the other. conv2 is
// transposed, M the 64 output channels: D (64 x 128 pixels) = W2^T (A: the
// weights as pack_operands lays out conv2's B) . c1 windows (B, K-major),
// 18 k-steps of wgmma m64n128k16 a chain, four chains (two output rows
// each) a tile. A warpgroup's wgmma issue waits on the tensor cores, so a
// consumer cannot run its epilogue under its own chain: the consumers take
// turns (named barriers), one's epilogue under the other's chain. The
// epilogue (affine, ReLU, bf16) stores by stmatrix.trans into the chain's
// staging slot (128-byte swizzle) and one thread sends each output row by a
// TMA store (62 pixels; TMA clips the ragged last tile column), waiting on
// cp.async.bulk.wait_group.read only before the slot is written again, a
// tile later. The patch (21 image rows x 400 elements) is a TMA box of the
// image seen as (n, h, 3 w / 8, 8), so every tile's box starts 16-byte
// aligned; it loads two tiles ahead. Shared memory: 230,200 of 232,448
// bytes a block (ops/entrychain.py::stem_plan mirrors the regions).
// On an NVIDIA H100 80GB HBM3 at 700.00 W it takes 0.0472 ms at (1, 1024,
// 2048, 3), 0.0440 with the launch hidden: 5.3x the first version in turns
// and 1.8x its bound (chip_smoke.py --entry --baseline). Shared memory,
// read by the products and written and read by the gather, the epilogues
// and the stores, sets the pace (chip_smoke.py --entry-probe).
//
// stem + block1 in bf16: stem_block1_wgmma_kernel. Persistent blocks, one an
// SM, of three warpgroups, walk output tiles of 8 x 8 pixels at 1/4
// resolution (64 rows: every product fills whole 64-row wgmma tiles). A
// tile's stages stay in shared memory and recompute their halos (1.39x the
// useful multiply-adds; 1.77x with the spare rows of whole tiles, conv1's K
// padding and the third warpgroup's repeat of the skip and pw3); in order:
//   conv1  wgmma m64n32k16, A from registers gathered from the image patch
//          (which TMA loads as a 47 x 152 box of the (n, h, w*3) image,
//          its rows starting 16-byte aligned, zeros past its edges, a tile
//          ahead), K 27 -> 32;
//   conv2  wgmma m64n64k16, A straight from c1: c1 is kept as four planes
//          of 8 channels without swizzle, and conv2 runs over a raster as wide
//          as c1, so tap (dy, dx) is the same rows shifted by 23 dy + dx, a
//          descriptor 16 (23 dy + dx) bytes further on (no im2col); two M
//          tiles in flight, one's epilogue under the other's products;
//   skip   wgmma m64n64k16, A from registers read from x2 at stride 2; its
//          rounded result waits in registers for the last epilogue;
//   sep1, sep2  in chunks of 64 output rows, two a warpgroup: a chunk's
//          depthwise taps (f32 FMA on the CUDA cores, 4 channels of a run
//          of 4 pixels a thread from a 3 x 6 window) write its A tile,
//          128-byte swizzled, then wgmma m64n128k16 and the epilogue write
//          the next stage, while the other warpgroups tap;
//   sep3   the stride-2 taps of all warpgroups into one A tile, 64 output
//          channels of pw3 a warpgroup, the skip added, staged and written
//          out in 16-byte vectors.
// The B operands come once a tile and stage as bf16, 128-byte swizzled as
// wgmma reads them, by TMA bulk copies from ops/entrychain.py's
// pack_operands buffer into two weight slots, each refilled for the stage
// after next while the stage between runs; the f32 affines and taps come
// once a block. Epilogues apply the affine, the ReLU and the zeros outside
// the image (the next 3x3's padding) on the accumulators and store 16-byte
// rows with stmatrix. Shared memory: 228,352 of 232,448 bytes a block (the
// regions are listed with the kernel; ops/entrychain.py::entry_plan mirrors
// them); stages that are read and written at once share space, each
// chunk's output rows placed where the taps have moved on.
// On an NVIDIA H100 80GB HBM3 at 700.00 W it takes 0.4279 ms at (1, 1024,
// 2048, 3) with the launch not hidden, 2.21x the first version in turns and
// 7.8x the bound (chip_smoke.py --entry --baseline). What bounds it is not
// the tensor cores or the loads (--entry-probe, launch hidden: 0.437 ms;
// without the depthwise taps 0.246, without the epilogues 0.236, without
// the products 0.317, without the weight or the patch loads 0.435 and
// 0.438): the taps on the CUDA cores and the epilogues, in stages that run
// one after the other between barriers.
//
// f32 I/O of both entries: the first version. One thread block per output
// tile builds the tile's receptive field stage by stage in shared memory
// (image patch -> conv1 -> conv2 -> sep1 -> sep2 -> sep3 + skip),
// recomputing the halos, every stage f32 FMA on the CUDA cores; its stages
// run one after the other between barriers, each short and latency-bound.
//
// Zero padding: every stage's values at positions outside the image are set
// to 0 before the next 3x3 reads them (rows and columns, both edges).
//
// Probe builds (chip_smoke.py --entry-probe; wrong results, times only):
// -DENTRY_NO_TAPS, _NO_MMA, _NO_EPI, _NO_WLOAD, _NO_IMG leave the depthwise
// taps, the products, the epilogues, the weight loads or the patch loads out
// of stem_block1_wgmma_kernel; -DSTEM_NO_MMA, _NO_EPI, _NO_STORE, _NO_IMG
// the products, the epilogues, the TMA stores or the patch loads out of
// stem_wgmma_kernel.
//
// C interface: each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int kThreads = 256;

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

// The first version's shared-memory stages are HWC with each pixel's C
// channels padded to C + 8 elements: consecutive pixels land on different
// bank groups.
template <int C> constexpr int kLd = C + 8;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
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
constexpr int kStemSmem = kStemImg + kStemC1H * kStemC1W * kLd<32>;  // the patch, c1

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
  fma_stage<3, 32, 3, 2, 3, 4>(
      img, kStemImW, kStemC1H, kStemC1W, prm + kK1,
      ToStage<kLd<32>, true, T>{c1, kStemC1W, r0 - 1, c0 - 1, H2, W2, prm + kA1, prm + kB1});
  __syncthreads();
  fma_stage<32, 64, 3, 1, kLd<32>, 8>(
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
//   Q : x2, then x3, then x4
constexpr int kB1TH = 4, kB1TW = 8;
constexpr int kSkipN = kB1TH * kB1TW * 128;
constexpr int kB1Img = (31 * 47 * 3 + 7) / 8 * 8;
constexpr int kPN = 9 * 17 * kLd<128>;
constexpr int kQN = 11 * 19 * kLd<128>;
constexpr int kB1Smem = kSkipN + kPN + kQN;
static_assert(kB1Img + 15 * 23 * kLd<32> <= kPN, "patch + c1 must fit in P");
static_assert(13 * 21 * kLd<64> <= kQN && 11 * 19 * kLd<64> <= kPN, "x2 / dw1 must fit");

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
  fma_stage<3, 32, 3, 2, 3, 4>(
      img, 47, 15, 23, prm + kK1,
      ToStage<L32, true, T>{c1, 23, R - 4, C - 4, H2, W2, prm + kA1, prm + kB1});
  __syncthreads();
  fma_stage<32, 64, 3, 1, L32, 8>(
      c1, 23, 13, 21, prm + kK2,
      ToStage<L64, true, T>{Q, 21, R - 3, C - 3, H2, W2, prm + kA2, prm + kB2});
  __syncthreads();
  // skip: 1x1 stride 2 on x2 (never outside the image), and sep1's dw
  fma_stage<64, 128, 1, 2, L64, 4>(
      Q + (3 * 21 + 3) * L64, 21, kB1TH, kB1TW, prm + kWSK,
      ToStage<128, false, T>{skip, kB1TW, 0, 0, 1 << 30, 1 << 30, prm + kAS, prm + kBS});
  dw_stage<64, 1>(Q, 21, 11, 19, prm + kDW1, prm + kAD1, prm + kBD1, P);
  __syncthreads();
  fma_stage<64, 128, 1, 1, L64, 8>(
      P, 19, 11, 19, prm + kPW1,
      ToStage<L128, false, T>{Q, 19, R - 2, C - 2, H2, W2, prm + kAP1, prm + kBP1});
  __syncthreads();
  dw_stage<128, 1>(Q, 19, 9, 17, prm + kDW2, prm + kAD2, prm + kBD2, P);
  __syncthreads();
  fma_stage<128, 128, 1, 1, L128, 8>(
      P, 17, 9, 17, prm + kPW2,
      ToStage<L128, false, T>{Q, 17, R - 1, C - 1, H2, W2, prm + kAP2, prm + kBP2});
  __syncthreads();
  dw_stage<128, 2>(Q, 17, kB1TH, kB1TW, prm + kDW3, prm + kAD3, prm + kBD3, P);
  __syncthreads();
  fma_stage<128, 128, 1, 1, L128, 4>(
      P, kB1TW, kB1TH, kB1TW, prm + kPW3,
      ToOutput<128, false, T>{y, skip, n, kB1TW, t0, u0, H4, W4, prm + kAP3, prm + kBP3});
}

// ====================================== stem + block1 in bf16: the wgmma kernel
// stem_block1_wgmma_kernel (the design is described at the top). Output
// tile: 8 x 8 pixels at 1/4 resolution. Stages at 1/2 resolution, origins
// relative to (2 t0, 2 u0):
//   c1 conv1  23 x 23 at (-4, -4): four channel planes of 560 pixels x 16 B
//             (8 channels), no swizzle: conv2's A tiles are windows of them
//   x2 conv2  21 x 21 at (-3, -3), computed over a raster 23 wide (columns
//             21, 22 of a row are spare), so that tap (dy, dx) of raster row
//             o reads c1 pixel o + 23 dy + dx: one descriptor a tap
//   x3 sep1   19 x 19 at (-2, -2);  x4 sep2 17 x 17 at (-1, -1)
//   image patch 47 rows x 48 pixels x 3 at (4 t0 - 9, 4 u0 - 9), by TMA
// x2 (64 ch), x3 and x4 (128 ch) are pixel-major, a pixel's row padded by
// 16 bytes (144, 272 bytes), so that the epilogues' stmatrix rows are free
// of bank conflicts and a tap's load is a constant offset from its pixel's.
constexpr int kWGs = 3, kWgThreadsB1 = 128 * kWGs;  // three warpgroups
constexpr int kB1Tile = 8;
constexpr int kC1W = 23, kC1Pix = 529, kC1Plane = 560, kC1PlaneBytes = kC1Plane * 16;
constexpr int kX2W = 21, kX3W = 19, kX4W = 17;
constexpr int kX2Pix = 441, kX3Pix = 361, kX4Pix = 289;
constexpr int kX2Px = 144, kX34Px = 272;  // bytes a pixel: 64 or 128 channels and 16
// The patch's rows start 5 elements before its first pixel: TMA takes a
// box only where its innermost start coordinate is a multiple of 16 bytes
// (12 u0 - 32 elements), so a row is 152 elements (304 bytes).
constexpr int kImgRows = 47, kImgElems = 152, kImgLead = 5, kImgBytes = kImgRows * kImgElems * 2;
// 64-row M tiles, as many for each warpgroup: conv1 9 (529 rows), conv2 9
// (483 rows of the 23-wide raster), sep1 6 chunks (361), sep2 6 (289)
constexpr int kMT1 = 9, kMT2 = 9, kMT3 = 6, kMT4 = 6;
// The bf16 operand buffer (ops/entrychain.py::pack_operands), bytes: each B
// operand K-major in 128-byte-swizzled boxes of [N rows][64 K], as wgmma
// reads it from a weight slot.
constexpr int kOpConv1 = 0, kOpConv1Bytes = 32 * 64 * 2;      // K 27 -> 64
constexpr int kOpConv2 = 4096, kOpConv2Bytes = 64 * 320 * 2;  // K 288 -> 320
constexpr int kOpSkip = 45056, kOpPw1 = 61440, kOpK64Bytes = 128 * 64 * 2;
constexpr int kOpPw2 = 77824, kOpPw3 = 110592, kOpK128Bytes = 128 * 128 * 2;
constexpr int kOpBytes = kOpPw3 + kOpK128Bytes;
// Shared memory, bytes from the 1024-aligned base (ops/entrychain.py::_regions).
// W0 takes conv2, pw1, pw3; W1 conv1, the skip, pw2: each slot is refilled
// for the stage after next while the stage between runs, but W0 serves
// sep2 as the third warpgroup's A tile and takes pw3 after it. A0, A1: the
// A tiles (64 rows x 128 channels; sep1's take 8 KB) of the pointwise
// products, the output's staging (and, before the first tile, the raw
// affines). The stage area X:
//   c1 and x4 at X, x3 at X + 1904, x2 at X3 + 36352, the patch at X + 78720.
// sep1 writes x3 over the rows of x2 its taps have left behind, sep2 x4
// over x3's: chunk m's rows lie below every row a later chunk reads, and
// its epilogue waits for the taps of the chunks before it. Rows outside a
// stage go to spare bytes: A0 in conv1 and conv2, A1's upper half in sep1,
// X's tail past x3 in sep2.
constexpr int kW0 = 0, kW1 = 40960, kSlot0 = 73728, kSlot1 = 90112, kABox = 8192;
constexpr int kX = 106496, kX3 = kX + 1904, kX2 = kX3 + 36352, kImg = kX + 78720;
constexpr int kC1 = kX, kX4 = kX;
constexpr int kXEnd = kX2 + kX2Pix * kX2Px;
constexpr int kPrm = kXEnd;
// f32 depthwise taps and affines, copied once a block (floats)
constexpr int kPDW1 = 0, kPDW2 = 704, kPDW3 = 2112, kPrmFloats = 3520;
constexpr int kBar = kPrm + kPrmFloats * 4, kBars = 16;
// The products' affines, a float4 (a[2k], a[2k + 1], b[2k], b[2k + 1]) a
// channel pair, so that an epilogue reads a column pair's in one load
// (floats): conv1, conv2, pw1, pw2, pw3, the skip. They arrive raw in A0 at
// the same offsets (a (C) then b (C) each).
constexpr int kAff = kBar + kBars * 8;
constexpr int kQA1 = 0, kQA2 = 64, kQP1 = 192, kQP2 = 448, kQP3 = 704, kQS = 960, kAffFloats = 1216;
constexpr int kB1WgSmem = kAff + kAffFloats * 4 + 1024;  // and 1 KB of alignment slack
enum { kBarPrm = 0, kBarImg = 1, kBarW0 = 2, kBarW1 = 3, kBarTap3 = 4, kBarTap4 = 10 };
// sep1's and sep2's chunk m writes its rows once the taps of chunks
// m - kTapWaits .. m - 1 are done: all of them, since a chunk may write over
// rows that any chunk before it reads
constexpr int kTapWaits = kMT3 - 1;
static_assert(kC1 + 4 * kC1PlaneBytes <= kX2, "c1 and x2 are read and written at once");
static_assert(kImg % 128 == 0 && kImg >= kX4 + kX4Pix * kX34Px && kImg + kImgBytes <= kXEnd &&
                  kImg >= kC1 + 4 * kC1PlaneBytes,
              "the next patch lands beside x4, c1 beside the patch");
static_assert(kX3 + kX3Pix * kX34Px + 1024 <= kXEnd, "x3 fits X, and sep2's spare rows after it");
static_assert(kB1WgSmem <= 232448, "shared memory of a block");
static_assert((kX2W - 1) * kC1W + kX2W - 1 + 2 * kC1W + 2 < kC1Plane,
              "conv2's windows of the rows it keeps stay in c1's planes");
static_assert(kC1 + (3 * kC1Plane + kMT2 * 64 + 2 * kC1W + 2) * 16 <= kXEnd,
              "the spare rows' windows stay in shared memory");
static_assert(kTapWaits == kMT3 - 1 && kMT3 == kMT4 && kBarTap4 - kBarTap3 == kMT3 &&
                  kBarTap4 + kMT4 <= kBars,
              "an epilogue waits for the taps of every chunk before it, one barrier a chunk");
static_assert(kMT1 % kWGs == 0 && kMT2 % kWGs == 0 && kMT3 % kWGs == 0 && kMT4 % kWGs == 0,
              "every warpgroup takes as many M tiles");

struct B1Args {
  const float* prm;   // pack_weights' f32 buffer: affines and depthwise taps read
  const char* ops;    // pack_operands' bf16 B operands
  __nv_bfloat16* y;   // (n, h/4, w/4, 128)
  int h, w;
  int tiles_x, tiles_y, tiles;  // 8 x 8 output tiles: across, down, all images
};

// TMA bulk copy (no tensor map) of `bytes` into shared memory; completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// wgmma descriptor of an operand without swizzle: 8-row core matrices of 16
// bytes a row, lbo between core matrices along K, sbo between 8-row groups.
__device__ __forceinline__ uint64_t plain_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32;
}
// Four 8 x 8 bf16 matrices from the mma fragment layout; lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(row)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// A warpgroup's m64nN f32 accumulators through the affine (aff: float4s
// (a, a, b, b) of the column pairs, from the first column), the ReLU, and
// zeros for rows outside the image (in0: the thread's row g, in1: row g +
// 8), rounded to bf16 and stored by stmatrix, 16 bytes a row: dst(row,
// chunk) is where the 8 channels 8 chunk .. of row `row` (0..63) go.
template <int N, bool kRelu, typename Dst>
__device__ __forceinline__ void epilogue(const float (&acc)[N / 2], const float* aff, bool in0,
                                         bool in1, const Dst& dst) {
#ifndef ENTRY_NO_EPI
  const int lane = threadIdx.x % 32, q = lane % 4, mi = lane / 8;
  const int row = 16 * ((threadIdx.x % 128) / 32) + (mi & 1) * 8 + lane % 8;
  const float4* ab = reinterpret_cast<const float4*>(aff) + q;
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t r[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t = ab[4 * (j + h)];  // columns 8 (j + h) + 2 q, + 1
      float v0 = fmaf(acc[4 * (j + h)], t.x, t.z), v1 = fmaf(acc[4 * (j + h) + 1], t.y, t.w);
      float v2 = fmaf(acc[4 * (j + h) + 2], t.x, t.z);
      float v3 = fmaf(acc[4 * (j + h) + 3], t.y, t.w);
      if (kRelu) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      r[2 * h] = in0 ? bf16x2(v0, v1) : 0u;
      r[2 * h + 1] = in1 ? bf16x2(v2, v3) : 0u;
    }
    stmatrix_x4(dst(row, j + (mi >> 1)), r[0], r[1], r[2], r[3]);
  }
#endif
}

// Depthwise 3x3 (stride S) and its affine on the CUDA cores, rounded to bf16,
// into rows 0..63 of an A tile (K-major, 128-byte swizzled boxes of 64
// channels): row i is output pixel p0 + i of a raster WO wide (pixels past
// `total` are left as they are), reading the stage `in` (WI wide, C
// channels, 2 C + 16 bytes a pixel) from (S r, S c). Thread t of NT takes
// the 4 channels of vector t % (C / 4); its taps and affine (dw (9, C), a
// (C), b (C) at dwp) are read into registers for the call. At stride 1 it
// takes rows in runs of four, four pixels of one image row from a 3 x 6
// window of loads at constant offsets, each loaded value converted once
// for up to three outputs (a run that wraps to the next row goes pixel by
// pixel). One fmaf a tap in (dy, dx) order.
template <int C, int S, int WI, int WO, int NT>
__device__ __forceinline__ void taps(const char* in, char* a, int p0, int total,
                                     const float* dwp, int t) {
#ifndef ENTRY_NO_TAPS
  constexpr int V = C / 4, PL = NT / V, PB = 2 * C + 16;
  const int v = t % V;
  float w[9][4], sa[4], sb[4];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(dwp + k * C + 4 * v);
    if (k < 9) {
      w[k][0] = u.x; w[k][1] = u.y; w[k][2] = u.z; w[k][3] = u.w;
    } else {
      sa[0] = u.x; sa[1] = u.y; sa[2] = u.z; sa[3] = u.w;
    }
  }
  {
    const float4 u = *reinterpret_cast<const float4*>(dwp + 10 * C + 4 * v);
    sb[0] = u.x; sb[1] = u.y; sb[2] = u.z; sb[3] = u.w;
  }
  const char* const src = in + v * 8;
  auto fma4 = [&](float (&acc)[4], const uint2& x, int k) {
    acc[0] = fmaf(bf_lo(x.x), w[k][0], acc[0]);
    acc[1] = fmaf(bf_hi(x.x), w[k][1], acc[1]);
    acc[2] = fmaf(bf_lo(x.y), w[k][2], acc[2]);
    acc[3] = fmaf(bf_hi(x.y), w[k][3], acc[3]);
  };
  auto emit = [&](int i, const float (&acc)[4]) {
    const uint2 o = make_uint2(bf16x2(fmaf(acc[0], sa[0], sb[0]), fmaf(acc[1], sa[1], sb[1])),
                               bf16x2(fmaf(acc[2], sa[2], sb[2]), fmaf(acc[3], sa[3], sb[3])));
    *reinterpret_cast<uint2*>(a + (v / 16) * kABox + i * 128 + ((((v % 16) / 2) ^ (i & 7)) << 4) +
                              (v % 2) * 8) = o;
  };
  auto single = [&](int i) {  // row i alone
    const int p = p0 + i, r = p / WO, c = p - r * WO;
    const char* x0 = src + (S * r * WI + S * c) * PB;
    uint2 x[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      x[k] = *reinterpret_cast<const uint2*>(x0 + ((k / 3) * WI + k % 3) * PB);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 9; ++k) fma4(acc, x[k], k);
    emit(i, acc);
  };
  if constexpr (S == 2) {
#pragma unroll 1
    for (int i = t / V; i < 64 && p0 + i < total; i += PL) single(i);
  } else {
#pragma unroll 1
    for (int i = 4 * (t / V); i < 64 && p0 + i < total; i += 4 * PL) {
      const int p = p0 + i, r = p / WO, c = p - r * WO;
      const int n = min(4, total - p);  // rows of the run inside the stage
      if (c + 3 < WO) {  // p .. p + 3 in one row: input columns c .. c + 5
        const char* x0 = src + (r * WI + c) * PB;
        uint2 x[3][6];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 6; ++dx)
            x[dy][dx] = *reinterpret_cast<const uint2*>(x0 + (dy * WI + dx) * PB);
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int j = 0; j < 4; ++j) fma4(acc[j], x[dy][j + kx], 3 * dy + kx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) emit(i + j, acc[j]);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) single(i + j);
      }
    }
  }
#endif
}

#ifdef ENTRY_NO_MMA
#define WG_MMA(stmt)  // probe build: the products left out
#else
#define WG_MMA(stmt) stmt
#endif

__global__ void __launch_bounds__(kWgThreadsB1, 1)
    stem_block1_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const B1Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // the old kernels' declaration
  char* const base =
      reinterpret_cast<char*>(smem_raw) + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  char* const w0 = base + kW0;
  char* const w1 = base + kW1;
  char* const c1 = base + kC1;
  char* const x2 = base + kX2;
  char* const x3 = base + kX3;
  char* const x4 = base + kX4;
  char* const img = base + kImg;
  const float* const prm = reinterpret_cast<const float*>(base + kPrm);
  const float* const aff = reinterpret_cast<const float*>(base + kAff);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(base + kBar);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform over the warp
  const int wt = tid % 128, lane = tid % 32, warp = wt / 32;
  const int g = lane / 4, q = lane % 4;
  // the output channels (64 wn..) a warpgroup takes in the skip and pw3: the
  // third repeats the second's and keeps nothing, so that every warpgroup
  // runs the same products
  const int wn = wg < 2 ? wg : 1;
  const int h2 = p.h / 2, w2 = p.w / 2, h4 = p.h / 4, w4 = p.w / 4;

  // thread 0 issues every copy: the f32 parameters once, the patch and the
  // weight slots a stage ahead
  auto load_w = [&](char* slot, int off, int bytes, uint64_t* b) {
#ifdef ENTRY_NO_WLOAD
    mbar_arrive(b);
#else
    mbar_arrive_expect_tx(b, bytes);
    bulk_load(slot, p.ops + off, bytes, b);
#endif
  };
  auto load_img = [&](int tile) {
    const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
    const int n = tile / (p.tiles_x * p.tiles_y);
#ifdef ENTRY_NO_IMG
    mbar_arrive(&bar[kBarImg]);
#else
    mbar_arrive_expect_tx(&bar[kBarImg], kImgBytes);
    tma_load_3d(img, &map_x, (4 * kB1Tile * tx - 9) * 3 - kImgLead, 4 * kB1Tile * ty - 9, n,
                &bar[kBarImg]);
#endif
  };
  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(&bar[i], i >= kBarTap3 ? 4 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the depthwise taps and affines into kPDW1 .. of the parameters, the
    // products' affines into A0 at kQA1 ..: (offset in pack_weights'
    // buffer, floats)
    mbar_arrive_expect_tx(&bar[kBarPrm], (kPrmFloats + kAffFloats) * 4);
    bulk_load(base + kPrm + 4 * kPDW1, p.prm + kDW1, 4 * 704, &bar[kBarPrm]);
    bulk_load(base + kPrm + 4 * kPDW2, p.prm + kDW2, 4 * 1408, &bar[kBarPrm]);
    bulk_load(base + kPrm + 4 * kPDW3, p.prm + kDW3, 4 * 1408, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQA1, p.prm + kA1, 4 * 64, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQA2, p.prm + kA2, 4 * 128, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQP1, p.prm + kAP1, 4 * 256, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQP2, p.prm + kAP2, 4 * 256, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQP3, p.prm + kAP3, 4 * 256, &bar[kBarPrm]);
    bulk_load(base + kSlot0 + 4 * kQS, p.prm + kAS, 4 * 256, &bar[kBarPrm]);
    load_img(blockIdx.x);
    load_w(w1, kOpConv1, kOpConv1Bytes, &bar[kBarW1]);
    load_w(w0, kOpConv2, kOpConv2Bytes, &bar[kBarW0]);
  }
  mbar_wait(&bar[kBarPrm], 0);
  for (int i = tid; i < kAffFloats / 4; i += kWgThreadsB1) {
    // the products' affines as float4s of channel pairs: float4 i is pair
    // k of the affine of c channels that starts at float o
    const int o = 4 * i < kQA2 ? kQA1 : 4 * i < kQP1 ? kQA2 : 4 * i < kQP2 ? kQP1
                : 4 * i < kQP3 ? kQP2 : 4 * i < kQS ? kQP3 : kQS;
    const int c = o == kQA1 ? 32 : o == kQA2 ? 64 : 128, k = i - o / 4;
    const float* a = reinterpret_cast<const float*>(base + kSlot0) + o;
    reinterpret_cast<float4*>(base + kAff)[i] =
        make_float4(a[2 * k], a[2 * k + 1], a[c + 2 * k], a[c + 2 * k + 1]);
  }
  __syncthreads();
  int n0 = 0, n1 = 0;  // fills of W0, W1 waited on

  for (int tile = blockIdx.x, k = 0; tile < p.tiles; tile += gridDim.x, ++k) {
    const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
    const int n = tile / (p.tiles_x * p.tiles_y);
    const int t0 = kB1Tile * ty, u0 = kB1Tile * tx, R = 2 * t0, C = 2 * u0;
    const bool more = tile + int(gridDim.x) < p.tiles;
    // 1/2-resolution pixel (r, c) of a stage with origin org is in the image
    auto inside = [&](int r, int c, int org) {
      const int rr = R + org + r, cc = C + org + c;
      return rr >= 0 && rr < h2 && cc >= 0 && cc < w2;
    };

    // ---------------------------------------------------------- conv1
    // M tiles wg, wg + 3, wg + 6 of the 23-wide c1 raster; A from registers,
    // gathered from the patch: row p = (r, c), k = (ky 3 + kx) 3 + ch at patch
    // row 2 r + ky, element (2 c + kx) 3 + ch (k >= 27: 0). Rows past 528
    // repeat 528 and are not stored.
    mbar_wait(&bar[kBarImg], k & 1);
    mbar_wait(&bar[kBarW1], n1++ & 1);
    {
      const uint16_t* im = reinterpret_cast<const uint16_t*>(img);
      float d[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = 0.f;
      int off[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 16 * s + 2 * q + (e & 1) + (e >> 1) * 8;
          off[s][e] = kk < 27 ? (kk / 9) * kImgElems + ((kk % 9) / 3) * 3 + kk % 3 : -1;
        }
#pragma unroll 1
      for (int i = 0; i < kMT1 / kWGs; ++i) {
        const int mt = wg + kWGs * i;
        const int p0 = min(64 * mt + 16 * warp + g, kC1Pix - 1);
        const int p1 = min(64 * mt + 16 * warp + g + 8, kC1Pix - 1);
        const int r0 = p0 / kC1W, c0 = p0 - r0 * kC1W, r1 = p1 / kC1W, c1c = p1 - r1 * kC1W;
        const int b0 = 2 * r0 * kImgElems + 6 * c0 + kImgLead;
        const int b1 = 2 * r1 * kImgElems + 6 * c1c + kImgLead;
        uint32_t a[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          auto val = [&](int b, int e) { return off[s][e] < 0 ? 0u : uint32_t(im[b + off[s][e]]); };
          a[s][0] = val(b0, 0) | val(b0, 1) << 16;
          a[s][1] = val(b1, 0) | val(b1, 1) << 16;
          a[s][2] = val(b0, 2) | val(b0, 3) << 16;
          a[s][3] = val(b1, 2) | val(b1, 3) << 16;
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s)
          WG_MMA(Wgmma<32>::rs<0>(d, a[s], kmajor_desc(w1, 32, 0, 16 * s), s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        epilogue<32, true>(d, aff + kQA1, inside(r0, c0, -4), inside(r1, c1c, -4),
                           [&](int row, int ch) {
                             const int pp = 64 * mt + row;
                             return pp < kC1Pix ? c1 + ch * kC1PlaneBytes + pp * 16
                                                : base + kSlot0 + row * 16;
                           });
      }
    }
    fence_proxy_async();  // c1 is read by wgmma next
    __syncthreads();
    if (tid == 0) load_w(w1, kOpSkip, kOpK64Bytes, &bar[kBarW1]);

    // ---------------------------------------------------------- conv2
    // M tiles wg, wg + 3, wg + 6 of a raster 23 wide, two in flight: K = 9
    // taps x 32 channels, tap (dy, dx) the window of c1 from raster row
    // 64 mt + 23 dy + dx, channels 16 (s % 2).. the planes 2 (s % 2), + 1.
    mbar_wait(&bar[kBarW0], n0++ & 1);
    {
      float e0[32], e1[32];
      auto chain = [&](float (&d)[32], int mt) {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 18; ++s) {
          const int tap = s / 2;
          const uint64_t da = plain_desc(
              c1 + 2 * (s % 2) * kC1PlaneBytes + (64 * mt + (tap / 3) * kC1W + tap % 3) * 16,
              kC1PlaneBytes, 128);
          const uint64_t db = kmajor_desc(w0, 64, 0, 16 * s);
          if (s == 0) {
            WG_MMA(Wgmma<64>::ss0(d, da, db));
          } else {
            WG_MMA(Wgmma<64>::ss<0>(d, da, db, 1));
          }
        }
        wgmma_commit();
      };
      auto store = [&](const float (&d)[32], int mt) {
        const int o0 = 64 * mt + 16 * warp + g, o1 = o0 + 8;
        epilogue<64, true>(d, aff + kQA2, inside(o0 / kC1W, o0 % kC1W, -3),
                           inside(o1 / kC1W, o1 % kC1W, -3), [&](int row, int ch) {
                             const int o = 64 * mt + row, r = o / kC1W, c = o - r * kC1W;
                             const int pix = r * kX2W + c;
                             return r < kX2W && c < kX2W ? x2 + pix * kX2Px + ch * 16
                                                         : base + kSlot0 + row * 16;
                           });
      };
      chain(e0, wg);
      chain(e1, wg + kWGs);
      wgmma_wait<1>();
      fence_regs(e0);
      store(e0, wg);
      chain(e0, wg + 2 * kWGs);
      wgmma_wait<1>();
      fence_regs(e1);
      store(e1, wg + kWGs);
      wgmma_wait<0>();
      fence_regs(e0);
      store(e0, wg + 2 * kWGs);
    }
    __syncthreads();
    if (tid == 0) load_w(w0, kOpPw1, kOpK64Bytes, &bar[kBarW0]);

    // ----------------------------------------------------------- skip
    // 1x1 stride 2 on x2 at (2 j + 3, 2 i + 3): A from registers; warpgroup
    // wg < 2 takes output channels 64 wg..; the result, rounded, waits in
    // registers (sk) for sep3's epilogue, which has the same fragments.
    uint32_t sk[16];
    mbar_wait(&bar[kBarW1], n1++ & 1);
    {
      const int rho0 = 16 * warp + g, rho1 = rho0 + 8;
      const int pix0 = (2 * (rho0 / 8) + 3) * kX2W + 2 * (rho0 % 8) + 3;
      const int pix1 = (2 * (rho1 / 8) + 3) * kX2W + 2 * (rho1 % 8) + 3;
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        auto at = [&](int pix, int ch) {
          return *reinterpret_cast<const uint32_t*>(x2 + pix * kX2Px + ch * 16 + 4 * q);
        };
        a[s][0] = at(pix0, 2 * s);
        a[s][1] = at(pix1, 2 * s);
        a[s][2] = at(pix0, 2 * s + 1);
        a[s][3] = at(pix1, 2 * s + 1);
      }
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        WG_MMA(Wgmma<64>::rs<0>(d, a[s], kmajor_desc(w1, 128, 64 * wn, 16 * s), s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      const float4* ab = reinterpret_cast<const float4*>(aff + kQS) + 32 * wn + q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 t = ab[4 * j];
        sk[2 * j] = bf16x2(fmaf(d[4 * j], t.x, t.z), fmaf(d[4 * j + 1], t.y, t.w));
        sk[2 * j + 1] = bf16x2(fmaf(d[4 * j + 2], t.x, t.z), fmaf(d[4 * j + 3], t.y, t.w));
      }
    }
    __syncthreads();
    if (tid == 0) load_w(w1, kOpPw2, kOpK128Bytes, &bar[kBarW1]);

    // ---------------------------------------------- sep1, sep2: chunks
    // Chunk m = wg + 3 i (rows 64 m.. of the output raster), i = 0, 1, of
    // warpgroup m % 3: its taps into the warpgroup's A tile, its product,
    // then (once every chunk before it is tapped: its rows overwrite the
    // stage before) its epilogue into the next stage.
    auto sep = [&](auto kc, const char* in, char* out, const float* dwp, const float* paff,
                   const char* wslot, char* at, char* spare, uint64_t* tapped, int total,
                   int org) {
      constexpr int CI = decltype(kc)::value;  // input channels: 64 or 128
      constexpr int WI = CI == 64 ? kX2W : kX3W, WO = CI == 64 ? kX3W : kX4W;
      float acc[64];
      static_assert(kMT3 == kMT4, "sep1 and sep2 take as many chunks");
#pragma unroll 1
      for (int i = 0; i < kMT3 / kWGs; ++i) {
        const int m = wg + kWGs * i;
        taps<CI, 1, WI, WO, 128>(in, at, 64 * m, total, dwp, wt);
        __syncwarp();
        if (lane == 0) mbar_arrive(&tapped[m]);
        fence_proxy_async();
        named_sync(1 + wg, 128);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < CI / 16; ++s) {
          const uint64_t da = kmajor_desc(at, 64, 0, 16 * s);
          const uint64_t db = kmajor_desc(wslot, 128, 0, 16 * s);
          if (s == 0) {
            WG_MMA(Wgmma<128>::ss0(acc, da, db));
          } else {
            WG_MMA(Wgmma<128>::ss<0>(acc, da, db, 1));
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        // the taps of every chunk before this one, whichever warpgroup runs
        // them, have read the rows of the stage before that its rows overwrite
        for (int j = max(0, m - kTapWaits); j < m; ++j) mbar_wait(&tapped[j], k & 1);
        const int o0 = 64 * m + 16 * warp + g, o1 = o0 + 8;
        epilogue<128, false>(acc, paff, inside(o0 / WO, o0 % WO, org),
                             inside(o1 / WO, o1 % WO, org), [&](int row, int ch) {
                               const int o = 64 * m + row;
                               return o < total ? out + o * kX34Px + ch * 16 : spare + row * 16;
                             });
      }
    };
    // the A tiles: sep1's 8 KB each in A0 and A1; sep2's A0, A1 and W0 (free
    // until pw3)
    mbar_wait(&bar[kBarW0], n0++ & 1);
    sep(std::integral_constant<int, 64>{}, x2, x3, prm + kPDW1, aff + kQP1, w0,
        base + kSlot0 + wg * kABox, base + kSlot1 + kABox, &bar[kBarTap3], kX3Pix, -2);
    __syncthreads();
    mbar_wait(&bar[kBarW1], n1++ & 1);
    sep(std::integral_constant<int, 128>{}, x3, x4, prm + kPDW2, aff + kQP2, w1,
        wg == 2 ? w0 : base + kSlot0 + wg * 2 * kABox, base + kXEnd - 1024, &bar[kBarTap4],
        kX4Pix, -1);
    fence_proxy_async();  // x2, x3 and W0 were written here: TMA writes them next
    __syncthreads();
    if (tid == 0) {
      load_w(w0, kOpPw3, kOpK128Bytes, &bar[kBarW0]);
      if (more) {
        load_w(w1, kOpConv1, kOpConv1Bytes, &bar[kBarW1]);
        load_img(tile + int(gridDim.x));
      }
    }

    // ----------------------------------------------------------- sep3
    // The stride-2 taps by all warpgroups into A0, then pw3 (warpgroup wg < 2
    // its 64 output channels); the affine, plus the skip, rounded once,
    // staged in A1 and written out in 16-byte vectors.
    taps<128, 2, kX4W, kB1Tile, kWgThreadsB1>(x4, base + kSlot0, 0, 64, prm + kPDW3, tid);
    fence_proxy_async();
    __syncthreads();
    mbar_wait(&bar[kBarW0], n0++ & 1);
    {
      float d[32];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint64_t da = kmajor_desc(base + kSlot0, 64, 0, 16 * s);
        const uint64_t db = kmajor_desc(w0, 128, 64 * wn, 16 * s);
        if (s == 0) {
          WG_MMA(Wgmma<64>::ss0(d, da, db));
        } else {
          WG_MMA(Wgmma<64>::ss<0>(d, da, db, 1));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
#ifndef ENTRY_NO_EPI
      if (wg < 2) {
        const float4* ab = reinterpret_cast<const float4*>(aff + kQP3) + 32 * wg + q;
        const int mi = lane / 8, row = 16 * warp + (mi & 1) * 8 + lane % 8;
        char* stage = base + kSlot1 + wg * kABox;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t r[4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jj = j + hh;
            const float4 t = ab[4 * jj];
            // pw3's result rounded to bf16, plus the skip's, rounded once more
            const float v0 = __bfloat162float(__float2bfloat16_rn(fmaf(d[4 * jj], t.x, t.z)));
            const float v1 = __bfloat162float(__float2bfloat16_rn(fmaf(d[4 * jj + 1], t.y, t.w)));
            const float v2 = __bfloat162float(__float2bfloat16_rn(fmaf(d[4 * jj + 2], t.x, t.z)));
            const float v3 = __bfloat162float(__float2bfloat16_rn(fmaf(d[4 * jj + 3], t.y, t.w)));
            r[2 * hh] = bf16x2(v0 + bf_lo(sk[2 * jj]), v1 + bf_hi(sk[2 * jj]));
            r[2 * hh + 1] = bf16x2(v2 + bf_lo(sk[2 * jj + 1]), v3 + bf_hi(sk[2 * jj + 1]));
          }
          const int ch = j + (mi >> 1);
          stmatrix_x4(stage + row * 128 + ((ch ^ (row & 7)) << 4), r[0], r[1], r[2], r[3]);
        }
      }
#endif
    }
    __syncthreads();
#ifndef ENTRY_NO_EPI
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int idx = tid + kWgThreadsB1 * e, rho = idx / 16, c16 = idx % 16;
      const int r = t0 + rho / 8, c = u0 + rho % 8;
      if (idx < 64 * 16 && r < h4) {
        const uint4 v = *reinterpret_cast<const uint4*>(base + kSlot1 + (c16 / 8) * kABox +
                                                        rho * 128 + (((c16 % 8) ^ (rho & 7)) << 4));
        *reinterpret_cast<uint4*>(p.y + ((size_t(n) * h4 + r) * w4 + c) * 128 + c16 * 8) = v;
      }
    }
#endif
    __syncthreads();
    if (tid == 0 && more) load_w(w0, kOpConv2, kOpConv2Bytes, &bar[kBarW0]);
  }
}

// ============================================= the stem in bf16: the wgmma kernel
// stem_wgmma_kernel (the design is described at the top). Output tile: 8
// rows x 62 columns at 1/2 resolution, from (R0, C0) = (8 ty, 62 tx).
//   c1     conv1 over 10 rows x 64 columns from (R0 - 1, C0 - 1): a raster 64
//          wide, so that c1 raster row r is conv1's M tile r; four planes of
//          8 channels without swizzle, 648 pixels a plane (640 and the shifted
//          reads of the spare columns)
//   conv2  the tile's 8 x 64 raster (columns 62, 63 of a row are spare) in
//          four chains of 128 pixels (two output rows): tap (dy, dx) of
//          raster pixel o reads c1 pixel o + 64 dy + dx, one descriptor a tap
//   patch  21 image rows from 2 R0 - 3, 400 bf16 elements a row from the
//          16-byte chunk that holds element 6 C0 - 9 (the first of column
//          2 C0 - 3), as a 4-D box (8 elements, 50 chunks, 21 rows, 1 image)
//          of the image seen as (n, h, 3 w / 8, 8): its innermost start is
//          always 0, so every tile's box starts 16-byte aligned
// Warpgroups 0 and 1 (the producers, c1 rows 5 wg.. each) run conv1 into
// one of two c1 buffers while warpgroups 2 and 3 (the consumers, output rows
// 4 h.. of consumer h = wg - 2) run conv2 on the other, taking turns on the
// tensor cores; stores go out by TMA from a staging slot a chain.
constexpr int kStemWGs = 4, kStemThreads = 128 * kStemWGs;
constexpr int kStemTileRows = 8, kStemTileCols = 62, kStemRaster = 64;
constexpr int kStemC1Rows = kStemTileRows + 2, kStemC1Pix = kStemC1Rows * kStemRaster;  // 640
constexpr int kStemPlanePix = 648, kStemPlane = kStemPlanePix * 16;
constexpr int kStemC1Bytes = 4 * kStemPlane;
constexpr int kStemMT1 = kStemC1Pix / 64;  // conv1's M tiles: one a c1 row
constexpr int kStemRowsP = kStemMT1 / 2;   // a producer's M tiles: in flight 3, then 2
constexpr int kStemChainN = 128;           // conv2: N of a chain, two output rows
constexpr int kStemChains = kStemTileRows * kStemRaster / kStemChainN;  // 4
constexpr int kStemImgRows = 2 * kStemC1Rows + 1, kStemImgChunks = 50;
constexpr int kStemImgElems = 8 * kStemImgChunks, kStemImgBytes = kStemImgRows * kStemImgElems * 2;
// Shared memory, bytes from the 1024-aligned base (ops/entrychain.py::
// _stem_regions): conv2's A (the weights as pack_operands lays out conv2's
// B: 64 rows of K, 128-byte swizzled) and conv1's B; the staging slots, one
// a chain (two output rows of 64 pixels x 128 bytes, swizzled as the
// output's tensor map takes them); two c1 buffers; two patches; the f32
// affines (a1, b1, a2, b2); the mbarriers.
constexpr int kSW2 = 0, kSW1 = kSW2 + kOpConv2Bytes;
constexpr int kSStage = kSW1 + kOpConv1Bytes, kSSlot = 2 * kStemRaster * 128;
constexpr int kSC1 = kSStage + kStemChains * kSSlot;
constexpr int kSImg = kSC1 + 2 * kStemC1Bytes, kSImgStride = 17408;
constexpr int kSRaw = kSImg + 2 * kSImgStride, kSRawBytes = (64 + 128) * 4;
constexpr int kSBar = kSRaw + kSRawBytes, kStemBars = 7;
constexpr int kStemWgSmem = kSBar + kStemBars * 8 + 1024;  // and 1 KB of alignment slack
// mbarriers: the weights and affines; the patches (buffer b at 1 + b); c1
// written (3 + b, the producers' 256 threads) and read (5 + b, the
// consumers' 256)
enum { kSBarW = 0, kSBarImg = 1, kSBarFull = 3, kSBarEmpty = 5 };
// named barriers: 1 the producers', 2 + h consumer h's, kStemTurn + h
// consumer h's turn to issue a chain
constexpr int kStemTurn = 4;
static_assert(kStemRowsP == 5 && kStemChains == 4, "producers: 3 + 2 M tiles; consumers: 2 chains");
static_assert((kStemTileRows * kStemRaster - 1) + 2 * kStemRaster + 2 < kStemPlanePix,
              "conv2's shifted reads stay in c1's planes");
static_assert(kStemImgElems >= 7 + 6 * (kStemRaster - 1) + 9 && kStemImgBytes <= kSImgStride,
              "a patch row holds the lead and the last column's taps");
static_assert(kSStage % 1024 == 0 && kSSlot % 1024 == 0 && kSImg % 1024 == 0 &&
                  kSImgStride % 1024 == 0 && kSC1 % 16 == 0 && kStemPlane % 16 == 0,
              "swizzled slots 1024-aligned, TMA and wgmma operands 16-aligned");
static_assert(kStemWgSmem <= 232448, "shared memory of a block");

struct StemArgs {
  const float* prm;  // pack_weights' f32 buffer of the stem: the affines are read
  const char* ops;   // pack_operands' bf16 B operands: conv1, conv2
  int h, w;
  int tiles_x, tiles_y, tiles;  // 8 x 62 output tiles: across, down, all images
};

#ifdef STEM_NO_MMA
#define STEM_MMA(stmt)  // probe build: the products left out
#else
#define STEM_MMA(stmt) stmt
#endif

__global__ void __launch_bounds__(kStemThreads, 1)
    stem_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_y, const StemArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // the old kernels' declaration
  char* const base =
      reinterpret_cast<char*>(smem_raw) + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(base + kSBar);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform over the warp
  const int wt = tid % 128, lane = tid % 32, warp = wt / 32;
  const int g = lane / 4, q = lane % 4;
  const int h2 = p.h / 2, w2 = p.w / 2;
  // this block's tiles: blockIdx.x + i gridDim.x, i < count (the grid is at
  // most the tile count)
  const int count = (p.tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1;
  auto origin = [&](int i, int& n, int& r0, int& c0) {
    const int tile = blockIdx.x + i * gridDim.x;
    n = tile / (p.tiles_x * p.tiles_y);
    r0 = kStemTileRows * ((tile / p.tiles_x) % p.tiles_y);
    c0 = kStemTileCols * (tile % p.tiles_x);
  };
  // the patch of tile i into buffer i % 2: chunk (6 C0 - 9) / 8 rounded down
  auto load_img = [&](int i) {
    int n, r0, c0;
    origin(i, n, r0, c0);
    uint64_t* b = &bar[kSBarImg + i % 2];
#ifdef STEM_NO_IMG
    mbar_arrive(b);
#else
    mbar_arrive_expect_tx(b, kStemImgBytes);
    tma_load_4d(base + kSImg + (i % 2) * kSImgStride, &map_x, 0, (6 * c0 - 9) >> 3, 2 * r0 - 3,
                n, b);
#endif
  };
  if (tid == 0) {
    mbar_init(&bar[kSBarW], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bar[kSBarImg + b], 1);
      mbar_init(&bar[kSBarFull + b], 256);
      mbar_init(&bar[kSBarEmpty + b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the weights once a block, the patches of the first two tiles
    mbar_arrive_expect_tx(&bar[kSBarW], kOpConv2Bytes + kOpConv1Bytes + kSRawBytes);
    bulk_load(base + kSW2, p.ops + kOpConv2, kOpConv2Bytes, &bar[kSBarW]);
    bulk_load(base + kSW1, p.ops + kOpConv1, kOpConv1Bytes, &bar[kSBarW]);
    bulk_load(base + kSRaw, p.prm + kA1, 64 * 4, &bar[kSBarW]);         // a1, b1
    bulk_load(base + kSRaw + 256, p.prm + kA2, 128 * 4, &bar[kSBarW]);  // a2, b2
    for (int i = 0; i < 2 && i < count; ++i) load_img(i);
  }
  mbar_wait(&bar[kSBarW], 0);

  if (wg < 2) {
    // ------------------------------------------------ producers: conv1
    // M tile r = c1 raster row r: row c of it is c1 pixel (R0 - 1 + r,
    // C0 - 1 + c); A from registers, gathered from the patch: k = (ky 3 +
    // kx) 3 + ch at patch row 2 r + ky, element lead + 6 c + 3 kx + ch
    // (k >= 27: 0). Producer wg takes M tiles 5 wg .. 5 wg + 4: three in
    // flight at once, then two.
    int off[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 16 * s + 2 * q + (e & 1) + (e >> 1) * 8;
        off[s][e] = kk < 27 ? (kk / 9) * kStemImgElems + ((kk % 9) / 3) * 3 + kk % 3 : -1;
      }
    // conv1's affine of this thread's column pairs 8 j + 2 q, + 1: (a, a, b, b)
    const float* const raw1 = reinterpret_cast<const float*>(base + kSRaw);
    float4 aff[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * q;
      aff[j] = make_float4(raw1[c], raw1[c + 1], raw1[32 + c], raw1[32 + c + 1]);
    }
    const int mi = lane / 8, srow = 16 * warp + (mi & 1) * 8 + lane % 8;  // stmatrix rows
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      const int b = i & 1;
      int n, r0, c0;
      origin(i, n, r0, c0);
      char* const c1 = base + kSC1 + b * kStemC1Bytes;
      const uint16_t* const im = reinterpret_cast<const uint16_t*>(base + kSImg + b * kSImgStride);
      const int lead = (6 * c0 - 9) & 7;
      const int col0 = c0 - 1 + 16 * warp + g, col1 = col0 + 8;  // this thread's two rows
      const bool cin0 = col0 >= 0 && col0 < w2, cin1 = col1 < w2;
      if (i >= 2) mbar_wait(&bar[kSBarEmpty + b], ((i >> 1) - 1) & 1);
      mbar_wait(&bar[kSBarImg + b], (i >> 1) & 1);
      // G M tiles from r1: their A gathered, their products in flight
      // together, waited on once, then their epilogues
      auto group = [&](auto g_, int r1) {
        constexpr int G = decltype(g_)::value;
        uint32_t a[G][2][4];
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int b0 = 2 * (r1 + t) * kStemImgElems + 6 * (16 * warp + g) + lead, b1 = b0 + 48;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            auto val = [&](int bb, int e) {
              return off[s][e] < 0 ? 0u : uint32_t(im[bb + off[s][e]]);
            };
            a[t][s][0] = val(b0, 0) | val(b0, 1) << 16;
            a[t][s][1] = val(b1, 0) | val(b1, 1) << 16;
            a[t][s][2] = val(b0, 2) | val(b0, 3) << 16;
            a[t][s][3] = val(b1, 2) | val(b1, 3) << 16;
          }
        }
        float d[G][16];
#pragma unroll
        for (int t = 0; t < G; ++t)
#pragma unroll
          for (int j = 0; j < 16; ++j) d[t][j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < G; ++t)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            STEM_MMA(Wgmma<32>::rs<0>(d[t], a[t][s], kmajor_desc(base + kSW1, 32, 0, 16 * s), s));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int t = 0; t < G; ++t) fence_regs(d[t]);
#ifndef STEM_NO_EPI
        // the affine, the ReLU, zeros outside the image, bf16, by stmatrix
        // into the planes: chunk j (channels 8 j..) of c1 pixel 64 r + row
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int r = r1 + t, row = r0 - 1 + r;
          const bool in0 = row >= 0 && row < h2 && cin0, in1 = row >= 0 && row < h2 && cin1;
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            uint32_t v[4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float4 f = aff[j + hh];
              const float* e = &d[t][4 * (j + hh)];
              v[2 * hh] = in0 ? bf16x2(fmaxf(fmaf(e[0], f.x, f.z), 0.f),
                                       fmaxf(fmaf(e[1], f.y, f.w), 0.f)) : 0u;
              v[2 * hh + 1] = in1 ? bf16x2(fmaxf(fmaf(e[2], f.x, f.z), 0.f),
                                           fmaxf(fmaf(e[3], f.y, f.w), 0.f)) : 0u;
            }
            stmatrix_x4(c1 + (j + (mi >> 1)) * kStemPlane + (64 * r + srow) * 16, v[0], v[1],
                        v[2], v[3]);
          }
        }
#endif
      };
      group(std::integral_constant<int, 3>{}, kStemRowsP * wg);
      group(std::integral_constant<int, 2>{}, kStemRowsP * wg + 3);
      fence_proxy_async();  // c1 is read by wgmma next; the patch is written by TMA
      mbar_arrive(&bar[kSBarFull + b]);
      named_sync(1, 256);  // every producer thread is done with patch b
      if (tid == 0 && i + 2 < count) load_img(i + 2);
    }
    return;
  }

  // --------------------------------------------------- consumers: conv2
  // Consumer h takes chains k = 2 h, 2 h + 1 of each tile: 128 raster pixels
  // from o = 128 k (output rows 2 k, 2 k + 1). Transposed, so that M is the
  // 64 output channels: D (64 x 128) = W2^T (A: 64 rows of K = 9 taps x 32
  // channels, from the weight slot) . c1 windows (B, K-major: pixel o +
  // 64 dy + dx of planes 2 (s % 2), + 1 for k-step s). A warpgroup's wgmma
  // issue waits on the tensor cores, so its own epilogue cannot run under
  // its products: the consumers take turns (named barriers kStemTurn + h,
  // consumer 0 first), one's epilogue under the other's chain.
  const int h = wg - 2;
  const float* const raw2 = reinterpret_cast<const float*>(base + kSRaw + 256);
  const int chan = 16 * warp + g;  // accumulator rows: channels chan, chan + 8
  const float a_lo = raw2[chan], a_hi = raw2[chan + 8];
  const float b_lo = raw2[64 + chan], b_hi = raw2[64 + chan + 8];
  float e[64];
  auto chain = [&](int i, int k) {
    const char* const c1 = base + kSC1 + (i & 1) * kStemC1Bytes;
    const int o = kStemChainN * k;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 18; ++s) {
      const int tap = s / 2;
      const uint64_t da = kmajor_desc(base + kSW2, 64, 0, 16 * s);
      const uint64_t db = plain_desc(
          c1 + 2 * (s % 2) * kStemPlane + (o + (tap / 3) * kStemRaster + tap % 3) * 16,
          kStemPlane, 128);
      if (s == 0) {
        STEM_MMA(Wgmma<128>::ss0(e, da, db));
      } else {
        STEM_MMA(Wgmma<128>::ss<0>(e, da, db, 1));
      }
    }
    wgmma_commit();
  };
  // the affine, the ReLU, bf16, stored transposed into slot k (pixel-major,
  // 128 bytes a pixel, 16-byte chunk c of pixel x at c ^ (x % 8)), then two
  // TMA stores of 62 pixels, output rows R0 + 2 k, + 1
  auto store = [&](int i, int k) {
    char* const slot = base + kSStage + k * kSSlot;
    // the slot's stores of the tile before (two groups ago) have read it
    if (wt == 0) bulk_wait<1, true>();
    named_sync(2 + h, 128);
#ifndef STEM_NO_EPI
    const int mi = lane / 8, rr = lane % 8;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int jj = j + hh;  // pixels 8 jj + 2 q, + 1
        const float v0 = fmaxf(fmaf(e[4 * jj], a_lo, b_lo), 0.f);
        const float v1 = fmaxf(fmaf(e[4 * jj + 1], a_lo, b_lo), 0.f);
        const float v2 = fmaxf(fmaf(e[4 * jj + 2], a_hi, b_hi), 0.f);
        const float v3 = fmaxf(fmaf(e[4 * jj + 3], a_hi, b_hi), 0.f);
        r[2 * hh] = bf16x2(v0, v1);      // channels chan.. (chunk 2 warp)
        r[2 * hh + 1] = bf16x2(v2, v3);  // channels chan + 8.. (chunk 2 warp + 1)
      }
      const int px = 8 * (j + (mi >> 1)) + rr, ch = 2 * warp + (mi & 1);
      stmatrix_x4_trans(slot + px * 128 + ((ch ^ rr) << 4), r[0], r[1], r[2], r[3]);
    }
#endif
    fence_proxy_async();  // the slot is read by TMA next
    named_sync(2 + h, 128);
#ifndef STEM_NO_STORE
    if (wt == 0) {
      int n, r0, c0;
      origin(i, n, r0, c0);
      tma_store_4d(&map_y, slot, 0, c0, r0 + 2 * k, n);
      tma_store_4d(&map_y, slot + kStemRaster * 128, 0, c0, r0 + 2 * k + 1, n);
    }
#endif
    if (wt == 0) bulk_commit();
  };
  // Each chain is waited on before its epilogue: a product in flight while
  // its warpgroup reads accumulators across the loop's back edge makes ptxas
  // serialise every wgmma (C7514).
  if (h == 1) named_arrive(kStemTurn, 256);
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    mbar_wait(&bar[kSBarFull + (i & 1)], (i >> 1) & 1);
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      named_sync(kStemTurn + h, 256);
      chain(i, 2 * h + c);
      // the other consumer's turn (consumer 1 gives none after its last chain)
      if (h == 0 || i + 1 < count || c == 0) named_arrive(kStemTurn + 1 - h, 256);
      wgmma_wait<0>();
      fence_regs(e);
      if (c == 1) mbar_arrive(&bar[kSBarEmpty + (i & 1)]);  // tile i's c1 is read
      store(i, 2 * h + c);
    }
  }
  if (wt == 0) bulk_wait<0, false>();  // the stores are done before the block's memory goes
}

// The gate of ops/entrychain.py::stem_supported.
bool stem_supported(int h, int w) {
  return h % 2 == 0 && w % 32 == 0 && (h / 2) % 8 == 0 && h / 2 >= 16;
}

// The gate of ops/entrychain.py::stem_block1_supported.
bool block1_supported(int h, int w) {
  return h % 4 == 0 && w % 64 == 0 && (h / 4) % 4 == 0 && h / 4 >= 8;
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

// The image as a 3-D map (n, h, w * 3) of bf16: boxes of 47 rows x 152
// elements (48 pixels and 5 elements before them), unswizzled, zeros past
// every edge (conv1's padding).
bool encode_image(CUtensorMap* map, const void* x, int n, int h, int w) {
  auto fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[3] = {cuuint64_t(w) * 3, cuuint64_t(h), cuuint64_t(n)};
  cuuint64_t strides[2] = {cuuint64_t(w) * 6, cuuint64_t(w) * 6 * cuuint64_t(h)};
  cuuint32_t box[3] = {kImgElems, kImgRows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The image as a 4-D map (n, h, 3 w / 8, 8) of bf16 for the stem: boxes of 8
// elements x 50 chunks x 21 rows of one image, unswizzled, zeros past every
// edge (conv1's padding).
bool encode_image_chunks(CUtensorMap* map, const void* x, int n, int h, int w) {
  auto fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[4] = {8, cuuint64_t(w) * 3 / 8, cuuint64_t(h), cuuint64_t(n)};
  cuuint64_t strides[3] = {16, cuuint64_t(w) * 6, cuuint64_t(w) * 6 * cuuint64_t(h)};
  cuuint32_t box[4] = {8, kStemImgChunks, kStemImgRows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The stem's output as a 4-D map (n, h/2, w/2, 64) of bf16: boxes of 64
// channels x 62 pixels of one row, 128-byte swizzle; a store writes none of
// a box that lies past the edges.
bool encode_stem_out(CUtensorMap* map, void* y, int n, int h2, int w2) {
  auto fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[4] = {64, cuuint64_t(w2), cuuint64_t(h2), cuuint64_t(n)};
  cuuint64_t strides[3] = {128, cuuint64_t(w2) * 128, cuuint64_t(w2) * 128 * cuuint64_t(h2)};
  cuuint32_t box[4] = {64, kStemTileCols, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

StemArgs stem_args(const void* prm, const void* ops, int n, int h, int w) {
  StemArgs a;
  a.prm = static_cast<const float*>(prm);
  a.ops = static_cast<const char*>(ops);
  a.h = h;
  a.w = w;
  a.tiles_x = (w / 2 + kStemTileCols - 1) / kStemTileCols;
  a.tiles_y = h / 2 / kStemTileRows;
  a.tiles = a.tiles_x * a.tiles_y * n;
  return a;
}

int launch_stem_wgmma(const void* x, void* y, const void* prm, const void* ops, int n, int h,
                      int w, cudaStream_t stream) {
  if (n < 1 || !stem_supported(h, w)) return -1;
  CUtensorMap map_x, map_y;
  if (!encode_image_chunks(&map_x, x, n, h, w) || !encode_stem_out(&map_y, y, n, h / 2, w / 2))
    return -3;
  const StemArgs a = stem_args(prm, ops, n, h, w);
  cudaError_t err = cudaFuncSetAttribute(stem_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStemWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_wgmma_kernel<<<std::min(sm_count(), a.tiles), kStemThreads, kStemWgSmem, stream>>>(
      map_x, map_y, a);
  return static_cast<int>(cudaGetLastError());
}

B1Args block1_args(const void* x, void* y, const void* prm, const void* ops, int n, int h,
                   int w) {
  B1Args a;
  a.prm = static_cast<const float*>(prm);
  a.ops = static_cast<const char*>(ops);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.h = h;
  a.w = w;
  a.tiles_x = w / 4 / kB1Tile;
  a.tiles_y = (h / 4 + kB1Tile - 1) / kB1Tile;
  a.tiles = a.tiles_x * a.tiles_y * n;
  return a;
}

int launch_block1_wgmma(const void* x, void* y, const void* prm, const void* ops, int n, int h,
                        int w, cudaStream_t stream) {
  if (n < 1 || !block1_supported(h, w)) return -1;
  CUtensorMap map;
  if (!encode_image(&map, x, n, h, w)) return -3;
  const B1Args a = block1_args(x, y, prm, ops, n, h, w);
  cudaError_t err = cudaFuncSetAttribute(stem_block1_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kB1WgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_block1_wgmma_kernel<<<std::min(sm_count(), a.tiles), kWgThreadsB1, kB1WgSmem, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
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

// Number of bf16 elements in the operand buffer the bf16 stem + block1
// (block1 != 0) or the bf16 stem reads beside the f32 buffer
// (ops/entrychain.py::pack_operands): the stem's are its first two.
int entry_operand_count(int block1) { return (block1 ? kOpBytes : kOpConv2 + kOpConv2Bytes) / 2; }

// x (n,h,w,3) -> y (n,h/2,w/2,64). bf16 != 0: bfloat16 I/O by
// stem_wgmma_kernel, prm the stem's f32 buffer (its affines are read), ops
// its bf16 operands (-1 outside the gate, -3 when a tensor map cannot be
// made); else f32 I/O by the first version, which reads prm alone.
int entry_stem(const void* x, void* y, const void* prm, const void* ops, int n, int h, int w,
               int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stem_wgmma(x, y, prm, ops, n, h, w, s)
              : launch_stem<float>(x, y, static_cast<const float*>(prm), n, h, w, s);
}

// x (n,h,w,3) -> y (n,h/4,w/4,128). bf16 != 0: bfloat16 I/O by
// stem_block1_wgmma_kernel, prm the f32 buffer (affines, depthwise taps), ops
// the bf16 operands (-1 outside the gate, -3 when the image's tensor map
// cannot be made); else f32 I/O by the first version, which reads prm alone.
int entry_stem_block1(const void* x, void* y, const void* prm, const void* ops, int n, int h,
                      int w, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_block1_wgmma(x, y, prm, ops, n, h, w, s)
              : launch_stem_block1<float>(x, y, static_cast<const float*>(prm), n, h, w, s);
}

// stem_block1_wgmma_kernel's plan for a (n, h, w, 3) image (sms <= 0: the
// current device's SM count), 47 ints as ops/entrychain.py::plan_ints
// orders them: tile rows, columns; tiles across, down, images; grid;
// threads; shared memory bytes; (offset, bytes) of W0, W1, A0, A1, c1, x4,
// x3, x2, the patch, the f32 depthwise parameters, the mbarriers, the
// affines as float4s; rows and columns of
// c1, x2, x3, x4; M tiles of conv1, conv2, the skip, pw1, pw2, pw3; the
// chunks before it whose taps a chunk's epilogue waits for (kTapWaits).
// Returns -1 outside the gate.
int entry_plan(int n, int h, int w, int sms, int* out) {
  if (n < 1 || !block1_supported(h, w)) return -1;
  const B1Args a = block1_args(nullptr, nullptr, nullptr, nullptr, n, h, w);
  const int v[47] = {kB1Tile, kB1Tile, a.tiles_x, a.tiles_y, n,
                     std::min(sms > 0 ? sms : sm_count(), a.tiles), kWgThreadsB1, kB1WgSmem,
                     kW0, kW1 - kW0, kW1, kSlot0 - kW1, kSlot0, kSlot1 - kSlot0, kSlot1, kX - kSlot1,
                     kC1, 4 * kC1PlaneBytes, kX4, kX4Pix * kX34Px, kX3, kX3Pix * kX34Px,
                     kX2, kX2Pix * kX2Px, kImg, kImgBytes, kPrm, kPrmFloats * 4, kBar, kBars * 8,
                     kAff, kAffFloats * 4,
                     kC1W, kC1W, kX2W, kX2W, kX3W, kX3W, kX4W, kX4W,
                     kMT1, kMT2, 1, kMT3, kMT4, 1, kTapWaits};
  for (int i = 0; i < 47; ++i) out[i] = v[i];
  return 0;
}

// stem_wgmma_kernel's plan for a (n, h, w, 3) image (sms <= 0: the current
// device's SM count), 32 ints as ops/entrychain.py::stem_plan_ints orders
// them: tile rows, columns, raster width; tiles across, down, images; grid;
// threads; shared memory bytes; (offset, bytes) of conv2's A, conv1's B, the
// staging slots, the c1 buffers, the patches, the affines, the mbarriers;
// c1 rows, pixels a c1 plane; conv1's M
// tiles, conv2's chains and their N; the patch box's rows and chunks; the
// output box's pixels; bytes a staging slot. Returns -1 outside the gate.
int stem_plan(int n, int h, int w, int sms, int* out) {
  if (n < 1 || !stem_supported(h, w)) return -1;
  const StemArgs a = stem_args(nullptr, nullptr, n, h, w);
  const int v[32] = {kStemTileRows, kStemTileCols, kStemRaster, a.tiles_x, a.tiles_y, n,
                     std::min(sms > 0 ? sms : sm_count(), a.tiles), kStemThreads, kStemWgSmem,
                     kSW2, kOpConv2Bytes, kSW1, kOpConv1Bytes, kSStage, kSC1 - kSStage,
                     kSC1, 2 * kStemC1Bytes, kSImg, 2 * kSImgStride, kSRaw, kSRawBytes,
                     kSBar, kStemBars * 8,
                     kStemC1Rows, kStemPlanePix, kStemMT1, kStemChains, kStemChainN,
                     kStemImgRows, kStemImgChunks, kStemTileCols, kSSlot};
  for (int i = 0; i < 32; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
