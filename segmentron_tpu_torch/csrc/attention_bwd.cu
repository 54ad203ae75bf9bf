// Flash-attention backward for training, hand-written for Hopper (sm_90a):
//
//   p_ij = exp(scale * q_i . k_j - lse_i),  dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - delta_i),          delta_i = do_i . o_i,
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i.
//
// q, k (N,P,Dk), v, do (N,P,Dv), contiguous, bf16 or f32; lse (the forward's
// log-sum-exp) and delta (N,P) f32, delta computed by the caller; dq, dk, dv in
// the inputs' type. Replaces the two Pallas kernels of
// segmentron_tpu/ops/attention.py's _attention_pallas_bwd: _flash_bwd_dq_kernel
// (dq_launch here) and _flash_bwd_dkv_kernel (dkv_launch). The work is split
// as there: a dq block owns a tile of query rows and loops over all key tiles;
// a dk/dv block owns a tile of key rows and loops over all query tiles. Nothing
// carries between blocks and there are no atomics; the TPU kernels' sequential
// grid dimension is the loop inside a block here. Rows >= P are read as zeros
// (TMA's fill in bf16, cp.async's in f32) and not stored.
//
// Rounding: the Pallas kernels cast q, k, v and do to f32 and take all five
// products in f32. Here, for bf16 inputs, s = q . k^T and dp = do . v^T run on
// wgmma (bf16 operands, f32 accumulation), the same math up to summation
// order. The other three products (ds . k, ds^T . q, p^T . do) have the f32 p
// or ds as left operand: it is fed as a hi + lo pair of bf16 (hi = bf16(x), lo
// = bf16(x - hi)) in two wgmma into one f32 sum, which keeps ~16 bits of it
// (relative error ~2^-17) instead of the 8 of one bf16. (Rounding p and ds to
// a single bf16, as FlashAttention-2 does, halves those products and stays
// inside chip_smoke.py's bf16 bar at ~0.6-0.7 of its L2 term, against ~0.02
// for the pair: tests/test_torch_attention_bwd_bf16.py; a different result,
// not taken here.) f32 inputs: all five products on the tensor cores in split
// TF32 (mma.sync m16n8k8 tf32; each operand x as hi = tf32(x) and lo =
// tf32(x - hi), rounded to nearest with ties away from zero; lo . hi + hi .
// lo, then hi . hi, into f32; lo . lo dropped), which keeps ~21 bits of every
// operand, s = q . k^T included (at a scale of 1 an error in s is an error
// relative to p). No bf16 on the f32 route, and nothing reads torch.backends'
// TF32 switches. Sums are f32; dq and dk are scaled at the end; one cast at
// the store.
//
// Bound on an H100 (SXM, 700 W) at the train shapes (576x576 crops, output
// stride 8, P = 72 * 72 = 5184, batch 16): the dq pass does 2 P^2 (2 Dk + Dv)
// per image, the dk/dv pass 2 P^2 (2 Dk + 2 Dv), not counting the lo halves.
// DANet's PAM (Dk 64, Dv 512): 0.550 and 0.991 TFLOP, 0.556 and 1.002 ms at the
// 989 TFLOP/s bf16 peak; OCNet's base block (Dk 256, Dv 512): 0.881 and 1.321
// TFLOP, 0.890 and 1.336 ms. Bound by operations: the bytes (q, k, v, do, dq,
// dk, dv once) take ~0.1 ms at 3.35 TB/s. The lo halves add 2 P^2 Dk (dq) and
// 2 P^2 (Dk + Dv) (dk/dv) of products the bound leaves out. In f32, split TF32
// issues three products for each: at the 495 TFLOP/s TF32 peak 3.34 and 6.00
// ms (DANet), 5.34 and 8.01 ms (OCNet); the CUDA cores' FMA at 67 TFLOP/s
// would take 8.21 and 14.79 ms, 13.14 and 19.71 ms.
//
// Design, bf16 (two consumer warpgroups of 128 threads a block, one block an
// SM; warp 0 also issues the copies; wgmma m64nNk16 with f32 accumulators;
// every operand tile in shared memory is TMA's 128-byte-swizzled layout of
// 64-column boxes, Dk padded to 64, 128 or 256 by TMA's zero fill):
//   dk/dv: 64 keys (the M of every product), k and v resident (TMA once);
//     query tiles of 32 (q, do by TMA; lse, delta by 4-byte cp.async into the
//     same stage) stream through a ring of 2-4 stages with a full and an
//     empty mbarrier each (DkvPlan: the most that fit 227 KB; 2 at Dk 256 and
//     Dv 512, 3 at Dk 64). s^T = k . q^T and dp^T = v . do^T are split by
//     their depth: warpgroup w takes Dk's and Dv's half w (m64n32k16, A = k or
//     v in shared memory, B = q or do, K-major), and the two partial sums meet
//     in shared memory (32 KB, two named barriers a tile), so both warpgroups
//     hold all of s^T and dp^T. p^T and ds^T are then formed in registers and
//     are, as they stand, A fragments (hi and lo) of dv[:, w Dv/2..] += p^T .
//     do and dk[:, w Dk/2..] += ds^T . q (B = the stage's do or q, MN-major:
//     wgmma's transpose bit, no transposed copy). Dv = 512 is why: dv of 64
//     keys is 64 x 512 f32, 256 registers a thread on one warpgroup, so each
//     warpgroup keeps half of dv and of dk (at Dk 64 all of dk's columns for
//     one of the tile's two k-steps of queries, the two sums meeting at the
//     end: a branch around a wgmma that differs between the warpgroups makes
//     ptxas serialise every wgmma of the kernel): 192 accumulator registers
//     at Dk 256, Dv 512, which leaves no room for a second tile's s^T and
//     dp^T in flight. A producer warpgroup would cap the consumers at 168
//     registers without setmaxnreg (384 threads), so warp 0 issues the
//     copies after it releases a stage.
//   dq: 64 queries, q and do resident; key tiles of 32 (k, v by TMA) stream
//     through a ring of 2 or 4 stages (DqPlan; even, so that warpgroup w takes
//     tiles w, w + 2, ... and refills its own stages with no wait on the
//     other). Each warpgroup keeps a whole dq sum of the 64 rows over its
//     tiles (Dk/2 registers): s = q . k^T and dp = do . v^T (m64n32k16, A =
//     q or do resident), ds = p (dp - delta) in registers, the A fragments
//     (hi and lo) of dq += ds . k (m64nDKPk16, B = the stage's k, MN-major).
//     The two sums meet in shared memory at the end. The two warpgroups run
//     out of step, so one's exponentials overlap the other's products.
//   Re-reads from L2 (no cluster): dk/dv reads q and do once a 64-key block,
//   81 blocks an image at P = 5184: 10.3 GB a pass at OCNet (1536 bytes a
//   query row), 7.7 GB at DANet (1152), half of the former 32-key blocks';
//   dq reads k and v once a 64-query block: 10.3 / 7.7 GB. TMA streams them
//   at ~9-12 TB/s from L2 (chip_smoke.py --flash-bwd-probe: "loads only"),
//   and the ring hides all but 10-14 % of it ("no loads"), so a cluster sharing
//   each stage by multicast is not needed first: the kernels are bound by
//   their serial phases (products, the exchange, exponentials, products),
//   not by the copies; in dk/dv the p and ds products take the most (their
//   probe build without them saves more than half). Registers (ptxas):
//   dk/dv 255 with 72 bytes of spill at Dk 256, Dv 512, 251 at Dk 64; dq
//   227 at Dk 256, 104 at Dk 64. Probe builds (times only, wrong results):
//   ATTN_BWD_NO_LOADS copies nothing after the first ring fill,
//   ATTN_BWD_LOADS_ONLY does no math, ATTN_BWD_NO_SDP, _NO_GRAD and
//   _NO_EXCHANGE leave out one phase of it.
// f32 (8 warps, split TF32, below): dq keeps q and do of 64 query rows resident
//   and streams k and v through a cp.async ring in 32-column chunks, ds never
//   leaving registers; dk/dv keeps k and v of 32 keys resident, q and do
//   tiles of 32 queries stream through, p and ds go through shared memory.
//
// C interface: each launch function returns cudaGetLastError() after the
// launch, -1 for a shape (or, in bf16, a base not 16-byte aligned) the kernels
// do not take, -2 where a TMA tensor map cannot be made;
// flash_attention_bwd_plan gives the bf16 kernels' tiles.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;      // (n,p,dqk)
  const void* k;      // (n,p,dqk)
  const void* v;      // (n,p,dv)
  const void* dout;   // (n,p,dv)
  const float* lse;   // (n,p)
  const float* delta; // (n,p)
  void* dq;           // (n,p,dqk)
  void* dk;           // (n,p,dqk)
  void* dv;           // (n,p,dv)
  int n, p, dqk;
  float scale;
};

// 16-byte asynchronous copy to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

#ifdef ATTN_BWD_MMA_PEAK
// The wgmma m64nNk16 bf16 rate: each warpgroup chains iters groups of four
// (a 64-deep product, one group left in flight) on shared memory that
// nothing writes; A from shared memory or (RS) from registers, B K-major or
// (TB) MN-major in 64-column boxes of 64 rows.
template <int N, bool RS, int TB>
__global__ void __launch_bounds__(384, 1) wgmma_peak_kernel(float* out, int iters) {
  __shared__ __align__(1024) char buf[8192 + 32768];
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, threadIdx.x + 3u};
  const uint64_t da = sw128_desc(buf, 16, 1024);
  const uint64_t db = TB ? sw128_desc(buf + 8192, 64 * 128, 1024) : sw128_desc(buf + 8192, 16, 1024);
  const int step = TB ? 2048 / 16 : 2;  // a k-step of 16: 16 rows, or 32 bytes of a row
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (RS) {
        Wgmma<N>::template rs<TB>(d, a, db + step * kk, 1);
      } else {
        Wgmma<N>::template ss<TB>(d, da + 2 * kk, db + step * kk, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += d[i];
  if (sum == 1.2345f) out[threadIdx.x] = sum;
}
#endif

// ------------------------------------------------------------------- bf16
// The design is in the note at the head of the file. A block is two
// consumer warpgroups (256 threads, up to 255 registers each); warp 0 also
// issues the copies. Dk is padded to DKP = 64, 128 or 256 columns: TMA's
// zero fill past Dk makes the padding's products zero, and its columns are
// not stored. Rows past P are zero-filled too, so no mask is needed: a key
// row past P gives dk/dv rows that are not stored and, in dq, k = 0 rows
// that add nothing to dq; a query row past P has q = do = 0 (and lse =
// delta = 0), so its p = 1 and ds = 0 meet zero rows in dv += p^T . do and
// dk += ds^T . q.
constexpr int kBfThreads = 256;
constexpr int kBfSmemMax = 232448;  // an H100 block's dynamic shared memory
#ifdef ATTN_BWD_LOADS_ONLY
constexpr bool kBfMath = false;
#else
constexpr bool kBfMath = true;
#endif
#ifdef ATTN_BWD_NO_LOADS
constexpr bool kBfLoads = false;
#else
constexpr bool kBfLoads = true;
#endif
// Probe builds of the math's phases (times only, wrong results): without
// the s and dp products, without the products of p and ds (dv, dk, dq),
// without dk/dv's exchange of partial sums.
#ifdef ATTN_BWD_NO_SDP
constexpr bool kBfSdp = false;
#else
constexpr bool kBfSdp = true;
#endif
#ifdef ATTN_BWD_NO_GRAD
constexpr bool kBfGrad = false;
#else
constexpr bool kBfGrad = true;
#endif
#ifdef ATTN_BWD_NO_EXCHANGE
constexpr bool kBfExchange = false;
#else
constexpr bool kBfExchange = true;
#endif

// The A fragment of k-step kk (columns 16 kk..) of an accumulator x of
// m64nN, split into hi = bf16(x) and lo = bf16(x - hi). A fragment register
// i holds rows g (i even) or g + 8 (i odd) of the 8-column chunk 2 kk + i / 2,
// which is x[4 (2 kk + i / 2) + 2 (i % 2)], + 1.
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R], int kk, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * (2 * kk + i / 2) + 2 * (i % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[r], x[r + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = bf16x2(x[r] - hf.x, x[r + 1] - hf.y);
  }
}

// Shared memory of the two kernels (bytes, with 1 KB of slack to align the
// tiles to the swizzle's 1 KB) and the stages they take.
template <int DKP, int DV> struct DkvPlan {
  static constexpr int kBK = 64, kBQ = 32;  // resident keys; queries a stage
  static constexpr int kK = tile_bytes(kBK, DKP), kV = tile_bytes(kBK, DV);
  static constexpr int kQ = tile_bytes(kBQ, DKP), kStage = kQ + tile_bytes(kBQ, DV);
  static constexpr int kX = 2 * 128 * kBQ * 4;  // the warpgroups' partial s^T and dp^T
  static constexpr int kStats = 2 * kBQ * 4;    // lse and delta of a stage
  __host__ __device__ static constexpr int bytes(int stages) {
    return 1024 + kK + kV + stages * (kStage + kStats) + kX + (2 * stages + 1) * 8;
  }
  __host__ __device__ static constexpr int stages() {
    return bytes(4) <= kBfSmemMax ? 4 : bytes(3) <= kBfSmemMax ? 3 : 2;
  }
  static_assert(bytes(2) <= kBfSmemMax, "dk/dv does not fit");
};
template <int DKP, int DV> struct DqPlan {
  static constexpr int kBQ = 64, kBK = 32;  // resident queries; keys a stage
  static constexpr int kQ = tile_bytes(kBQ, DKP), kDo = tile_bytes(kBQ, DV);
  static constexpr int kK = tile_bytes(kBK, DKP), kStage = kK + tile_bytes(kBK, DV);
  static constexpr int kSum = 128 * (DKP / 2) * 4;  // warpgroup 1's dq, over the ring
  __host__ __device__ static constexpr int ring(int stages) {
    return stages * kStage > kSum ? stages * kStage : kSum;
  }
  __host__ __device__ static constexpr int bytes(int stages) {
    return 1024 + kQ + kDo + ring(stages) + (stages + 1) * 8; }
  // even: each warpgroup refills the stages it reads
  __host__ __device__ static constexpr int stages() { return bytes(4) <= kBfSmemMax ? 4 : 2; }
  static_assert(bytes(2) <= kBfSmemMax, "dq does not fit");
};

// dk/dv: keys k0..k0+63 of image b. Warpgroup w computes the partial s^T and
// dp^T over its half of Dk and Dv (wgmma m64n32k16, A = k or v resident, B =
// the stage's q or do), the halves meet in shared memory, and both then hold
// all of s^T and dp^T: p^T and ds^T become A fragments in registers (hi and
// lo) for dv[:, w Dv/2..] += p^T . do and dk[:, cols] += ds^T . q, B the
// stage's do and q, MN-major. dk's columns: w DKP/2.. (DKP >= 128), or all
// 64 for the tile's k-step of queries w, the two sums meeting at the end.
template <int DKP, int DV>
__global__ void __launch_bounds__(kBfThreads, 1)
    dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, Args a, int stages) {
  using L = DkvPlan<DKP, DV>;
  constexpr int kBK = L::kBK, kBQ = L::kBQ;
  constexpr int kDvN = DV / 2;                      // dv columns of a warpgroup
  // dk is split by columns (DKP >= 128), or else by the tile's two k-steps of
  // queries, each warpgroup then holding all 64 columns: with no branch
  // around a wgmma (a branch that differs between warpgroups makes ptxas
  // serialise every wgmma of the kernel)
  constexpr bool kDkSplit = DKP >= 128;
  constexpr int kDkN = kDkSplit ? DKP / 2 : DKP;  // dk columns of a warpgroup
  static_assert(kBQ == 32, "a lane of warp 0 copies lse and delta of one query");
  extern __shared__ char smem_raw[];
  char* sk = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  char* sv = sk + L::kK;
  char* ring = sv + L::kV;
  float4* xbuf = reinterpret_cast<float4*>(ring + stages * L::kStage);
  float* stats = reinterpret_cast<float*>(ring + stages * L::kStage + L::kX);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + stages * 2 * kBQ);
  uint64_t* empty = full + stages;
  uint64_t* kvbar = empty + stages;

  const int b = blockIdx.y, k0 = blockIdx.x * kBK, p = a.p;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nq = (p + kBQ - 1) / kBQ;
  const bool issuer = threadIdx.x < 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 33);  // 32 lanes' lse/delta copies + the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Query tile it into stage s (warp 0): q and do by TMA, lse and delta by
  // 4-byte cp.async (zero past P; P need not be a multiple of 4).
  auto issue = [&](int it, int s) {
    if (!kBfLoads && it >= stages) {  // probe: no copies after the first
      mbar_arrive(&full[s]);
      if (lane == 0) mbar_arrive(&full[s]);
      return;
    }
    const int i0 = it * kBQ;
    char* st = ring + s * L::kStage;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], L::kStage);
#pragma unroll
      for (int c = 0; c < DKP / 64; ++c)
        tma_load_3d(st + c * kBQ * 128, &map_q, 64 * c, i0, b, &full[s]);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
        tma_load_3d(st + L::kQ + c * kBQ * 128, &map_do, 64 * c, i0, b, &full[s]);
    }
    const bool valid = i0 + lane < p;
    const size_t off = size_t(b) * p + (valid ? i0 + lane : 0);
    float* sst = stats + s * 2 * kBQ;
    cp_async4(sst + lane, a.lse + off, valid);
    cp_async4(sst + kBQ + lane, a.delta + off, valid);
    cp_async_arrive_noinc(&full[s]);
  };
  if (issuer) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, L::kK + L::kV);
#pragma unroll
      for (int c = 0; c < DKP / 64; ++c)
        tma_load_3d(sk + c * kBK * 128, &map_k, 64 * c, k0, b, kvbar);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
        tma_load_3d(sv + c * kBK * 128, &map_v, 64 * c, k0, b, kvbar);
    }
    for (int it = 0; it < stages && it < nq; ++it) issue(it, it);
  }

  // accumulators: keys 16 warp + g (+8), columns 8 j + 2t (+1) of the
  // warpgroup's dv and dk columns
  float dv[kDvN / 2], dk[kDkN / 2];
#pragma unroll
  for (int i = 0; i < kDvN / 2; ++i) dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kDkN / 2; ++i) dk[i] = 0.f;
  const int dk_n0 = kDkSplit ? wg * kDkN : 0;
  const int kc0 = wg * (DKP / 2), vc0 = wg * kDvN;  // this warpgroup's halves of Dk, Dv
  mbar_wait(kvbar, 0);

  for (int it = 0; it < nq; ++it) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const char* sq = ring + s * L::kStage;
    const char* sdo = sq + L::kQ;
    const float* sst = stats + s * 2 * kBQ;
    if (kBfMath) {
      // 1. partial s^T = k . q^T over Dk's half, dp^T = v . do^T over Dv's
      float st[16], dpt[16];
#pragma unroll
      for (int i = 0; !kBfSdp && i < 16; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kBfSdp && kk < DKP / 32; ++kk)
        Wgmma<32>::ss<0>(st, kmajor_desc(sk, kBK, 0, kc0 + 16 * kk),
                         kmajor_desc(sq, kBQ, 0, kc0 + 16 * kk), kk);
#pragma unroll
      for (int kk = 0; kBfSdp && kk < DV / 32; ++kk)
        Wgmma<32>::ss<0>(dpt, kmajor_desc(sv, kBK, 0, vc0 + 16 * kk),
                         kmajor_desc(sdo, kBQ, 0, vc0 + 16 * kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // 2. the two halves meet (the same sums in both: addition commutes)
      float4* mine = xbuf + wg * 8 * 128 + tid;
      const float4* other = xbuf + (1 - wg) * 8 * 128 + tid;
#pragma unroll
      for (int j = 0; kBfExchange && j < 4; ++j) {
        mine[j * 128] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]);
        mine[(4 + j) * 128] =
            make_float4(dpt[4 * j], dpt[4 * j + 1], dpt[4 * j + 2], dpt[4 * j + 3]);
      }
      if (kBfExchange) named_sync(1, kBfThreads);
#pragma unroll
      for (int j = 0; kBfExchange && j < 4; ++j) {
        const float4 o = other[j * 128], od = other[(4 + j) * 128];
        const float so[4] = {o.x, o.y, o.z, o.w}, sd[4] = {od.x, od.y, od.z, od.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[4 * j + e] += so[e];
          dpt[4 * j + e] += sd[e];
        }
      }
      if (kBfExchange) named_sync(2, kBfThreads);  // both have read before either writes again
      // 3. p^T = exp(scale s^T - lse), ds^T = p^T (dp^T - delta); query 8 j + 2t + e
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float lse = sst[col], delta = sst[kBQ + col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 4 * j + 2 * h + e;
            const float pr = expf(st[r] * a.scale - lse);
            st[r] = pr;
            dpt[r] = pr * (dpt[r] - delta);
          }
        }
      }
      // 4. dv += p^T . do, dk += ds^T . q: hi, then lo, for each k-step of 16 queries
      uint32_t ph[2][4], pl[2][4], dh[2][4], dl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        split_frag(st, kk, ph[kk], pl[kk]);
        split_frag(dpt, kk, dh[kk], dl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kBfGrad && kk < 2; ++kk) {
        const uint64_t bdo = mnmajor_desc(sdo, kBQ, 16 * kk, vc0);
        Wgmma<kDvN>::template rs<1>(dv, ph[kk], bdo, 1);
        Wgmma<kDvN>::template rs<1>(dv, pl[kk], bdo, 1);
        if constexpr (kDkSplit) {
          const uint64_t bq = mnmajor_desc(sq, kBQ, 16 * kk, dk_n0);
          Wgmma<kDkN>::template rs<1>(dk, dh[kk], bq, 1);
          Wgmma<kDkN>::template rs<1>(dk, dl[kk], bq, 1);
        }
      }
      uint32_t ah[4], al[4];  // Dk 64: warpgroup w takes k-step w
      if constexpr (!kDkSplit) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = wg ? dh[1][i] : dh[0][i];
          al[i] = wg ? dl[1][i] : dl[0][i];
        }
        const uint64_t bq = mnmajor_desc(sq, kBQ, 16 * wg, 0);
        if (kBfGrad) {
          Wgmma<kDkN>::template rs<1>(dk, ah, bq, 1);
          Wgmma<kDkN>::template rs<1>(dk, al, bq, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
      if constexpr (!kDkSplit) {
        fence_regs(ah);
        fence_regs(al);
      }
    }
    // 5. the stage is free once both warpgroups are done with it; warp 0 refills it
    if (lane == 0) mbar_arrive(&empty[s]);
    if (issuer && it + stages < nq) {
      mbar_wait(&empty[s], (it / stages) & 1);
      issue(it + stages, s);
    }
  }

  if constexpr (!kDkSplit) {  // the warpgroups' halves of dk's sum meet (xbuf is free)
    float4* x = xbuf + tid;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kDkN / 8; ++i)
        x[i * 128] = make_float4(dk[4 * i], dk[4 * i + 1], dk[4 * i + 2], dk[4 * i + 3]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kDkN / 8; ++i) {
        const float4 o = x[i * 128];
        dk[4 * i] += o.x;
        dk[4 * i + 1] += o.y;
        dk[4 * i + 2] += o.z;
        dk[4 * i + 3] += o.w;
      }
    }
  }
  bf16* dvo = static_cast<bf16*>(a.dv) + size_t(b) * p * DV + vc0 + 2 * t;
  bf16* dko = static_cast<bf16*>(a.dk) + size_t(b) * p * a.dqk + dk_n0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g + 8 * h;
    if (key >= p) continue;
#pragma unroll
    for (int j = 0; j < kDvN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dvo + size_t(key) * DV + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    if (!kDkSplit && wg == 1) continue;
#pragma unroll
    for (int j = 0; j < kDkN / 8; ++j)
      if (dk_n0 + 8 * j + 2 * t < a.dqk)
        *reinterpret_cast<__nv_bfloat162*>(dko + size_t(key) * a.dqk + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
  }
}

// dq: queries q0..q0+63 of image b, q and do resident; key tiles of 32
// stream through the ring, warpgroup w taking tiles w, w + 2, ... (the
// stages are even, so a warpgroup refills the stages it reads, with no
// wait on the other). Each warpgroup holds a whole dq sum for the 64 rows
// over its tiles: s = q . k^T and dp = do . v^T (m64n32k16, A resident, B
// the stage's k or v), ds = p (dp - delta) in registers as hi and lo A
// fragments of dq += ds . k (m64nDKPk16, B the stage's k, MN-major). The two
// sums meet in shared memory at the end.
template <int DKP, int DV>
__global__ void __launch_bounds__(kBfThreads, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do, Args a, int stages) {
  using L = DqPlan<DKP, DV>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK;
  extern __shared__ char smem_raw[];
  char* sq = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  char* sdo = sq + L::kQ;
  char* ring = sdo + L::kDo;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::ring(stages));
  uint64_t* qbar = full + stages;

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ, p = a.p;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nk = (p + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Key tile j into stage s (one thread).
  auto issue = [&](int j, int s) {
    if (!kBfLoads && j >= stages) {  // probe: no copies after the first
      mbar_arrive(&full[s]);
      return;
    }
    char* st = ring + s * L::kStage;
    mbar_arrive_expect_tx(&full[s], L::kStage);
#pragma unroll
    for (int c = 0; c < DKP / 64; ++c)
      tma_load_3d(st + c * kBK * 128, &map_k, 64 * c, j * kBK, b, &full[s]);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_3d(st + L::kK + c * kBK * 128, &map_v, 64 * c, j * kBK, b, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qbar, L::kQ + L::kDo);
#pragma unroll
    for (int c = 0; c < DKP / 64; ++c)
      tma_load_3d(sq + c * kBQ * 128, &map_q, 64 * c, q0, b, qbar);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_3d(sdo + c * kBQ * 128, &map_do, 64 * c, q0, b, qbar);
    for (int j = 0; j < stages && j < nk; ++j) issue(j, j);
  }

  // this thread's rows: 16 warp + g + 8 h
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    const size_t i = size_t(b) * p + (row < p ? row : 0);
    lse[h] = row < p ? a.lse[i] : 0.f;
    delta[h] = row < p ? a.delta[i] : 0.f;
  }
  float acc[DKP / 2];  // rows 16 warp + g (+8), columns 8 j + 2t (+1)
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int j = wg; j < nk; j += 2) {
    const int s = j % stages;
    mbar_wait(&full[s], (j / stages) & 1);
    const char* sk = ring + s * L::kStage;
    const char* sv = sk + L::kK;
    if (kBfMath) {
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; !kBfSdp && i < 16; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kBfSdp && kk < DKP / 16; ++kk)
        Wgmma<32>::ss<0>(sc, kmajor_desc(sq, kBQ, 0, 16 * kk), kmajor_desc(sk, kBK, 0, 16 * kk),
                         kk);
#pragma unroll
      for (int kk = 0; kBfSdp && kk < DV / 16; ++kk)
        Wgmma<32>::ss<0>(dp, kmajor_desc(sdo, kBQ, 0, 16 * kk),
                         kmajor_desc(sv, kBK, 0, 16 * kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // ds = p (dp - delta), p = exp(scale s - lse); row h, key 8 c + 2t + e
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * c + 2 * h + e;
            dp[r] = expf(sc[r] * a.scale - lse[h]) * (dp[r] - delta[h]);
          }
      uint32_t dh[2][4], dl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) split_frag(dp, kk, dh[kk], dl[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kBfGrad && kk < 2; ++kk) {
        const uint64_t bk = mnmajor_desc(sk, kBK, 16 * kk, 0);
        Wgmma<DKP>::template rs<1>(acc, dh[kk], bk, 1);
        Wgmma<DKP>::template rs<1>(acc, dl[kk], bk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dh);
      fence_regs(dl);
    }
    named_sync(1 + wg, 128);  // the warpgroup is done with stage s
    if (tid == 0 && j + stages < nk) issue(j + stages, s);
  }

  // warpgroup 1's sum to shared memory (over the ring: every tile is in and
  // read), added by warpgroup 0 and stored
  __syncthreads();
  float4* xs = reinterpret_cast<float4*>(ring) + tid;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DKP / 8; ++i)
      xs[i * 128] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < DKP / 8; ++i) {
    const float4 o = xs[i * 128];
    acc[4 * i] += o.x;
    acc[4 * i + 1] += o.y;
    acc[4 * i + 2] += o.z;
    acc[4 * i + 3] += o.w;
  }
  bf16* dq = static_cast<bf16*>(a.dq) + size_t(b) * p * a.dqk + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= p) continue;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j)
      if (8 * j + 2 * t < a.dqk)
        *reinterpret_cast<__nv_bfloat162*>(dq + size_t(row) * a.dqk + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * a.scale, acc[4 * j + 2 * h + 1] * a.scale);
  }
}

// ------------------------------------------------------------- f32: split TF32
// Every product runs on mma.sync m16n8k8 tf32 with f32 accumulation. Each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round
// to nearest, ties away from zero) and a . b is taken as a_lo b_hi + a_hi b_lo
// and then a_hi b_hi into the f32 sum; a_lo b_lo is dropped. That keeps ~21
// bits of each operand against TF32's 10.
//
// Fragments of m16n8k8 tf32 (g = lane / 4, t = lane % 4), plain 32-bit shared
// loads (ldmatrix takes 16-bit elements only): A (16 x 8) holds (g, t), (g+8,
// t), (g, t+4), (g+8, t+4); B (8 x 8, k x n) holds (t, g), (t+4, g); C holds
// row g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1.
// The order of the 8 terms of a k-step is free as long as A and B agree. The
// products whose reduction runs over the rows of a stored matrix (ds . k,
// ds^T . q, p^T . do) take logical k = t from row 2t and k = t + 4 from row
// 2t + 1, so B reads (2t, g), (2t+1, g). With that order a C fragment of s is
// an A fragment as it stands (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and every
// fragment load of a row stride of 4 (mod 32) words hits 32 distinct banks in
// both orientations: (g, t) -> 4g + t, (2t, g) -> 8t + g. Every f32 buffer
// below has such a stride (widths are multiples of 16, plus 4).
constexpr int kPadF = 4;
constexpr int kChunk = 32;               // columns of a streamed chunk
constexpr int kLdc = kChunk + kPadF;     // its row stride
constexpr int kSmemCap = 232448;         // an H100 block's dynamic shared memory
#ifdef ATTN_BWD_LOADS_ONLY
constexpr bool kMath = false;
#else
constexpr bool kMath = true;
#endif

// Probe builds (chip_smoke.py --flash-bwd-probe; times only): ATTN_BWD_CVT
// rounds by cvt.rna.tf32.f32 instead (the same values for finite x);
// ATTN_BWD_NO_SPLIT feeds x's bits as hi and lo unrounded and
// ATTN_BWD_ONE_PASS takes hi . hi alone (both give wrong results);
// ATTN_BWD_NO_LOADS streams nothing after the first tiles and
// ATTN_BWD_LOADS_ONLY does none of the math (wrong results);
// ATTN_BWD_MMA_PEAK adds attention_bwd_mma_peak, the m16n8k8 tf32 issue rate.
//
// tf32(x), rounded to nearest with ties away from zero, for finite x: half a
// TF32 ulp is added to the bits and the 13 bits below TF32's mantissa are
// cleared (two integer instructions; cvt.rna.tf32.f32 lowers to four, with a
// guard for inf and NaN). lo's rounding leaves those 13 bits set: mma.sync
// reads a tf32 operand's upper 19 bits only, as ptxas's own lowering of
// cvt.rna does for a value that only feeds an mma.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
#if defined(ATTN_BWD_NO_SPLIT)
  hi = lo = __float_as_uint(x);
#elif defined(ATTN_BWD_CVT)
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
#endif
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A fragment: x[0], x[8 rows], x[4], x[8 rows + 4], split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load(const float* x, int ld) {
    split_tf32(x[0], hi[0], lo[0]);
    split_tf32(x[8 * ld], hi[1], lo[1]);
    split_tf32(x[4], hi[2], lo[2]);
    split_tf32(x[8 * ld + 4], hi[3], lo[3]);
  }
  // The transpose of a stored [k][m] matrix in the row-pair order: x points at
  // (2t, g); a0 (2t, g), a1 (2t, g+8), a2 (2t+1, g), a3 (2t+1, g+8).
  __device__ __forceinline__ void load_t(const float* x, int ld) {
    split_tf32(x[0], hi[0], lo[0]);
    split_tf32(x[8], hi[1], lo[1]);
    split_tf32(x[ld], hi[2], lo[2]);
    split_tf32(x[ld + 8], hi[3], lo[3]);
  }
};
// B fragment from two elements (t, g) and (t+4, g) of the k x n operand.
struct FragB {
  uint32_t hi0, lo0, hi1, lo1;
  __device__ __forceinline__ FragB(float x0, float x1) {
    split_tf32(x0, hi0, lo0);
    split_tf32(x1, hi1, lo1);
  }
};
// d += a . b, split TF32: the cross terms first, then hi . hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
#ifndef ATTN_BWD_ONE_PASS
  mma_tf32(d, a.lo, b.hi0, b.hi1);
  mma_tf32(d, a.hi, b.lo0, b.lo1);
#endif
  mma_tf32(d, a.hi, b.hi0, b.hi1);
}

#ifdef ATTN_BWD_MMA_PEAK
// chains independent accumulators of iters mma.sync m16n8k8 tf32 each
template <int CHAINS>
__global__ void mma_peak_kernel(float* out, int iters) {
  float d[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, threadIdx.x + 3u};
  const uint32_t b0 = threadIdx.x * 3u, b1 = blockIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma_tf32(d[c], a, b0, b1);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (sum == 1.2345f) out[threadIdx.x] = sum;
}
#endif

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Columns c0..c0+cols-1 of rows row0..row0+rows-1 of a (p, width) f32 matrix
// into shared memory with row stride ld; rows >= p read as zeros.
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src, int row0, int rows,
                                          int width, int c0, int cols, int p) {
  const int vecs = cols / 4;
  for (int u = threadIdx.x; u < rows * vecs; u += kThreads) {
    const int r = u / vecs, c = (u - r * vecs) * 4;
    const bool valid = row0 + r < p;
    cp_async16(dst + r * ld + c, src + size_t(valid ? row0 + r : 0) * width + c0 + c, valid);
  }
}

// acc[nt] (16 rows x 32 keys, n-tiles of 8) += x . y^T over ksteps k-steps of
// 8: x the 16 rows (row stride ldx) at their first column, y the 32 key rows
// (row stride kLdc) at theirs; both already offset by (g, t).
__device__ __forceinline__ void rows16_keys32(float (&acc)[4][4], const float* x, int ldx,
                                              const float* y, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < ksteps) {
      FragA a;
      a.load(x + 8 * kk, ldx);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* yp = y + 8 * nt * kLdc + 8 * kk;
        mma3(acc[nt], a, FragB(yp[0], yp[4]));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
}

// dq: a block owns 64 query rows; q and do of the block stay in shared memory
// (66 + 132 KB at Dk 256, Dv 512). Key tiles of 64 stream through a
// three-stage cp.async ring of 64 x 32 chunks that all eight warps fill: per
// tile the Dk chunks of k (s = q . k^T), the Dv chunks of v (dp = do . v^T),
// then the Dk chunks of k once more (dq += ds . k). Warp w owns rows
// 16 (w % 4).. and keys 32 (w / 4).. of each tile: s, dp and ds stay in its
// registers, and ds is the A operand of ds . k as it stands (the row-pair
// order). Its dq sum covers all Dk columns for its 16 rows and its half of
// the keys (KMAX / 2 registers, KMAX the Dk the launch sized them for: 64 or
// 256); the two halves meet in shared memory at the end.
template <int DV> struct DqF32Layout {
  static constexpr int kBQ = 64, kBK = 64, kStages = 3, kLdo = DV + kPadF;
  __host__ __device__ static constexpr int ldq(int dqk) { return dqk + kPadF; }
  __host__ __device__ static constexpr size_t do_off(int dqk) { return size_t(kBQ) * ldq(dqk); }
  __host__ __device__ static constexpr size_t ring_off(int dqk) {
    return do_off(dqk) + size_t(kBQ) * kLdo;
  }
  __host__ __device__ static constexpr size_t bytes(int dqk) {
    return (ring_off(dqk) + size_t(kStages) * kBK * kLdc) * sizeof(float);
  }
};

template <int DV, int KMAX>
__global__ void __launch_bounds__(kThreads, 1) dq_f32_kernel(Args a) {
  using L = DqF32Layout<DV>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kStages = L::kStages, kLdo = L::kLdo;
  constexpr int kNcv = DV / kChunk;
  static_assert(L::bytes(256) <= kSmemCap, "dq: shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + L::do_off(dqk);
  float* ring = sq + L::ring_off(dqk);

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const float* q = static_cast<const float*>(a.q) + size_t(b) * p * dqk;
  const float* k = static_cast<const float*>(a.k) + size_t(b) * p * dqk;
  const float* v = static_cast<const float*>(a.v) + size_t(b) * p * DV;
  const float* dout = static_cast<const float*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;

  // the chunk stream: per key tile nck chunks of k, kNcv of v, nck of k
  const int nck = (dqk + kChunk - 1) / kChunk, per_tile = 2 * nck + kNcv;
  const int nk = (p + kBK - 1) / kBK, total = nk * per_tile;
  auto issue = [&](int s) {
    if (s < total) {
      const int j = s / per_tile, r = s - j * per_tile;
      const bool is_v = r >= nck && r < nck + kNcv;
      const int c0 = kChunk * (r < nck ? r : is_v ? r - nck : r - nck - kNcv);
      const int width = is_v ? DV : dqk;
#ifndef ATTN_BWD_NO_LOADS
      load_cols(ring + (s % kStages) * kBK * kLdc, kLdc, is_v ? v : k, j * kBK, kBK, width, c0,
                min(kChunk, width - c0), p);
#endif
    }
    cp_async_commit();
  };
  // chunk s is in and every warp is done with chunk s - 1: its stage takes
  // chunk s + kStages - 1
  auto next = [&](int s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    return ring + (s % kStages) * kBK * kLdc;
  };

  load_cols(sq, ldq, q, q0, kBQ, dqk, 0, dqk, p);
  load_cols(sdo, kLdo, dout, q0, kBQ, DV, 0, DV, p);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float lse[2], delta[2];  // rows 16 rg + g, + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * rg + g + 8 * h;
    lse[h] = row < p ? a.lse[size_t(b) * p + row] : 0.f;
    delta[h] = row < p ? a.delta[size_t(b) * p + row] : 0.f;
  }
  const float* xq = sq + (16 * rg + g) * ldq + t;
  const float* xdo = sdo + (16 * rg + g) * kLdo + t;
  const int yoff = (32 * cg + g) * kLdc + t;      // s, dp: key rows g..
  const int doff = (32 * cg + 2 * t) * kLdc + g;  // ds . k: key rows 2t..

  float acc[KMAX / 8][4];  // rows 16 rg + g (+8), columns 8 nt + 2t
  zero_acc(acc);
  int s = 0;
  for (int j = 0; j < nk; ++j) {
    float sacc[4][4], dpacc[4][4];  // keys 32 cg + 8 nt + 2t of tile j
    zero_acc(sacc);
    zero_acc(dpacc);
    for (int r = 0; r < nck; ++r, ++s) {
      const float* st = next(s);
      if (kMath)
        rows16_keys32(sacc, xq + kChunk * r, ldq, st + yoff, min(4, (dqk - kChunk * r) / 8));
    }
    for (int r = 0; r < kNcv; ++r, ++s) {
      const float* st = next(s);
      if (kMath) rows16_keys32(dpacc, xdo + kChunk * r, kLdo, st + yoff, 4);
    }
    // p = exp(scale s - lse) (0 past P), ds = p (dp - delta), as A fragments
    FragA ds[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * kBK + 32 * cg + 8 * nt + 2 * t + e;
          const float pr = key < p ? expf(sacc[nt][2 * h + e] * a.scale - lse[h]) : 0.f;
          const int ai = h + 2 * e;  // c0 -> a0, c1 -> a2, c2 -> a1, c3 -> a3
          split_tf32(pr * (dpacc[nt][2 * h + e] - delta[h]), ds[nt].hi[ai], ds[nt].lo[ai]);
        }
#pragma unroll
    for (int c = 0; c < KMAX / kChunk; ++c) {
      if (c == nck) break;
      const float* st = next(s++) + doff;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!kMath || kChunk * c + 8 * i >= dqk) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const float* yp = st + 8 * ks * kLdc + 8 * i;
          mma3(acc[4 * c + i], ds[ks], FragB(yp[0], yp[kLdc]));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with q: it takes the key half 1 sums

  float* part = sq + (16 * rg + g) * ldq + 2 * t;
  if (cg == 1) {
#pragma unroll
    for (int nt = 0; nt < KMAX / 8; ++nt)
      if (8 * nt < dqk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(part + 8 * h * ldq + 8 * nt) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
  __syncthreads();
  if (cg == 0) {
    float* dq = static_cast<float*>(a.dq) + size_t(b) * p * dqk + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * rg + g + 8 * h;
      if (row >= p) continue;
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (8 * nt >= dqk) continue;
        const float2 o = *reinterpret_cast<const float2*>(part + 8 * h * ldq + 8 * nt);
        *reinterpret_cast<float2*>(dq + size_t(row) * dqk + 8 * nt) =
            make_float2((acc[nt][2 * h] + o.x) * a.scale, (acc[nt][2 * h + 1] + o.y) * a.scale);
      }
    }
  }
}

// dk/dv: a block owns 32 keys, whose k and v stay in shared memory; query
// tiles of 32 bring q and do (one buffer each, 99 KB at Dk 256, Dv 512: the
// next tile's q loads during p^T . do, its do during the next s). The dk and
// dv sums for 32 keys are 32 x (Dk + Dv) f32, 96 registers a thread at Dk 256,
// Dv 512, which is what caps the keys of a block. s and dp: warp w takes
// queries 16 (w % 2).., all 32 keys, and every fourth k-step from w / 2 of Dk
// and of Dv; the four partial sums meet in shared memory, each warp sums one
// n-tile of them and forms p and ds there ([query][key], f32). Then dk +=
// ds^T . q (warp w: key half w % 2, n-tiles w / 2 + 4 i) and dv += p^T . do
// (warp w: both key halves, the Dv / 8 columns from w Dv / 8), both with the
// query rows in the row-pair order.
template <int DV> struct DkvF32Layout {
  static constexpr int kBK = 32, kBQ = 32, kLdv = DV + kPadF, kLdp = kBK + kPadF;
  static constexpr int kPart = kWarps * 2 * 16 * 32;  // s and dp partials, floats
  __host__ __device__ static constexpr int ldq(int dqk) { return dqk + kPadF; }
  __host__ __device__ static constexpr size_t v_off(int dqk) { return size_t(kBK) * ldq(dqk); }
  __host__ __device__ static constexpr size_t q_off(int dqk) {
    return v_off(dqk) + size_t(kBK) * kLdv;
  }
  __host__ __device__ static constexpr size_t do_off(int dqk) {
    return q_off(dqk) + size_t(kBQ) * ldq(dqk);
  }
  __host__ __device__ static constexpr size_t part_off(int dqk) {
    return do_off(dqk) + size_t(kBQ) * kLdv;
  }
  __host__ __device__ static constexpr size_t bytes(int dqk) {
    return (part_off(dqk) + kPart) * sizeof(float);
  }
};

template <int DV, int KMAX>
__global__ void __launch_bounds__(kThreads, 1) dkv_f32_kernel(Args a) {
  using L = DkvF32Layout<DV>;
  constexpr int kBK = L::kBK, kBQ = L::kBQ, kLdv = L::kLdv, kLdp = L::kLdp;
  constexpr int kNJ = DV / kWarps / 8;  // dv n-tiles of a warp
  constexpr int kNI = KMAX / 32;        // dk n-tiles of a warp, at most
  static_assert(L::bytes(256) <= kSmemCap, "dk/dv: shared memory");
  static_assert(2 * kBQ * kLdp <= L::kPart, "p and ds fit where the partials were");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + L::v_off(dqk);
  float* sq = sk + L::q_off(dqk);
  float* sdo = sk + L::do_off(dqk);
  float* spart = sk + L::part_off(dqk);
  float* sp = spart;               // after the partials are summed: p, then ds
  float* sds = spart + kBQ * kLdp;

  const int b = blockIdx.y, k0 = blockIdx.x * kBK;
  const float* q = static_cast<const float*>(a.q) + size_t(b) * p * dqk;
  const float* k = static_cast<const float*>(a.k) + size_t(b) * p * dqk;
  const float* v = static_cast<const float*>(a.v) + size_t(b) * p * DV;
  const float* dout = static_cast<const float*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qh = warp & 1, kq = warp >> 1;  // s, dp: queries 16 qh.., k-steps kq + 4 i
  const int kmi = warp & 1, kn0 = warp >> 1;  // dk: key half kmi, n-tiles kn0 + 4 i
  const int dv0 = warp * (DV / kWarps);       // dv: this warp's columns

  load_cols(sk, ldq, k, k0, kBK, dqk, 0, dqk, p);
  load_cols(sv, kLdv, v, k0, kBK, DV, 0, DV, p);
  load_cols(sq, ldq, q, 0, kBQ, dqk, 0, dqk, p);
  cp_async_commit();
  load_cols(sdo, kLdv, dout, 0, kBQ, DV, 0, DV, p);
  cp_async_commit();

  float accv[2][kNJ][4];  // keys 16 mi + g (+8), columns dv0 + 8 nj + 2t
  float acck[kNI][4];     // keys 16 kmi + g (+8), columns 8 (kn0 + 4 i) + 2t
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero_acc(accv[mi]);
  zero_acc(acck);

  const float* xq = sq + (16 * qh + g) * ldq + t;
  const float* xdo = sdo + (16 * qh + g) * kLdv + t;
  const float* yk = sk + g * ldq + t;
  const float* yv = sv + g * kLdv + t;
  // this warp's partial sums, in fragment order: [warp][s|dp][nt][c][lane]
  float* mypart = spart + warp * 2 * 16 * 32 + lane;
  const bool key_ok[2] = {k0 + 8 * kq + 2 * t < p, k0 + 8 * kq + 2 * t + 1 < p};
  const int nkk = dqk / 8;
  const int nq = (p + kBQ - 1) / kBQ;
  for (int it = 0; it < nq; ++it) {
    const int i0 = it * kBQ;
    float lse[2], delta[2];  // the rows of this warp's n-tile of p: 16 qh + g (+8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + 16 * qh + g + 8 * h;
      lse[h] = row < p ? a.lse[size_t(b) * p + row] : 0.f;
      delta[h] = row < p ? a.delta[size_t(b) * p + row] : 0.f;
    }
    // 1. partial s and dp over every fourth k-step
    float sacc[4][4], dpacc[4][4];
    zero_acc(sacc);
    zero_acc(dpacc);
    cp_async_wait<1>();
    __syncthreads();  // q of tile it is in
    for (int kk = kq; kMath && kk < nkk; kk += 4) {
      FragA x;
      x.load(xq + 8 * kk, ldq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* yp = yk + 8 * nt * ldq + 8 * kk;
        mma3(sacc[nt], x, FragB(yp[0], yp[4]));
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // do of tile it is in
#pragma unroll 2
    for (int kk = kq; kMath && kk < DV / 8; kk += 4) {
      FragA x;
      x.load(xdo + 8 * kk, kLdv);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* yp = yv + 8 * nt * kLdv + 8 * kk;
        mma3(dpacc[nt], x, FragB(yp[0], yp[4]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mypart[(nt * 4 + c) * 32] = sacc[nt][c];
        mypart[(16 + nt * 4 + c) * 32] = dpacc[nt][c];
      }
    __syncthreads();  // every partial is in
    // 2. this warp's n-tile kq of the sums: queries 16 qh + g (+8), keys 8 kq + 2t (+1)
    float sv4[4] = {0.f, 0.f, 0.f, 0.f}, dv4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* pp = spart + (qh + 2 * w) * 2 * 16 * 32 + kq * 4 * 32 + lane;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sv4[c] += pp[c * 32];
        dv4[c] += pp[(16 + c) * 32];
      }
    }
    float pr[4], ds[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1, e = c & 1;
      const bool ok = key_ok[e] && i0 + 16 * qh + g + 8 * h < p;
      pr[c] = ok ? expf(sv4[c] * a.scale - lse[h]) : 0.f;
      ds[c] = pr[c] * (dv4[c] - delta[h]);
    }
    __syncthreads();  // every warp has read the partials
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (16 * qh + g + 8 * h) * kLdp + 8 * kq + 2 * t;
      *reinterpret_cast<float2*>(sp + o) = make_float2(pr[2 * h], pr[2 * h + 1]);
      *reinterpret_cast<float2*>(sds + o) = make_float2(ds[2 * h], ds[2 * h + 1]);
    }
    __syncthreads();  // p and ds are in

    // 3. dk += ds^T . q: the query rows 8 ks + 2t, + 1 of k-step ks
#pragma unroll
    for (int ks = 0; kMath && ks < kBQ / 8; ++ks) {
      FragA d;
      d.load_t(sds + (8 * ks + 2 * t) * kLdp + 16 * kmi + g, kLdp);
      const float* yp = sq + (8 * ks + 2 * t) * ldq + g;
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int nt = kn0 + 4 * i;
        if (nt < nkk) mma3(acck[i], d, FragB(yp[8 * nt], yp[ldq + 8 * nt]));
      }
    }
    __syncthreads();  // every warp is done with q of tile it
#ifndef ATTN_BWD_NO_LOADS
    if (it + 1 < nq) load_cols(sq, ldq, q, i0 + kBQ, kBQ, dqk, 0, dqk, p);
#endif
    cp_async_commit();
    // 4. dv += p^T . do
#pragma unroll
    for (int ks = 0; kMath && ks < kBQ / 8; ++ks) {
      FragA pt[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) pt[mi].load_t(sp + (8 * ks + 2 * t) * kLdp + 16 * mi + g, kLdp);
      const float* yp = sdo + (8 * ks + 2 * t) * kLdv + dv0 + g;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        const FragB y(yp[8 * nj], yp[kLdv + 8 * nj]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma3(accv[mi][nj], pt[mi], y);
      }
    }
    __syncthreads();  // every warp is done with do, p and ds of tile it
#ifndef ATTN_BWD_NO_LOADS
    if (it + 1 < nq) load_cols(sdo, kLdv, dout, i0 + kBQ, kBQ, DV, 0, DV, p);
#endif
    cp_async_commit();
  }

  float* dk = static_cast<float*>(a.dk) + size_t(b) * p * dqk + 2 * t;
  float* dv = static_cast<float*>(a.dv) + size_t(b) * p * DV + dv0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int key = k0 + 16 * mi + g + 8 * h;
      if (key >= p) continue;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
        *reinterpret_cast<float2*>(dv + size_t(key) * DV + 8 * nj) =
            make_float2(accv[mi][nj][2 * h], accv[mi][nj][2 * h + 1]);
    }
    const int key = k0 + 16 * kmi + g + 8 * h;
    if (key >= p) continue;
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int nt = kn0 + 4 * i;
      if (nt < nkk)
        *reinterpret_cast<float2*>(dk + size_t(key) * dqk + 8 * nt) =
            make_float2(acck[i][2 * h] * a.scale, acck[i][2 * h + 1] * a.scale);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- bf16 host
// The bf16 kernels' choice: {rows a block, rows a streamed tile, stages,
// dynamic shared memory bytes}.
template <int DKP, int DV> void bf16_plan(bool dkv, int (&out)[4]) {
  using K = DkvPlan<DKP, DV>;
  using Q = DqPlan<DKP, DV>;
  if (dkv) {
    out[0] = K::kBK, out[1] = K::kBQ, out[2] = K::stages(), out[3] = K::bytes(K::stages());
  } else {
    out[0] = Q::kBQ, out[1] = Q::kBK, out[2] = Q::stages(), out[3] = Q::bytes(Q::stages());
  }
}
template <int DV> void bf16_plan(bool dkv, int dqk, int (&out)[4]) {
  switch (padded_dk(dqk)) {
    case 64: return bf16_plan<64, DV>(dkv, out);
    case 128: return bf16_plan<128, DV>(dkv, out);
    default: return bf16_plan<256, DV>(dkv, out);
  }
}

// Returns -1 where a base is not 16-byte aligned (TMA's rule), -2 where a
// tensor map cannot be made.
template <int DKP, int DV> int launch_bf16(const Args& a, bool dkv, cudaStream_t stream) {
  for (const void* ptr : {a.q, a.k, a.v, a.dout})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return -1;
  int plan[4];
  bf16_plan<DKP, DV>(dkv, plan);
  // q and do in boxes of the rows a block keeps (dq) or streams (dk/dv); k and v the other
  const int rows_q = dkv ? plan[1] : plan[0], rows_k = dkv ? plan[0] : plan[1];
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_rows(&mq, a.q, a.n, a.p, a.dqk, rows_q) ||
      !encode_rows(&mk, a.k, a.n, a.p, a.dqk, rows_k) ||
      !encode_rows(&mv, a.v, a.n, a.p, DV, rows_k) ||
      !encode_rows(&mdo, a.dout, a.n, a.p, DV, rows_q))
    return -2;
  auto kernel = dkv ? &dkv_bf16_kernel<DKP, DV> : &dq_bf16_kernel<DKP, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((a.p + plan[0] - 1) / plan[0], a.n), kBfThreads, plan[3], stream>>>(
      mq, mk, mv, mdo, a, plan[2]);
  return static_cast<int>(cudaGetLastError());
}
template <int DV> int launch_bf16(const Args& a, bool dkv, cudaStream_t s) {
  switch (padded_dk(a.dqk)) {
    case 64: return launch_bf16<64, DV>(a, dkv, s);
    case 128: return launch_bf16<128, DV>(a, dkv, s);
    default: return launch_bf16<256, DV>(a, dkv, s);
  }
}

template <int DV>
int launch_dq(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io) return launch_bf16<DV>(a, false, s);
  using L = DqF32Layout<DV>;
  const dim3 grid((a.p + L::kBQ - 1) / L::kBQ, a.n);
  return a.dqk <= 64 ? launch(dq_f32_kernel<DV, 64>, L::bytes(a.dqk), grid, a, s)
                     : launch(dq_f32_kernel<DV, 256>, L::bytes(a.dqk), grid, a, s);
}

template <int DV>
int launch_dkv(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io) return launch_bf16<DV>(a, true, s);
  using L = DkvF32Layout<DV>;
  const dim3 grid((a.p + L::kBK - 1) / L::kBK, a.n);
  return a.dqk <= 64 ? launch(dkv_f32_kernel<DV, 64>, L::bytes(a.dqk), grid, a, s)
                     : launch(dkv_f32_kernel<DV, 256>, L::bytes(a.dqk), grid, a, s);
}

bool make_args(Args& a, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int n, int p, int dqk, int dv,
               float scale) {
  if (n < 1 || n > 65535 || p < 1 || dqk < 16 || dqk > 256 || dqk % 16 != 0) return false;
  if (dv != 128 && dv != 256 && dv != 512) return false;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = a.dk = a.dv = nullptr;
  a.n = n; a.p = p; a.dqk = dqk; a.scale = scale;
  return true;
}

}  // namespace

extern "C" {

// q, k (n,p,dqk), v, dout (n,p,dv), all bf16 (bf16_io != 0) or all f32,
// contiguous; lse, delta (n,p) f32. dq (n,p,dqk) in the inputs' type. Takes dqk
// a multiple of 16 up to 256 and dv in {128, 256, 512}. Returns the CUDA error
// of the launch, or -1 for a shape the kernel does not take.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, int n, int p,
                                  int dqk, int dv, float scale, int bf16_io, void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, n, p, dqk, dv, scale)) return -1;
  a.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dv) {
    case 128: return launch_dq<128>(a, bf16_io, s);
    case 256: return launch_dq<256>(a, bf16_io, s);
    default: return launch_dq<512>(a, bf16_io, s);
  }
}

// As above; dk (n,p,dqk) and dv_out (n,p,dv) in the inputs' type.
int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv_out,
                                   int n, int p, int dqk, int dv, float scale, int bf16_io,
                                   void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, n, p, dqk, dv, scale)) return -1;
  a.dk = dk;
  a.dv = dv_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dv) {
    case 128: return launch_dkv<128>(a, bf16_io, s);
    case 256: return launch_dkv<256>(a, bf16_io, s);
    default: return launch_dkv<512>(a, bf16_io, s);
  }
}

// The bf16 kernels' tiles for (dqk, dv), which 0 (dq) or 1 (dk/dv): out =
// {rows a block, rows a streamed tile, stages, dynamic shared memory bytes}
// (ops/attention.py::bwd_plan mirrors it). Returns -1 for a shape they do
// not take.
int flash_attention_bwd_plan(int which, int dqk, int dv, int* out) {
  Args a;
  if (!make_args(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, dqk, dv, 1.f))
    return -1;
  int plan[4];
  switch (dv) {
    case 128: bf16_plan<128>(which != 0, dqk, plan); break;
    case 256: bf16_plan<256>(which != 0, dqk, plan); break;
    default: bf16_plan<512>(which != 0, dqk, plan);
  }
  for (int i = 0; i < 4; ++i) out[i] = plan[i];
  return 0;
}

}  // extern "C"

#ifdef ATTN_BWD_MMA_PEAK
extern "C" {

// blocks of threads, each warp chains mma.sync m16n8k8 tf32 iters times on
// chains (1 or 8) independent accumulators.
int attention_bwd_mma_peak(float* out, int blocks, int threads, int iters, int chains,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 1)
    mma_peak_kernel<1><<<blocks, threads, 0, s>>>(out, iters);
  else
    mma_peak_kernel<8><<<blocks, threads, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

// blocks of threads (128, 256 or 384: one to three warpgroups), each
// warpgroup chaining iters x 4 wgmma m64nNk16 bf16. mode: 0 N 256, A and B
// (K-major) from shared memory; 1 N 256, A from registers; 2 as 1 with B
// MN-major; 3 N 32 as 0; 4 N 64 as 2.
int attention_bwd_wgmma_peak(float* out, int blocks, int threads, int iters, int mode,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: wgmma_peak_kernel<256, false, 0><<<blocks, threads, 0, s>>>(out, iters); break;
    case 1: wgmma_peak_kernel<256, true, 0><<<blocks, threads, 0, s>>>(out, iters); break;
    case 2: wgmma_peak_kernel<256, true, 1><<<blocks, threads, 0, s>>>(out, iters); break;
    case 3: wgmma_peak_kernel<32, false, 0><<<blocks, threads, 0, s>>>(out, iters); break;
    case 4: wgmma_peak_kernel<64, true, 1><<<blocks, threads, 0, s>>>(out, iters); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
#endif
