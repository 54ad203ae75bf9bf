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
// grid dimension is the loop inside a block here. Key columns >= P get p = 0;
// rows >= P are zero-filled by cp.async and not stored.
//
// Rounding: the Pallas kernels cast q, k, v and do to f32 and take all five
// products in f32. Here, for bf16 inputs, s = q . k^T and dp = do . v^T run on
// mma.sync m16n8k16 with f32 accumulation, the same math up to summation
// order. The other three products (ds . k, ds^T . q, p^T . do) have the f32 p
// or ds as left operand: it is fed as a hi + lo pair of bf16 (hi = bf16(x), lo
// = bf16(x - hi)) in two mma.sync, which keeps ~16 bits of it (relative error
// ~2^-17) instead of the 8 of one bf16. Rounding p and ds to a single bf16, as
// FlashAttention-2 does, halves those products; that is a later change, to be
// measured against this one. f32 inputs: CUDA-core FMA throughout, no TF32 and
// no bf16. Sums are f32; dq and dk are scaled at the end; one cast at the store.
//
// Bound on an H100 (SXM, 700 W) at the train shapes (576x576 crops, output
// stride 8, P = 72 * 72 = 5184, batch 16): the dq pass does 2 P^2 (2 Dk + Dv)
// per image, the dk/dv pass 2 P^2 (2 Dk + 2 Dv), not counting the lo halves.
// DANet's PAM (Dk 64, Dv 512): 0.550 and 0.991 TFLOP, 0.556 and 1.002 ms at the
// 989 TFLOP/s bf16 peak; OCNet's base block (Dk 256, Dv 512): 0.881 and 1.321
// TFLOP, 0.890 and 1.336 ms. Bound by operations: the bytes (q, k, v, do, dq,
// dk, dv once) take ~0.1 ms at 3.35 TB/s. In f32 (67 TFLOP/s) 8.2 / 14.8 ms
// (DANet) and 13.1 / 19.7 ms (OCNet).
//
// Design, bf16 (8 warps, one block per SM as in the forward):
//   dq: 64 query rows, key tiles of 64. q and do of the block stay in shared
//     memory; each key tile brings k and v (at Dk 256, Dv 512: 219 KB in all,
//     single-buffered; v's next tile is loaded during the ds . k product).
//     S and dP: warp w computes rows 16 (w % 4).., keys 32 (w / 4).. of both,
//     so p and ds are formed in registers and go to shared memory as hi/lo.
//     dq += ds . k: warp w owns rows 16 (w % 4).. and the Dk/2 columns of
//     half w / 4 (up to 64 f32 registers a thread).
//   dk/dv: 32 key rows, query tiles of 64. The block's k and v stay in shared
//     memory while q and do tiles stream through (171 KB at Dk 256, Dv 512;
//     single-buffered). The f32 accumulators for 32 keys are 32 x (Dk + Dv):
//     dv is split by columns, warp w the Dv/8 columns w.. for both 16-key
//     halves (64 registers a thread at Dv 512); dk by 8-column tiles, warp w
//     the key half w % 2 and tiles w / 2 + 4 i (up to 32 registers). S and dP
//     as in dq (warp w: queries 16 (w % 4).., keys 16 (w / 4)..); p and ds
//     go to shared memory as hi/lo and are read back transposed (ldmatrix
//     .trans) as the left operands of p^T . do and ds^T . q.
// f32: 32-row tiles both ways. S and dP: warp w owns 4 query rows, a lane one
// key, so q and do reads are warp broadcasts. dq: warp w, 4 rows, lane the
// float4 column groups lane + 32 c; dk/dv: warp w, 4 keys, the same columns.
//
// C interface: each launch function returns cudaGetLastError() after the
// launch, or -1 for a shape the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Rows row0..row0+rows-1 of a (p, width) matrix into shared memory with row
// stride ld; rows >= p read as zeros.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                                          int width, int p) {
  constexpr int kN = 16 / sizeof(T);
  const int vecs = width / kN;
  for (int u = threadIdx.x; u < rows * vecs; u += kThreads) {
    const int r = u / vecs, c = (u - r * vecs) * kN;
    const bool valid = row0 + r < p;
    cp_async16(dst + r * ld + c, src + size_t(valid ? row0 + r : 0) * width + c, valid);
  }
}

// lse and delta of rows row0.. (0 past p) into shared memory.
__device__ __forceinline__ void load_row_stats(float* slse, float* sdelta, const Args& a,
                                               int b, int row0, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool valid = row0 + r < a.p;
    const size_t i = size_t(b) * a.p + row0 + r;
    slse[r] = valid ? a.lse[i] : 0.f;
    sdelta[r] = valid ? a.delta[i] : 0.f;
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
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 as bf16 hi = bf16(x) and lo = bf16(x - hi), at hi[off], lo[off].
__device__ __forceinline__ void store_hi_lo(bf16* hi, bf16* lo, int off, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// ------------------------------------------------------------------- bf16
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): a C fragment
// holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1. ldmatrix
// lane addresses, as in the forward: an x4 of a row-major A (or .trans of a
// row-major K x N B, two n-tiles) takes row (lane & 7) + 8 ((lane >> 3) & 1),
// column 8 (lane >> 4) ("arow", "acol"); an x4 of an N x K B (two n-tiles),
// or .trans of a K x M matrix read as A, takes row (lane & 7) + 8 (lane >> 4),
// column 8 ((lane >> 3) & 1) ("brow", "bcol"); an x2 .trans of a K x N B
// takes row lane & 15.
constexpr int kPad = 8;

template <int DV> struct DqLayout {
  static constexpr int kBQ = 64, kBK = 64, kLdv = DV + kPad, kLds = kBK + kPad;
  __host__ __device__ static int ldq(int dqk) { return dqk + kPad; }
  __host__ __device__ static size_t do_off(int dqk) { return size_t(kBQ) * ldq(dqk); }
  __host__ __device__ static size_t k_off(int dqk) { return do_off(dqk) + size_t(kBQ) * kLdv; }
  __host__ __device__ static size_t v_off(int dqk) { return k_off(dqk) + size_t(kBK) * ldq(dqk); }
  __host__ __device__ static size_t hi_off(int dqk) { return v_off(dqk) + size_t(kBK) * kLdv; }
  __host__ __device__ static size_t lo_off(int dqk) { return hi_off(dqk) + size_t(kBQ) * kLds; }
  __host__ __device__ static size_t scratch_bytes(int dqk) {
    return ((lo_off(dqk) + size_t(kBQ) * kLds) * sizeof(bf16) + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int dqk) { return scratch_bytes(dqk) + 2 * kBQ * 4; }
};

template <int DV>
__global__ void __launch_bounds__(kThreads, 1) dq_bf16_kernel(Args a) {
  using L = DqLayout<DV>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kLdv = L::kLdv, kLds = L::kLds;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* sq = base;
  bf16* sdo = base + L::do_off(dqk);
  bf16* sk = base + L::k_off(dqk);
  bf16* sv = base + L::v_off(dqk);
  bf16* shi = base + L::hi_off(dqk);
  bf16* slo = base + L::lo_off(dqk);
  float* slse = reinterpret_cast<float*>(smem + L::scratch_bytes(dqk));
  float* sdelta = slse + kBQ;

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const bf16* q = static_cast<const bf16*>(a.q) + size_t(b) * p * dqk;
  const bf16* k = static_cast<const bf16*>(a.k) + size_t(b) * p * dqk;
  const bf16* v = static_cast<const bf16*>(a.v) + size_t(b) * p * DV;
  const bf16* dout = static_cast<const bf16*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int hcols = dqk / 2, ntiles = dqk / 16;  // this warp's dq columns: cg * hcols..

  load_rows(sq, ldq, q, q0, kBQ, dqk, p);
  load_rows(sdo, kLdv, dout, q0, kBQ, DV, p);
  load_rows(sk, ldq, k, 0, kBK, dqk, p);
  load_rows(sv, kLdv, v, 0, kBK, DV, p);
  cp_async_commit();
  load_row_stats(slse, sdelta, a, b, q0, kBQ);

  float acc[16][4];  // rows 16 rg + g (+8), columns cg * hcols + 8 nt + 2t
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  const int nk = (p + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // k and v tile j are in

    // 1. S and dP: rows 16 rg.., keys 32 cg.. of this tile
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
    for (int kk = 0; kk < dqk; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, sq + (16 * rg + arow) * ldq + kk + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sk + (32 * cg + 16 * np + brow) * ldq + kk + bcol);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < DV; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, sdo + (16 * rg + arow) * kLdv + kk + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sv + (32 * cg + 16 * np + brow) * kLdv + kk + bcol);
        mma_bf16(dp[2 * np], af, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // 2. p = exp(scale s - lse) (0 past P), ds = p (dp - delta), to shared memory as hi/lo
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * rg + g + 8 * h;
      const float lse = slse[row], delta = sdelta[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = 32 * cg + 8 * nt + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = j * kBK + col + e < p ? expf(s[nt][2 * h + e] * a.scale - lse) : 0.f;
          ds[e] = pr * (dp[nt][2 * h + e] - delta);
        }
        store_hi_lo(shi, slo, row * kLds + col, ds[0], ds[1]);
      }
    }
    __syncthreads();  // ds is in; every warp is done with v tile j
    if (j + 1 < nk) load_rows(sv, kLdv, v, (j + 1) * kBK, kBK, DV, p);
    cp_async_commit();

    // 3. dq += ds . k over this warp's rows and column half
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ahi[4], alo[4];
      ldmatrix_x4(ahi, shi + (16 * rg + arow) * kLds + kk + acol);
      ldmatrix_x4(alo, slo + (16 * rg + arow) * kLds + kk + acol);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt < ntiles) {
          uint32_t kb[2];
          ldmatrix_x2_trans(kb, sk + (kk + (lane & 15)) * ldq + cg * hcols + 8 * nt);
          mma_bf16(acc[nt], ahi, kb[0], kb[1]);
          mma_bf16(acc[nt], alo, kb[0], kb[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with k tile j and ds
    if (j + 1 < nk) load_rows(sk, ldq, k, (j + 1) * kBK, kBK, dqk, p);
    cp_async_commit();
  }

  bf16* dq = static_cast<bf16*>(a.dq) + size_t(b) * p * dqk + cg * hcols + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    if (nt >= ntiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * rg + g + 8 * h;
      if (row < p)
        *reinterpret_cast<__nv_bfloat162*>(dq + size_t(row) * dqk + 8 * nt) =
            __floats2bfloat162_rn(acc[nt][2 * h] * a.scale, acc[nt][2 * h + 1] * a.scale);
    }
  }
}

template <int DV> struct DkvLayout {
  static constexpr int kBK = 32, kBQ = 64, kLdv = DV + kPad, kLdp = kBK + kPad;
  __host__ __device__ static int ldq(int dqk) { return dqk + kPad; }
  __host__ __device__ static size_t v_off(int dqk) { return size_t(kBK) * ldq(dqk); }
  __host__ __device__ static size_t q_off(int dqk) { return v_off(dqk) + size_t(kBK) * kLdv; }
  __host__ __device__ static size_t do_off(int dqk) { return q_off(dqk) + size_t(kBQ) * ldq(dqk); }
  // p hi, p lo, ds hi, ds lo, each [kBQ][kLdp]
  __host__ __device__ static size_t pds_off(int dqk) { return do_off(dqk) + size_t(kBQ) * kLdv; }
  __host__ __device__ static size_t scratch_bytes(int dqk) {
    return ((pds_off(dqk) + 4 * size_t(kBQ) * kLdp) * sizeof(bf16) + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int dqk) { return scratch_bytes(dqk) + 2 * kBQ * 4; }
};

template <int DV>
__global__ void __launch_bounds__(kThreads, 1) dkv_bf16_kernel(Args a) {
  using L = DkvLayout<DV>;
  constexpr int kBK = L::kBK, kBQ = L::kBQ, kLdv = L::kLdv, kLdp = L::kLdp;
  constexpr int kNJ = DV / kWarps / 8;  // dv n-tiles of a warp
  static_assert(kNJ % 2 == 0, "Dv / 8 must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* sk = base;
  bf16* sv = base + L::v_off(dqk);
  bf16* sq = base + L::q_off(dqk);
  bf16* sdo = base + L::do_off(dqk);
  bf16* sphi = base + L::pds_off(dqk);
  bf16* splo = sphi + kBQ * kLdp;
  bf16* sdshi = splo + kBQ * kLdp;
  bf16* sdslo = sdshi + kBQ * kLdp;
  float* slse = reinterpret_cast<float*>(smem + L::scratch_bytes(dqk));
  float* sdelta = slse + kBQ;

  const int b = blockIdx.y, k0 = blockIdx.x * kBK;
  const bf16* q = static_cast<const bf16*>(a.q) + size_t(b) * p * dqk;
  const bf16* k = static_cast<const bf16*>(a.k) + size_t(b) * p * dqk;
  const bf16* v = static_cast<const bf16*>(a.v) + size_t(b) * p * DV;
  const bf16* dout = static_cast<const bf16*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;  // S, dP: queries 16 rg.., keys 16 cg..
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int kmi = warp & 1, kn0 = warp >> 1;  // dk: key half kmi, n-tiles kn0 + 4 i
  const int kntiles = dqk / 8;
  const int dv0 = warp * (DV / kWarps);  // dv: this warp's columns

  load_rows(sk, ldq, k, k0, kBK, dqk, p);
  load_rows(sv, kLdv, v, k0, kBK, DV, p);

  float accv[2][kNJ][4];  // keys 16 mi + g (+8), columns dv0 + 8 nj + 2t
  float acck[8][4];       // keys 16 kmi + g (+8), columns 8 (kn0 + 4 i) + 2t
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) accv[mi][nj][r] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acck[i][r] = 0.f;

  const int nq = (p + kBQ - 1) / kBQ;
  for (int it = 0; it < nq; ++it) {
    const int i0 = it * kBQ;
    load_rows(sq, ldq, q, i0, kBQ, dqk, p);
    load_rows(sdo, kLdv, dout, i0, kBQ, DV, p);
    cp_async_commit();
    load_row_stats(slse, sdelta, a, b, i0, kBQ);
    cp_async_wait_all();
    __syncthreads();  // q, do, lse and delta of tile it are in

    // 1. S and dP: queries 16 rg.., keys 16 cg..
    float s[2][4], dp[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
    for (int kk = 0; kk < dqk; kk += 16) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, sq + (16 * rg + arow) * ldq + kk + acol);
      ldmatrix_x4(bf, sk + (16 * cg + brow) * ldq + kk + bcol);
      mma_bf16(s[0], af, bf[0], bf[1]);
      mma_bf16(s[1], af, bf[2], bf[3]);
    }
#pragma unroll 4
    for (int kk = 0; kk < DV; kk += 16) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, sdo + (16 * rg + arow) * kLdv + kk + acol);
      ldmatrix_x4(bf, sv + (16 * cg + brow) * kLdv + kk + bcol);
      mma_bf16(dp[0], af, bf[0], bf[1]);
      mma_bf16(dp[1], af, bf[2], bf[3]);
    }
    // 2. p (0 past P, both ways) and ds to shared memory as hi/lo, [query][key]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * rg + g + 8 * h;
      const float lse = slse[row], delta = sdelta[row];
      const bool row_ok = i0 + row < p;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 16 * cg + 8 * nt + 2 * t;
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pr[e] = row_ok && k0 + col + e < p ? expf(s[nt][2 * h + e] * a.scale - lse) : 0.f;
          ds[e] = pr[e] * (dp[nt][2 * h + e] - delta);
        }
        store_hi_lo(sphi, splo, row * kLdp + col, pr[0], pr[1]);
        store_hi_lo(sdshi, sdslo, row * kLdp + col, ds[0], ds[1]);
      }
    }
    __syncthreads();  // p and ds are in

    // 3. dv += p^T . do over this warp's columns; dk += ds^T . q over its tiles
#pragma unroll
    for (int kk = 0; kk < kBQ; kk += 16) {
      uint32_t phi[2][4], plo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4_trans(phi[mi], sphi + (kk + brow) * kLdp + 16 * mi + bcol);
        ldmatrix_x4_trans(plo[mi], splo + (kk + brow) * kLdp + 16 * mi + bcol);
      }
#pragma unroll
      for (int njp = 0; njp < kNJ / 2; ++njp) {
        uint32_t db[4];
        ldmatrix_x4_trans(db, sdo + (kk + arow) * kLdv + dv0 + 16 * njp + acol);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(accv[mi][2 * njp], phi[mi], db[0], db[1]);
          mma_bf16(accv[mi][2 * njp], plo[mi], db[0], db[1]);
          mma_bf16(accv[mi][2 * njp + 1], phi[mi], db[2], db[3]);
          mma_bf16(accv[mi][2 * njp + 1], plo[mi], db[2], db[3]);
        }
      }
      uint32_t dhi[4], dlo[4];
      ldmatrix_x4_trans(dhi, sdshi + (kk + brow) * kLdp + 16 * kmi + bcol);
      ldmatrix_x4_trans(dlo, sdslo + (kk + brow) * kLdp + 16 * kmi + bcol);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nt = kn0 + 4 * i;
        if (nt < kntiles) {
          uint32_t qb[2];
          ldmatrix_x2_trans(qb, sq + (kk + (lane & 15)) * ldq + 8 * nt);
          mma_bf16(acck[i], dhi, qb[0], qb[1]);
          mma_bf16(acck[i], dlo, qb[0], qb[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with q, do, p and ds of tile it
  }

  bf16* dk = static_cast<bf16*>(a.dk) + size_t(b) * p * dqk + 2 * t;
  bf16* dv = static_cast<bf16*>(a.dv) + size_t(b) * p * DV + dv0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int key = k0 + 16 * mi + g + 8 * h;
      if (key >= p) continue;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
        *reinterpret_cast<__nv_bfloat162*>(dv + size_t(key) * DV + 8 * nj) =
            __floats2bfloat162_rn(accv[mi][nj][2 * h], accv[mi][nj][2 * h + 1]);
    }
    const int key = k0 + 16 * kmi + g + 8 * h;
    if (key >= p) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nt = kn0 + 4 * i;
      if (nt < kntiles)
        *reinterpret_cast<__nv_bfloat162*>(dk + size_t(key) * dqk + 8 * nt) =
            __floats2bfloat162_rn(acck[i][2 * h] * a.scale, acck[i][2 * h + 1] * a.scale);
    }
  }
}

// -------------------------------------------------------------------- f32
constexpr int kPad32 = 4;
constexpr int kT32 = 32;  // rows of a tile, both ways

template <int DV> struct Layout32 {
  static constexpr int kLdv = DV + kPad32, kLds = kT32 + kPad32;
  __host__ __device__ static int ldq(int dqk) { return dqk + kPad32; }
  // two (kT32, dqk) and two (kT32, DV) tiles, then two (kT32, kLds) scratch
  // tiles (dq: ds transposed; dk/dv: p and ds), then lse and delta
  __host__ __device__ static size_t b_off(int dqk) { return size_t(kT32) * ldq(dqk); }
  __host__ __device__ static size_t c_off(int dqk) { return 2 * size_t(kT32) * ldq(dqk); }
  __host__ __device__ static size_t d_off(int dqk) { return c_off(dqk) + size_t(kT32) * kLdv; }
  __host__ __device__ static size_t s_off(int dqk) { return d_off(dqk) + size_t(kT32) * kLdv; }
  __host__ __device__ static size_t bytes(int dqk) {
    return (s_off(dqk) + 2 * size_t(kT32) * kLds + 2 * kT32) * sizeof(float);
  }
};

// s[i] += x[i] . y over width columns: x rows (broadcast over the warp) at
// xr + i * ldx, y the lane's row.
__device__ __forceinline__ void dot4rows(float (&s)[4], const float* xr, int ldx, const float* y,
                                         int width) {
  for (int d = 0; d < width; d += 4) {
    const float4 yv = *reinterpret_cast<const float4*>(y + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + i * ldx + d);
      s[i] = fmaf(xv.x, yv.x, s[i]);
      s[i] = fmaf(xv.y, yv.y, s[i]);
      s[i] = fmaf(xv.z, yv.z, s[i]);
      s[i] = fmaf(xv.w, yv.w, s[i]);
    }
  }
}

// acc[i][c] += w[kk][i] y[kk][4 (lane + 32 c)..] over kk < kT32, for the
// column groups c < ncg (and 4 (lane + 32 c) < width): w is (kT32, kLds) with
// this warp's 4 rows at column w0, y is (kT32, ldy).
template <int NC>
__device__ __forceinline__ void acc4rows(float (&acc)[4][NC][4], const float* w, int ldw, int w0,
                                         const float* y, int ldy, int width, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < kT32; ++kk) {
    const float4 wv = *reinterpret_cast<const float4*>(w + kk * ldw + w0);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (lane + 32 * c);
      if (col < width) {
        const float4 yv = *reinterpret_cast<const float4*>(y + kk * ldy + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(wr[i], yv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(wr[i], yv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(wr[i], yv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(wr[i], yv.w, acc[i][c][3]);
        }
      }
    }
  }
}

// rows row0 + 4 warp + i (< p) of acc * mul into out (ld width).
template <int NC>
__device__ __forceinline__ void store4rows(float* out, int width, int row0, int p,
                                           float (&acc)[4][NC][4], float mul, int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * warp + i;
    if (row >= p) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (lane + 32 * c);
      if (col < width)
        *reinterpret_cast<float4*>(out + size_t(row) * width + col) = make_float4(
            acc[i][c][0] * mul, acc[i][c][1] * mul, acc[i][c][2] * mul, acc[i][c][3] * mul);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
}

// dq: a block owns 32 query rows (q in tile a, do in tile c), key tiles of
// 32 (k in tile b, v in tile d); ds goes to scratch 0 transposed, [key][row].
template <int DV>
__global__ void __launch_bounds__(kThreads, 1) dq_f32_kernel(Args a) {
  using L = Layout32<DV>;
  constexpr int kLdv = L::kLdv, kLds = L::kLds;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  float* base = reinterpret_cast<float*>(smem);
  float* sq = base;
  float* sk = base + L::b_off(dqk);
  float* sdo = base + L::c_off(dqk);
  float* sv = base + L::d_off(dqk);
  float* sdst = base + L::s_off(dqk);
  float* slse = sdst + 2 * kT32 * kLds;
  float* sdelta = slse + kT32;

  const int b = blockIdx.y, q0 = blockIdx.x * kT32;
  const float* q = static_cast<const float*>(a.q) + size_t(b) * p * dqk;
  const float* k = static_cast<const float*>(a.k) + size_t(b) * p * dqk;
  const float* v = static_cast<const float*>(a.v) + size_t(b) * p * DV;
  const float* dout = static_cast<const float*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(sq, ldq, q, q0, kT32, dqk, p);
  load_rows(sdo, kLdv, dout, q0, kT32, DV, p);
  load_rows(sk, ldq, k, 0, kT32, dqk, p);
  load_rows(sv, kLdv, v, 0, kT32, DV, p);
  cp_async_commit();
  load_row_stats(slse, sdelta, a, b, q0, kT32);

  float acc[4][2][4];  // rows 4 warp + i, columns 4 (lane + 32 c)..
  zero(acc);
  const int nk = (p + kT32 - 1) / kT32;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // k and v tile j are in

    // 1. S and dP: rows 4 warp.., key lane
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    dot4rows(s, sq + 4 * warp * ldq, ldq, sk + lane * ldq, dqk);
    dot4rows(dp, sdo + 4 * warp * kLdv, kLdv, sv + lane * kLdv, DV);
    // 2. ds, transposed into scratch
    const bool key_ok = j * kT32 + lane < p;
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * warp + i;
      const float pr = key_ok ? expf(s[i] * a.scale - slse[row]) : 0.f;
      ds[i] = pr * (dp[i] - sdelta[row]);
    }
    *reinterpret_cast<float4*>(sdst + lane * kLds + 4 * warp) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncthreads();  // ds is in; every warp is done with v tile j
    if (j + 1 < nk) load_rows(sv, kLdv, v, (j + 1) * kT32, kT32, DV, p);
    cp_async_commit();

    // 3. dq += ds . k
    acc4rows(acc, sdst, kLds, 4 * warp, sk, ldq, dqk, lane);
    __syncthreads();  // every warp is done with k tile j and ds
    if (j + 1 < nk) load_rows(sk, ldq, k, (j + 1) * kT32, kT32, dqk, p);
    cp_async_commit();
  }
  store4rows(static_cast<float*>(a.dq) + size_t(b) * p * dqk, dqk, q0, p, acc, a.scale, warp,
             lane);
}

// dk/dv: a block owns 32 keys (k in tile a, v in tile c), query tiles of 32
// (q in tile b, do in tile d); p and ds go to scratch 0 and 1, [query][key].
template <int DV>
__global__ void __launch_bounds__(kThreads, 1) dkv_f32_kernel(Args a) {
  using L = Layout32<DV>;
  constexpr int kLdv = L::kLdv, kLds = L::kLds;
  constexpr int kCV = DV / 128;  // dv column groups of a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int dqk = a.dqk, p = a.p, ldq = L::ldq(dqk);
  float* base = reinterpret_cast<float*>(smem);
  float* sk = base;
  float* sq = base + L::b_off(dqk);
  float* sv = base + L::c_off(dqk);
  float* sdo = base + L::d_off(dqk);
  float* sp = base + L::s_off(dqk);
  float* sds = sp + kT32 * kLds;
  float* slse = sds + kT32 * kLds;
  float* sdelta = slse + kT32;

  const int b = blockIdx.y, k0 = blockIdx.x * kT32;
  const float* q = static_cast<const float*>(a.q) + size_t(b) * p * dqk;
  const float* k = static_cast<const float*>(a.k) + size_t(b) * p * dqk;
  const float* v = static_cast<const float*>(a.v) + size_t(b) * p * DV;
  const float* dout = static_cast<const float*>(a.dout) + size_t(b) * p * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(sk, ldq, k, k0, kT32, dqk, p);
  load_rows(sv, kLdv, v, k0, kT32, DV, p);

  float accv[4][kCV][4];  // keys 4 warp + i, columns 4 (lane + 32 c)..
  float acck[4][2][4];
  zero(accv);
  zero(acck);
  const bool key_ok = k0 + lane < p;  // S, dP: the lane's key
  const int nq = (p + kT32 - 1) / kT32;
  for (int it = 0; it < nq; ++it) {
    const int i0 = it * kT32;
    load_rows(sq, ldq, q, i0, kT32, dqk, p);
    load_rows(sdo, kLdv, dout, i0, kT32, DV, p);
    cp_async_commit();
    load_row_stats(slse, sdelta, a, b, i0, kT32);
    cp_async_wait_all();
    __syncthreads();  // q, do, lse and delta of tile it are in

    // 1. S and dP: queries 4 warp.., key lane
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    dot4rows(s, sq + 4 * warp * ldq, ldq, sk + lane * ldq, dqk);
    dot4rows(dp, sdo + 4 * warp * kLdv, kLdv, sv + lane * kLdv, DV);
    // 2. p and ds into scratch, [query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * warp + i;
      const float pr = key_ok && i0 + row < p ? expf(s[i] * a.scale - slse[row]) : 0.f;
      sp[row * kLds + lane] = pr;
      sds[row * kLds + lane] = pr * (dp[i] - sdelta[row]);
    }
    __syncthreads();  // p and ds are in

    // 3. dv += p^T . do, dk += ds^T . q: keys 4 warp..
    acc4rows(accv, sp, kLds, 4 * warp, sdo, kLdv, DV, lane);
    acc4rows(acck, sds, kLds, 4 * warp, sq, ldq, dqk, lane);
    __syncthreads();  // every warp is done with q, do, p and ds of tile it
  }
  store4rows(static_cast<float*>(a.dv) + size_t(b) * p * DV, DV, k0, p, accv, 1.f, warp, lane);
  store4rows(static_cast<float*>(a.dk) + size_t(b) * p * dqk, dqk, k0, p, acck, a.scale, warp,
             lane);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DV>
int launch_dq(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io)
    return launch(dq_bf16_kernel<DV>, DqLayout<DV>::bytes(a.dqk),
                  dim3((a.p + DqLayout<DV>::kBQ - 1) / DqLayout<DV>::kBQ, a.n), a, s);
  return launch(dq_f32_kernel<DV>, Layout32<DV>::bytes(a.dqk),
                dim3((a.p + kT32 - 1) / kT32, a.n), a, s);
}

template <int DV>
int launch_dkv(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io)
    return launch(dkv_bf16_kernel<DV>, DkvLayout<DV>::bytes(a.dqk),
                  dim3((a.p + DkvLayout<DV>::kBK - 1) / DkvLayout<DV>::kBK, a.n), a, s);
  return launch(dkv_f32_kernel<DV>, Layout32<DV>::bytes(a.dqk),
                dim3((a.p + kT32 - 1) / kT32, a.n), a, s);
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

}  // extern "C"
