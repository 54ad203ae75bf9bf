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
// measured against this one. f32 inputs: all five products on the tensor
// cores in split TF32 (mma.sync m16n8k8 tf32; each operand x as hi =
// tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away from
// zero; lo . hi + hi . lo, then hi . hi, into f32; lo . lo dropped), which
// keeps ~21 bits of every operand, s = q . k^T included (at a scale of 1 an
// error in s is an error relative to p). No bf16 on the f32 route, and nothing
// reads torch.backends' TF32 switches. Sums are f32; dq and dk are scaled at
// the end; one cast at the store.
//
// Bound on an H100 (SXM, 700 W) at the train shapes (576x576 crops, output
// stride 8, P = 72 * 72 = 5184, batch 16): the dq pass does 2 P^2 (2 Dk + Dv)
// per image, the dk/dv pass 2 P^2 (2 Dk + 2 Dv), not counting the lo halves.
// DANet's PAM (Dk 64, Dv 512): 0.550 and 0.991 TFLOP, 0.556 and 1.002 ms at the
// 989 TFLOP/s bf16 peak; OCNet's base block (Dk 256, Dv 512): 0.881 and 1.321
// TFLOP, 0.890 and 1.336 ms. Bound by operations: the bytes (q, k, v, do, dq,
// dk, dv once) take ~0.1 ms at 3.35 TB/s. In f32, split TF32 issues three
// products for each: at the 495 TFLOP/s TF32 peak 3.34 and 6.00 ms (DANet),
// 5.34 and 8.01 ms (OCNet); the CUDA cores' FMA at 67 TFLOP/s would take 8.21
// and 14.79 ms, 13.14 and 19.71 ms.
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
// f32 (8 warps, split TF32, below): dq keeps q and do of 64 query rows resident
//   and streams k and v through a cp.async ring in 32-column chunks, ds never
//   leaving registers; dk/dv keeps k and v of 32 keys resident, q and do
//   tiles of 32 queries stream through, p and ds go through shared memory.
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

template <int DV>
int launch_dq(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io)
    return launch(dq_bf16_kernel<DV>, DqLayout<DV>::bytes(a.dqk),
                  dim3((a.p + DqLayout<DV>::kBQ - 1) / DqLayout<DV>::kBQ, a.n), a, s);
  using L = DqF32Layout<DV>;
  const dim3 grid((a.p + L::kBQ - 1) / L::kBQ, a.n);
  return a.dqk <= 64 ? launch(dq_f32_kernel<DV, 64>, L::bytes(a.dqk), grid, a, s)
                     : launch(dq_f32_kernel<DV, 256>, L::bytes(a.dqk), grid, a, s);
}

template <int DV>
int launch_dkv(const Args& a, bool bf16_io, cudaStream_t s) {
  if (bf16_io)
    return launch(dkv_bf16_kernel<DV>, DkvLayout<DV>::bytes(a.dqk),
                  dim3((a.p + DkvLayout<DV>::kBK - 1) / DkvLayout<DV>::kBK, a.n), a, s);
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

}  // extern "C"
#endif
