// K5/K6: fused FFM logits, one launch per padding bucket — the context-tail
// pairs, the candidate pair terms and the additive "ffm" head in one kernel,
// so the (R, N, n_pairs) pair vector and the candidate dot matrices never
// exist in device memory.
//
// Replaces (src/repro/kernels/ffm_interaction/ffm_interaction.py):
//   K5 ffm_fused_logits_q8   (Pallas body _fused_kernel_q8, :144-189)
//   K6 ffm_fused_logits_rows (Pallas body _fused_kernel_rows, :192-214)
//   with the layouts of their pallas_call (_fused_call, :217-265).
//
// Per request row r (context fields i, j < Fc) and candidate n (candidate
// fields ic, jc < Fcand):
//   d[r,i,j]    = <ectx[r,i,j,:], ectx[r,j,i,:]> * (vctx[r,i] * vctx[r,j])
//   tail[r]     = sum over i < j, j >= depth[r] of d[r,i,j]  (the pairs a
//                 depth-p cached prefix still owes)
//   xc_sum[r,n] = sum over (i, jc) of
//                 <ectx[r,i,Fc+jc,:], ecx[r,n,jc,i,:]> * vctx[r,i] * vc[r,n,jc]
//   aa_sum[r,n] = sum over ic < jc of
//                 <ecc[r,n,ic,jc,:], ecc[r,n,jc,ic,:]> * vc[r,n,ic] * vc[r,n,jc]
//   logits[r,n] = base[r,n] + tail[r] + xc_sum[r,n] + aa_sum[r,n]
//   ctx_dots[r] = d[r]
// K5 takes the candidate rows as int8 codes q with one (s, z) grid per
// candidate row (r, n, jc) and never dequantizes a row:
//   ctx x cand:  s * <ex, q> + z * sum(ex)   (f32 activation x int8 code)
//   cand x cand: s_i s_j Q + s_i z_j A_ij + s_j z_i A_ji + K z_i z_j, with
//                Q = <q[ic,jc], q[jc,ic]>, A_ij = sum q[ic,jc], A_ji =
//                sum q[jc,ic] exact in int32 (__dp4a: two per K=8 row).
//
// What bounds them on the H100: bytes, and at serving shapes the launch
//   itself. At the main-path bucket (R=8 rows, N=64 candidates, Fc=16,
//   Fcand=8, K=8) K5 moves ~0.95 MB (786 KB of them codes, ~0.28 us at
//   3.35 TB/s) and K6 ~3.3 MB (~0.98 us); the ~1.3 MFLOP are negligible.
//
// Design: the Pallas grid walks (row, candidate tile) in order with the
//   row's context block resident in VMEM, and every tile rewrites ctx_dots.
//   Here each (row, tile of kTileN candidates) is an independent CTA, run in
//   no order. It stages the row's whole (Fc, F, K) context block in shared
//   memory (12 KiB at full width; each field's row padded by kRowPad floats
//   so that lanes reading neighbouring fields hit distinct banks) with
//   vctx, recomputes the (Fc, Fc) matrix d and the tail sum (2,048 MACs),
//   and only tile 0 writes ctx_dots. The grid has at least one tile per
//   row, so a row without candidates still gets its ctx_dots. Then each
//   warp owns one candidate: its lanes walk the (jc, i) ctx x cand terms
//   (neighbouring lanes read neighbouring candidate rows, so the loads
//   coalesce) and the ic < jc cand x cand pairs, and the per-lane partial
//   sums meet in an xor butterfly. No float atomics and no cross-CTA sums:
//   the tail and each candidate's sums run in an order fixed by (Fc, Fcand,
//   K) alone, so every tile of a row sees the same tail bits and a row's
//   logits depend neither on the row bucket R nor on the candidate bucket
//   N. Candidate blocks are read in place through their strides (the engine
//   passes the context and candidate column halves of one gathered block as
//   views); only the K axis must be contiguous. Rows of K = 8 load as two
//   float4 (f32) or one 8-byte word (int8) when aligned; any other K takes
//   a scalar loop. The ragged last tile is masked; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kWarps;  // one warp per candidate
constexpr int kRowPad = 4;      // floats of padding per staged context field
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kOnes = 0x01010101;  // four int8 ones: __dp4a with it sums codes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullMask, v, m);
  return v;
}

// <a, b> over K floats in shared memory (16-byte aligned when KC == 8).
template <int KC>
__device__ __forceinline__ float dot_smem(const float* a, const float* b,
                                          int K) {
  float acc = 0.f;
  if constexpr (KC == 8) {
    const float4 a0 = reinterpret_cast<const float4*>(a)[0];
    const float4 a1 = reinterpret_cast<const float4*>(a)[1];
    const float4 b0 = reinterpret_cast<const float4*>(b)[0];
    const float4 b1 = reinterpret_cast<const float4*>(b)[1];
    acc = fmaf(a0.x, b0.x, acc); acc = fmaf(a0.y, b0.y, acc);
    acc = fmaf(a0.z, b0.z, acc); acc = fmaf(a0.w, b0.w, acc);
    acc = fmaf(a1.x, b1.x, acc); acc = fmaf(a1.y, b1.y, acc);
    acc = fmaf(a1.z, b1.z, acc); acc = fmaf(a1.w, b1.w, acc);
  } else {
    for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k], acc);
  }
  return acc;
}

// Eight consecutive f32 candidate elements (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ctx x cand term before the value products: ex is the context row in
// shared memory, q the candidate row (f32, or int8 codes with grid (s, z)).
template <typename CandT, int KC>
__device__ __forceinline__ float ctx_cand(const float* ex, const CandT* q,
                                          int K, float s, float z) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  float dq = 0.f, es = 0.f;
  if constexpr (KC == 8) {
    float c[8];
    if constexpr (Q8) {
      const int2 w = __ldg(reinterpret_cast<const int2*>(q));
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = static_cast<float>(b[k]);
    } else {
      load8(q, c);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dq = fmaf(ex[k], c[k], dq);
      if constexpr (Q8) es += ex[k];
    }
  } else {
    for (int k = 0; k < K; ++k) {
      dq = fmaf(ex[k], static_cast<float>(q[k]), dq);
      if constexpr (Q8) es += ex[k];
    }
  }
  if constexpr (Q8) {
    return s * dq + z * es;  // the affine split: the zero point never
  } else {                   // multiplies element-wise
    return dq;
  }
}

// <e[ic,jc], e[jc,ic]> for two f32 candidate rows.
template <int KC>
__device__ __forceinline__ float cand_cand(const float* p, const float* q,
                                           int K) {
  float acc = 0.f;
  if constexpr (KC == 8) {
    float a[8], b[8];
    load8(p, a);
    load8(q, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(a[k], b[k], acc);
  } else {
    for (int k = 0; k < K; ++k) acc = fmaf(p[k], q[k], acc);
  }
  return acc;
}

// The same dot for int8 code rows p = q[ic,jc] (grid si, zi) and
// q = q[jc,ic] (grid sj, zj): exact int32 Q and A, dequantized once.
template <int KC>
__device__ __forceinline__ float cand_cand_q8(const int8_t* p, const int8_t* q,
                                              int K, float si, float zi,
                                              float sj, float zj) {
  int dot = 0, ap = 0, aq = 0;
  if constexpr (KC == 8) {
    const int2 a = __ldg(reinterpret_cast<const int2*>(p));
    const int2 b = __ldg(reinterpret_cast<const int2*>(q));
    dot = __dp4a(a.x, b.x, __dp4a(a.y, b.y, 0));
    ap = __dp4a(a.x, kOnes, __dp4a(a.y, kOnes, 0));
    aq = __dp4a(b.x, kOnes, __dp4a(b.y, kOnes, 0));
  } else {
    for (int k = 0; k < K; ++k) {
      const int a = p[k], b = q[k];
      dot += a * b;
      ap += a;
      aq += b;
    }
  }
  return si * sj * static_cast<float>(dot) + si * zj * static_cast<float>(ap) +
         sj * zi * static_cast<float>(aq) +
         static_cast<float>(K) * zi * zj;
}

// Element strides (the K axis is contiguous in all three blocks):
//   ectx (r, i, j), cand x ctx block (r, n, jc, i), cand x cand (r, n, ic, jc).
struct FusedStrides {
  int64_t ctx_r, ctx_i, ctx_j;
  int64_t x_r, x_n, x_j, x_i;
  int64_t c_r, c_n, c_i, c_j;
};

template <typename CandT, int KC>
__global__ void __launch_bounds__(kThreads)
ffm_fused_logits_kernel(const float* __restrict__ ectx,
                        const float* __restrict__ vctx,
                        const int32_t* __restrict__ depth,
                        const float* __restrict__ base,
                        const CandT* __restrict__ cx,
                        const CandT* __restrict__ cc,
                        const float* __restrict__ scale,
                        const float* __restrict__ zero,
                        const float* __restrict__ vcand,
                        float* __restrict__ logits,
                        float* __restrict__ ctx_dots, FusedStrides st, int N,
                        int Fc, int Fcand, int K) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  extern __shared__ float4 smem4[];
  const int fk = (Fc + Fcand) * K;
  const int row = fk + kRowPad;                 // multiple of 4 when K == 8
  float* sctx = reinterpret_cast<float*>(smem4);  // (Fc, row): field i's (F, K)
  float* sv = sctx + Fc * row;                    // (Fc,)
  float* sred = sv + Fc;                          // (kWarps,)
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < Fc * fk; t += blockDim.x) {
    const int i = t / fk;
    const int rem = t - i * fk;
    const int j = rem / K;
    const int k = rem - j * K;
    sctx[i * row + rem] = ectx[r * st.ctx_r + i * st.ctx_i + j * st.ctx_j + k];
  }
  for (int t = threadIdx.x; t < Fc; t += blockDim.x)
    sv[t] = vctx[static_cast<int64_t>(r) * Fc + t];
  __syncthreads();

  // ctx x ctx: the full pair matrix (tile 0 writes it) and the tail sum
  const int p = depth[r];
  float part = 0.f;
  for (int o = threadIdx.x; o < Fc * Fc; o += blockDim.x) {
    const int i = o / Fc;
    const int j = o - i * Fc;
    const float dij =
        dot_smem<KC>(sctx + i * row + j * K, sctx + j * row + i * K, K) *
        (sv[i] * sv[j]);
    if (blockIdx.x == 0) ctx_dots[static_cast<int64_t>(r) * Fc * Fc + o] = dij;
    if (i < j && j >= p) part += dij;
  }
  part = warp_sum(part);
  if (lane == 0) sred[warp] = part;
  __syncthreads();
  float tail = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tail += sred[w];

  const int n = blockIdx.x * kTileN + warp;
  if (n >= N) return;  // the ragged last tile (no barrier follows)
  const int64_t rn = static_cast<int64_t>(r) * N + n;
  const float* vc = vcand + rn * Fcand;
  const CandT* xb = cx + r * st.x_r + n * st.x_n;
  const CandT* cb = cc + r * st.c_r + n * st.c_n;

  // ctx x cand: lanes walk (jc, i) with i fastest
  float xsum = 0.f;
  for (int o = lane; o < Fc * Fcand; o += 32) {
    const int jc = o / Fc;
    const int i = o - jc * Fc;
    float s = 0.f, z = 0.f;
    if constexpr (Q8) {
      s = __ldg(scale + rn * Fcand + jc);
      z = __ldg(zero + rn * Fcand + jc);
    }
    const float x = ctx_cand<CandT, KC>(sctx + i * row + (Fc + jc) * K,
                                        xb + jc * st.x_j + i * st.x_i, K, s, z);
    xsum += x * sv[i] * __ldg(vc + jc);
  }

  // cand x cand: the ic < jc pairs
  float asum = 0.f;
  for (int o = lane; o < Fcand * Fcand; o += 32) {
    const int ic = o / Fcand;
    const int jc = o - ic * Fcand;
    if (ic >= jc) continue;
    const CandT* pa = cb + ic * st.c_i + jc * st.c_j;
    const CandT* pb = cb + jc * st.c_i + ic * st.c_j;
    float dd;
    if constexpr (Q8) {
      const float* sg = scale + rn * Fcand;
      const float* zg = zero + rn * Fcand;
      dd = cand_cand_q8<KC>(pa, pb, K, __ldg(sg + ic), __ldg(zg + ic),
                            __ldg(sg + jc), __ldg(zg + jc));
    } else {
      dd = cand_cand<KC>(pa, pb, K);
    }
    asum += dd * __ldg(vc + ic) * __ldg(vc + jc);
  }
  xsum = warp_sum(xsum);
  asum = warp_sum(asum);
  if (lane == 0) logits[rn] = base[rn] + tail + xsum + asum;
}

template <typename CandT, int KC>
int launch_fused(const void* ectx, const void* vctx, const void* depth,
                 const void* base, const void* cx, const void* cc,
                 const void* scale, const void* zero, const void* vcand,
                 void* logits, void* ctx_dots, const int64_t* strides,
                 int64_t R, int64_t N, int64_t Fc, int64_t Fcand, int64_t K,
                 cudaStream_t stream) {
  FusedStrides st;
  st.ctx_r = strides[0]; st.ctx_i = strides[1]; st.ctx_j = strides[2];
  st.x_r = strides[3]; st.x_n = strides[4]; st.x_j = strides[5]; st.x_i = strides[6];
  st.c_r = strides[7]; st.c_n = strides[8]; st.c_i = strides[9]; st.c_j = strides[10];
  const size_t smem =
      (Fc * ((Fc + Fcand) * K + kRowPad) + Fc + kWarps) * sizeof(float);
  auto kernel = ffm_fused_logits_kernel<CandT, KC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t tiles = N > 0 ? (N + kTileN - 1) / kTileN : 1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(R));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ectx), static_cast<const float*>(vctx),
      static_cast<const int32_t*>(depth), static_cast<const float*>(base),
      static_cast<const CandT*>(cx), static_cast<const CandT*>(cc),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const float*>(vcand), static_cast<float*>(logits),
      static_cast<float*>(ctx_dots), st, static_cast<int>(N),
      static_cast<int>(Fc), static_cast<int>(Fcand), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ffm_fused_logits_q8(const void* ectx, const void* vctx,
                                   const void* depth, const void* base,
                                   const void* qcx, const void* qcc,
                                   const void* scale, const void* zero,
                                   const void* vcand, void* logits,
                                   void* ctx_dots, const void* strides,
                                   int64_t R, int64_t N, int64_t Fc,
                                   int64_t Fcand, int64_t K, int64_t vec8,
                                   void* stream) {
  if (R <= 0) return 0;
  const auto* st = static_cast<const int64_t*>(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec8)
    return launch_fused<int8_t, 8>(ectx, vctx, depth, base, qcx, qcc, scale,
                                   zero, vcand, logits, ctx_dots, st, R, N, Fc,
                                   Fcand, K, s);
  return launch_fused<int8_t, 0>(ectx, vctx, depth, base, qcx, qcc, scale,
                                 zero, vcand, logits, ctx_dots, st, R, N, Fc,
                                 Fcand, K, s);
}

extern "C" int ffm_fused_logits_rows(const void* ectx, const void* vctx,
                                     const void* depth, const void* base,
                                     const void* ecx, const void* ecc,
                                     const void* vcand, void* logits,
                                     void* ctx_dots, const void* strides,
                                     int64_t R, int64_t N, int64_t Fc,
                                     int64_t Fcand, int64_t K, int64_t vec8,
                                     void* stream) {
  if (R <= 0) return 0;
  const auto* st = static_cast<const int64_t*>(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec8)
    return launch_fused<float, 8>(ectx, vctx, depth, base, ecx, ecc, nullptr,
                                  nullptr, vcand, logits, ctx_dots, st, R, N,
                                  Fc, Fcand, K, s);
  return launch_fused<float, 0>(ectx, vctx, depth, base, ecx, ecc, nullptr,
                                nullptr, vcand, logits, ctx_dots, st, R, N, Fc,
                                Fcand, K, s);
}
