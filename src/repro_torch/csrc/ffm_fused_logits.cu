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
//   Here each (row, tile of kTileN candidates) is an independent CTA of 128
//   threads, run in no order; one warp owns one candidate. At these sizes
//   the time is the chain of dependent steps inside a CTA, not bytes, so
//   the body keeps that chain short: no shared-memory staging of the
//   context block (a copy loop whose every step waits on its own load, then
//   a barrier); every thread issues all of its loads straight into
//   registers first (rows of K = 8 as two float4 in f32, one 8-byte word of
//   int8 codes, with the per-row scalars beside them), then does its
//   arithmetic, and the CTA meets at one barrier, for the tail's sum across
//   warps. A thread's terms sit in a fixed number of register slots (the
//   whole main path: Fc^2 <= 256, Fc*Fcand <= 128, Fcand^2 <= 64); terms
//   beyond them, at wider shapes, take a loop after the slots, so nothing
//   bounds F. Terms and sums keep one fixed mapping and order:
//   - ctx x ctx: thread t takes o = t + 128m over (i, j), recomputes d[i,j]
//     (tile 0 writes every one to ctx_dots; other tiles load only the i < j
//     terms the tail needs) and sums the tail's terms; the per-thread sums
//     meet in an xor butterfly, then over the four warps in order.
//   - ctx x cand: lane l of the candidate's warp takes o = l + 32m over
//     (jc, i), i fastest (neighbouring lanes read neighbouring candidate
//     rows, so the loads coalesce); cand x cand o = l + 32m over (ic, jc),
//     ic < jc; each meets in an xor butterfly.
//   No float atomics, no cross-CTA sums, and every rounding written out
//   (__fmul_rn, __fadd_rn, fmaf; left to nvcc, the contraction of the tail's
//   sum differed between tile 0's branch and the others'), so every tile of
//   a row adds the same tail bits and a row's logits depend neither on the
//   row bucket R nor on the candidate bucket N. Candidate blocks are read in place
//   through their strides (the engine passes the context and candidate
//   column halves of one gathered block as views); only the K axis must be
//   contiguous. KC = 8 takes vector loads and needs every row aligned (the
//   wrapper decides); KC = 0 walks a runtime K with scalar loads as it goes
//   (no slots), in the same arithmetic order, so both give the same bits. The ragged last tile
//   and N = 0 predicate their candidate loads; no thread leaves before the
//   barrier, and a row without candidates still gets its ctx_dots.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kWarps;  // one warp per candidate
// register slots per thread at KC == 8: ctx x ctx terms (of 128 threads),
// ctx x cand and cand x cand terms (of a warp's 32 lanes)
constexpr int kTailSlots = 2;
constexpr int kXcSlots = 4;
constexpr int kAaSlots = 2;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kOnes = 0x01010101;  // four int8 ones: __dp4a with it sums codes

// The roundings are written out, so that no contraction choice of the
// compiler's sets the bits: a pair value d = dot * (v_i * v_j), added to
// the tail as rounded (the value ctx_dots reports), and a candidate term
// t * a * b added as fma(t * a, b, sum).
__device__ __forceinline__ float pair_value(float dot, float vi, float vj) {
  return __fmul_rn(dot, __fmul_rn(vi, vj));
}

__device__ __forceinline__ float add_term(float sum, float t, float a,
                                          float b) {
  return fmaf(__fmul_rn(t, a), b, sum);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullMask, v, m);
  return v;
}

// One K-row held for later use: at KC == 8 its elements, loaded when it is
// fetched (two float4, or one 8-byte word of int8 codes); at KC == 0 its
// address (the runtime-K loops load element by element).
template <typename T, int KC>
struct Row {
  const T* p;
};
template <>
struct Row<float, 8> {
  float4 a, b;
};
template <>
struct Row<int8_t, 8> {
  int2 w;
};

template <typename T, int KC>
__device__ __forceinline__ Row<T, KC> fetch(const T* p) {
  if constexpr (KC != 8) {
    return {p};
  } else if constexpr (std::is_same<T, float>::value) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p) + 1)};
  } else {
    return {__ldg(reinterpret_cast<const int2*>(p))};
  }
}

__device__ __forceinline__ void unpack(const Row<float, 8>& r, float* c) {
  c[0] = r.a.x; c[1] = r.a.y; c[2] = r.a.z; c[3] = r.a.w;
  c[4] = r.b.x; c[5] = r.b.y; c[6] = r.b.z; c[7] = r.b.w;
}

__device__ __forceinline__ void unpack(const Row<int8_t, 8>& r, float* c) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&r.w);
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = static_cast<float>(b[k]);
}

// <a, b> for two f32 rows: the ctx x ctx dots and K6's cand x cand dots.
template <int KC>
__device__ __forceinline__ float dot_rows(const Row<float, KC>& a,
                                          const Row<float, KC>& b, int K) {
  float acc = 0.f;
  if constexpr (KC == 8) {
    float x[8], y[8];
    unpack(a, x);
    unpack(b, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(x[k], y[k], acc);
  } else {
    for (int k = 0; k < K; ++k) acc = fmaf(a.p[k], b.p[k], acc);
  }
  return acc;
}

// ctx x cand term before the value products: ex is the context row, q the
// candidate row (f32, or int8 codes with grid (s, z)).
template <typename CandT, int KC>
__device__ __forceinline__ float ctx_cand(const Row<float, KC>& ex,
                                          const Row<CandT, KC>& q, int K,
                                          float s, float z) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  float dq = 0.f, es = 0.f;
  if constexpr (KC == 8) {
    float e[8], c[8];
    unpack(ex, e);
    unpack(q, c);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dq = fmaf(e[k], c[k], dq);
      if constexpr (Q8) es += e[k];
    }
  } else {
    for (int k = 0; k < K; ++k) {
      dq = fmaf(ex.p[k], static_cast<float>(q.p[k]), dq);
      if constexpr (Q8) es += ex.p[k];
    }
  }
  if constexpr (Q8) {
    // the affine split s * dq + z * es: the zero point never multiplies
    return fmaf(s, dq, __fmul_rn(z, es));  // element-wise
  } else {
    return dq;
  }
}

// The cand x cand dot for int8 code rows a = q[ic,jc] (grid si, zi) and
// b = q[jc,ic] (grid sj, zj): exact int32 Q and A, dequantized once.
template <int KC>
__device__ __forceinline__ float cand_cand_q8(const Row<int8_t, KC>& a,
                                              const Row<int8_t, KC>& b, int K,
                                              float si, float zi, float sj,
                                              float zj) {
  int dot = 0, ap = 0, aq = 0;
  if constexpr (KC == 8) {
    dot = __dp4a(a.w.x, b.w.x, __dp4a(a.w.y, b.w.y, 0));
    ap = __dp4a(a.w.x, kOnes, __dp4a(a.w.y, kOnes, 0));
    aq = __dp4a(b.w.x, kOnes, __dp4a(b.w.y, kOnes, 0));
  } else {
    for (int k = 0; k < K; ++k) {
      const int x = a.p[k], y = b.p[k];
      dot += x * y;
      ap += x;
      aq += y;
    }
  }
  // si sj Q + si zj A_ij + sj zi A_ji + K zi zj, left to right
  const float t = __fmul_rn(__fmul_rn(si, zj), static_cast<float>(ap));
  return fmaf(__fmul_rn(static_cast<float>(K), zi), zj,
              fmaf(__fmul_rn(sj, zi), static_cast<float>(aq),
                   fmaf(__fmul_rn(si, sj), static_cast<float>(dot), t)));
}

// Element strides (the K axis is contiguous in all three blocks):
//   ectx (r, i, j), cand x ctx block (r, n, jc, i), cand x cand (r, n, ic, jc);
// the extents, and Fc / Fcand as multiply-shift divisors.
struct FusedPlan {
  int64_t ctx_r, ctx_i, ctx_j;
  int64_t x_r, x_n, x_j, x_i;
  int64_t c_r, c_n, c_i, c_j;
  int N, Fc, Fcand, K;
  FastDiv fc, fcand;
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
                        float* __restrict__ ctx_dots, const FusedPlan p) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  __shared__ float sred[kWarps];
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool tile0 = blockIdx.x == 0;
  const int n = blockIdx.x * kTileN + warp;
  const bool live = n < p.N;  // false in the ragged tile and at N = 0
  // the runtime-K path loads as it goes: no slots
  constexpr int nT = KC == 8 ? kTailSlots : 0;
  constexpr int nX = KC == 8 ? kXcSlots : 0;
  constexpr int nA = KC == 8 ? kAaSlots : 0;
  const int K = p.K, Fc = p.Fc, Fcand = p.Fcand;
  const int n_tail = Fc * Fc, n_xc = Fc * Fcand, n_aa = Fcand * Fcand;
  const float* ctx = ectx + r * p.ctx_r;
  const float* sv = vctx + static_cast<int64_t>(r) * Fc;
  const int64_t rn = static_cast<int64_t>(r) * p.N + (live ? n : 0);
  const CandT* xb = cx + r * p.x_r + (live ? n : 0) * p.x_n;
  const CandT* cb = cc + r * p.c_r + (live ? n : 0) * p.c_n;
  const float* vc = vcand + rn * Fcand;
  const float* sg = Q8 ? scale + rn * Fcand : nullptr;
  const float* zg = Q8 ? zero + rn * Fcand : nullptr;

  // -- every load of the slots, before any arithmetic --------------------
  const int pdepth = depth[r];
  const float b_rn = live ? base[rn] : 0.f;
  // ctx x ctx, o = tid + 128m: rows (i, j) and (j, i), values i and j
  Row<float, KC> ta[kTailSlots]{}, tb[kTailSlots]{};
  float tvi[kTailSlots]{}, tvj[kTailSlots]{};
#pragma unroll
  for (int m = 0; m < nT; ++m) {
    const int o = tid + kThreads * m;
    const int i = quo(o, p.fc), j = o - i * Fc;
    if (o < n_tail && (tile0 || i < j)) {
      ta[m] = fetch<float, KC>(ctx + i * p.ctx_i + j * p.ctx_j);
      tb[m] = fetch<float, KC>(ctx + j * p.ctx_i + i * p.ctx_j);
      tvi[m] = sv[i];
      tvj[m] = sv[j];
    }
  }
  // ctx x cand, o = lane + 32m over (jc, i): context row (i, Fc + jc), the
  // candidate row (jc, i), its grid and value, the context value
  Row<float, KC> xe[kXcSlots]{};
  Row<CandT, KC> xq[kXcSlots]{};
  float xs[kXcSlots]{}, xz[kXcSlots]{}, xv[kXcSlots]{}, xsv[kXcSlots]{};
#pragma unroll
  for (int m = 0; m < nX; ++m) {
    const int o = lane + 32 * m;
    const int jc = quo(o, p.fc), i = o - jc * Fc;
    if (live && o < n_xc) {
      xe[m] = fetch<float, KC>(ctx + i * p.ctx_i + (Fc + jc) * p.ctx_j);
      xq[m] = fetch<CandT, KC>(xb + jc * p.x_j + i * p.x_i);
      if constexpr (Q8) {
        xs[m] = __ldg(sg + jc);
        xz[m] = __ldg(zg + jc);
      }
      xv[m] = __ldg(vc + jc);
      xsv[m] = sv[i];
    }
  }
  // cand x cand, o = lane + 32m over (ic, jc), ic < jc: rows (ic, jc) and
  // (jc, ic), their grids and values
  Row<CandT, KC> pa[kAaSlots]{}, pb[kAaSlots]{};
  float asi[kAaSlots]{}, azi[kAaSlots]{}, asj[kAaSlots]{}, azj[kAaSlots]{};
  float avi[kAaSlots]{}, avj[kAaSlots]{};
#pragma unroll
  for (int m = 0; m < nA; ++m) {
    const int o = lane + 32 * m;
    const int ic = quo(o, p.fcand), jc = o - ic * Fcand;
    if (live && o < n_aa && ic < jc) {
      pa[m] = fetch<CandT, KC>(cb + ic * p.c_i + jc * p.c_j);
      pb[m] = fetch<CandT, KC>(cb + jc * p.c_i + ic * p.c_j);
      if constexpr (Q8) {
        asi[m] = __ldg(sg + ic);
        azi[m] = __ldg(zg + ic);
        asj[m] = __ldg(sg + jc);
        azj[m] = __ldg(zg + jc);
      }
      avi[m] = __ldg(vc + ic);
      avj[m] = __ldg(vc + jc);
    }
  }

  // -- ctx x ctx: the pair matrix (tile 0 writes it) and the tail sum -----
  float* dots = ctx_dots + static_cast<int64_t>(r) * n_tail;
  float part = 0.f;
#pragma unroll
  for (int m = 0; m < nT; ++m) {
    const int o = tid + kThreads * m;
    const int i = quo(o, p.fc), j = o - i * Fc;
    if (o < n_tail && (tile0 || i < j)) {
      const float dij =
          pair_value(dot_rows<KC>(ta[m], tb[m], K), tvi[m], tvj[m]);
      if (tile0) dots[o] = dij;
      if (i < j && j >= pdepth) part = __fadd_rn(part, dij);
    }
  }
  for (int o = tid + kThreads * nT; o < n_tail; o += kThreads) {
    const int i = quo(o, p.fc), j = o - i * Fc;
    if (!(tile0 || i < j)) continue;
    const float dij = pair_value(
        dot_rows<KC>(fetch<float, KC>(ctx + i * p.ctx_i + j * p.ctx_j),
                     fetch<float, KC>(ctx + j * p.ctx_i + i * p.ctx_j), K),
        sv[i], sv[j]);
    if (tile0) dots[o] = dij;
    if (i < j && j >= pdepth) part = __fadd_rn(part, dij);
  }
  part = warp_sum(part);
  if (lane == 0) sred[warp] = part;

  // -- the candidate's terms ----------------------------------------------
  float xsum = 0.f, asum = 0.f;
  if (live) {
#pragma unroll
    for (int m = 0; m < nX; ++m) {
      if (lane + 32 * m < n_xc) {
        const float x = ctx_cand<CandT, KC>(xe[m], xq[m], K, xs[m], xz[m]);
        xsum = add_term(xsum, x, xsv[m], xv[m]);
      }
    }
    for (int o = lane + 32 * nX; o < n_xc; o += 32) {
      const int jc = quo(o, p.fc), i = o - jc * Fc;
      float s = 0.f, z = 0.f;
      if constexpr (Q8) {
        s = __ldg(sg + jc);
        z = __ldg(zg + jc);
      }
      const float x = ctx_cand<CandT, KC>(
          fetch<float, KC>(ctx + i * p.ctx_i + (Fc + jc) * p.ctx_j),
          fetch<CandT, KC>(xb + jc * p.x_j + i * p.x_i), K, s, z);
      xsum = add_term(xsum, x, sv[i], __ldg(vc + jc));
    }
#pragma unroll
    for (int m = 0; m < nA; ++m) {
      const int o = lane + 32 * m;
      const int ic = quo(o, p.fcand), jc = o - ic * Fcand;
      if (o < n_aa && ic < jc) {
        float dd;
        if constexpr (Q8) {
          dd = cand_cand_q8<KC>(pa[m], pb[m], K, asi[m], azi[m], asj[m],
                                azj[m]);
        } else {
          dd = dot_rows<KC>(pa[m], pb[m], K);
        }
        asum = add_term(asum, dd, avi[m], avj[m]);
      }
    }
    for (int o = lane + 32 * nA; o < n_aa; o += 32) {
      const int ic = quo(o, p.fcand), jc = o - ic * Fcand;
      if (ic >= jc) continue;
      const Row<CandT, KC> ra = fetch<CandT, KC>(cb + ic * p.c_i + jc * p.c_j);
      const Row<CandT, KC> rb = fetch<CandT, KC>(cb + jc * p.c_i + ic * p.c_j);
      float dd;
      if constexpr (Q8) {
        dd = cand_cand_q8<KC>(ra, rb, K, __ldg(sg + ic), __ldg(zg + ic),
                              __ldg(sg + jc), __ldg(zg + jc));
      } else {
        dd = dot_rows<KC>(ra, rb, K);
      }
      asum = add_term(asum, dd, __ldg(vc + ic), __ldg(vc + jc));
    }
  }
  xsum = warp_sum(xsum);
  asum = warp_sum(asum);

  __syncthreads();  // the one barrier: the tail's sum across warps
  float tail = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tail += sred[w];
  if (live && lane == 0) logits[rn] = b_rn + tail + xsum + asum;
}

template <typename CandT, int KC>
int launch_fused(const void* ectx, const void* vctx, const void* depth,
                 const void* base, const void* cx, const void* cc,
                 const void* scale, const void* zero, const void* vcand,
                 void* logits, void* ctx_dots, const int64_t* strides,
                 int64_t R, int64_t N, int64_t Fc, int64_t Fcand, int64_t K,
                 cudaStream_t stream) {
  FusedPlan p;
  p.ctx_r = strides[0]; p.ctx_i = strides[1]; p.ctx_j = strides[2];
  p.x_r = strides[3]; p.x_n = strides[4]; p.x_j = strides[5]; p.x_i = strides[6];
  p.c_r = strides[7]; p.c_n = strides[8]; p.c_i = strides[9]; p.c_j = strides[10];
  p.N = static_cast<int>(N);
  p.Fc = static_cast<int>(Fc);
  p.Fcand = static_cast<int>(Fcand);
  p.K = static_cast<int>(K);
  p.fc = fast_div(static_cast<uint32_t>(Fc));
  p.fcand = fast_div(static_cast<uint32_t>(Fcand));
  const int64_t tiles = N > 0 ? (N + kTileN - 1) / kTileN : 1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(R));
  ffm_fused_logits_kernel<CandT, KC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(ectx), static_cast<const float*>(vctx),
      static_cast<const int32_t*>(depth), static_cast<const float*>(base),
      static_cast<const CandT*>(cx), static_cast<const CandT*>(cc),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const float*>(vcand), static_cast<float*>(logits),
      static_cast<float*>(ctx_dots), p);
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
