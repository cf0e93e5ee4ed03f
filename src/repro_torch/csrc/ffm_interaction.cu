// K2/K3: candidate-block FFM interactions against cached context partials,
// K4: the full field x field FFM interaction matrix.
//
// Replaces (src/repro/kernels/ffm_interaction/ffm_interaction.py):
//   K2 ffm_candidate_matrices    (Pallas body _cand_kernel)
//   K3 ffm_candidate_matrices_q8 (Pallas body _cand_kernel_q8)
//   K4 ffm_interaction_matrix    (Pallas body _ffm_kernel)
//
//   K2/K3: xc[r,n,i,jc]  = <ectx[r,i,jc,:], ecx[r,n,jc,i,:]> * vctx[r,i] * vc[r,n,jc]
//          aa[r,n,ic,jc] = <ecc[r,n,ic,jc,:], ecc[r,n,jc,ic,:]> * vc[r,n,ic] * vc[r,n,jc]
//          K3 takes the candidate rows as int8 codes with one (scale, zero)
//          grid per candidate row (r, n, jc) and dequantizes in registers.
//   K4:    D[b,i,j] = <E[b,i,j,:], E[b,j,i,:]> * v[b,i] * v[b,j]
//
// What bounds them on the H100: bytes, and at serving shapes the launch
//   itself. Every output is one K=8 dot (16 flops) over 32-64 bytes of
//   inputs, far below any tensor-core shape, so the arithmetic is plain FMA.
//   At R=8 rows x N=64 candidates K3 reads ~0.87 MB and writes ~0.39 MB
//   (~0.38 us at 3.35 TB/s) and K4 at B=64, F=24 reads 1.19 MB and writes
//   0.15 MB (~0.40 us), less than a kernel launch costs, so what sets their
//   time is the launch and the chain of dependent steps inside a thread
//   block: the loads, a barrier, the work that waits for them, the stores.
//
// K2/K3 design: two bodies with one arithmetic, picked per call by the C
//   entry. Both compute each output as the plain version does: int8 rows
//   dequantized in registers with __fmul_rn/__fadd_rn (bit-identical to the
//   plain version's dequantized rows; the f32 candidate block of K3 never
//   exists in device memory), fmaf over k in order, then the value
//   products, so the two bodies give the same bits.
//   - The main path (K = 8, Fcand a multiple of 4, context and candidate-
//     by-candidate rows contiguous along (jc, k), every row aligned, as the
//     engine's gathered views are): ffm_candidate_direct_kernel, no shared
//     memory and no barrier. Each thread owns four neighbouring outputs of
//     one (request row, candidate), xc[r,n,i,4q..4q+3] or aa[r,n,ic,4q..4q+3];
//     it issues every load they need at once (the four context rows as eight
//     float4, the four candidate rows, float4s of scale / zero / vcand),
//     then computes and stores one float4. 24,576 threads at the main-path
//     bucket, kDirectThreads to a block.
//   - Every other shape (runtime K, Fcand not a multiple of 4, unaligned
//     views): ffm_candidate_matrices_kernel. The Pallas kernels keep a
//     request's context block resident in VMEM while the grid walks
//     candidate tiles; here one CTA takes one (request row, tile of kTileN
//     candidates): it stages the row's context block (Fc, Fcand, K) f32 and
//     its values in shared memory once, then its threads walk the tile's
//     (n, i, jc) and (n, ic, jc) outputs, one output per thread per step.
//     Candidate rows are each read once straight from global memory (K=8
//     with aligned rows: two float4, or one 8-byte load of int8 codes).
//     Strided candidate blocks are read in place (the context/candidate
//     column halves of one gathered block are views); only the K axis must
//     be contiguous.
//
// K4 design: ffm_interaction_matrix_kernel, the same kind of register-
//   direct body, one thread per output D[b,i,j] (consecutive threads on
//   consecutive j, so the stores coalesce), kDirectThreads to a block: B*F^2
//   threads, 36,864 (288 blocks) at the main path's B=64, F=24. Each thread
//   issues its loads at once: E[b,i,j,:] and E[b,j,i,:] (at K = 8 two float4
//   each in f32, one 16-byte word each in bf16; a runtime-K loop of scalar
//   loads otherwise) and v[b,i], v[b,j]; then fmaf over k in order and one
//   store. No shared memory and no barrier, so nothing bounds F. Each E row
//   is read by two threads but crosses device memory once (the second read
//   finds it in L2). Staging each example's (F, F, K) block in shared memory
//   instead would give B=64 examples 64 CTAs for 132 SMs, put a barrier
//   behind the copies, and read the transposed rows F*K words apart, all in
//   one bank. It reads f32 or bf16, accumulates in f32 and writes the input
//   type; fmaf and v_i * v_j commute in their operands, so D[b,i,j] ==
//   D[b,j,i] exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 256;       // threads per CTA, K2/K3's staged body
constexpr int kTileN = 4;          // candidates per CTA, staged body
constexpr int kDirectThreads = 128;  // threads per block, direct bodies
constexpr int kDefaultSmem = 48 * 1024;

template <bool Q8>
__device__ __forceinline__ float dq(float c, float s, float z) {
  if constexpr (Q8) {
    return __fadd_rn(__fmul_rn(c, s), z);
  } else {
    return c;
  }
}

// Eight consecutive elements as floats (int8 codes not yet dequantized).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 w = __ldg(reinterpret_cast<const int2*>(p));
  const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = static_cast<float>(c[k]);
}

// <a, dq(q)>: a is a context row in shared memory, q a candidate row.
// KC == 8 reads q with vector loads; KC == 0 loops over a runtime K.
template <typename CandT, int KC>
__device__ __forceinline__ float dot_ctx(const float* a, const CandT* q, int K,
                                         float s, float z) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  float acc = 0.f;
  if constexpr (KC == 8) {
    float c[8];
    load8(q, c);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(a[k], dq<Q8>(c[k], s, z), acc);
  } else {
    for (int k = 0; k < K; ++k)
      acc = fmaf(a[k], dq<Q8>(static_cast<float>(q[k]), s, z), acc);
  }
  return acc;
}

// <dq(p), dq(q)> for two candidate rows, each with its own grid.
template <typename CandT, int KC>
__device__ __forceinline__ float dot_cand(const CandT* p, const CandT* q, int K,
                                          float sp, float zp, float sq,
                                          float zq) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  float acc = 0.f;
  if constexpr (KC == 8) {
    float a[8], b[8];
    load8(p, a);
    load8(q, b);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = fmaf(dq<Q8>(a[k], sp, zp), dq<Q8>(b[k], sq, zq), acc);
  } else {
    for (int k = 0; k < K; ++k)
      acc = fmaf(dq<Q8>(static_cast<float>(p[k]), sp, zp),
                 dq<Q8>(static_cast<float>(q[k]), sq, zq), acc);
  }
  return acc;
}

// Element strides (the K axis is contiguous in all three blocks):
//   ectx (r, i, jc), ecx (r, n, jc, i), ecc (r, n, ic, jc).
struct CandStrides {
  int64_t ctx_r, ctx_i, ctx_j;
  int64_t x_r, x_n, x_j, x_i;
  int64_t c_r, c_n, c_i, c_j;
};

template <typename CandT, int KC>
__global__ void __launch_bounds__(kThreads)
ffm_candidate_matrices_kernel(const float* __restrict__ ectx,
                              const float* __restrict__ vctx,
                              const CandT* __restrict__ ecx,
                              const CandT* __restrict__ ecc,
                              const float* __restrict__ scale,
                              const float* __restrict__ zero,
                              const float* __restrict__ vcand,
                              float* __restrict__ xc, float* __restrict__ aa,
                              CandStrides st, int N, int Fc, int Fcand, int K) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  extern __shared__ float4 smem4[];
  float* sctx = reinterpret_cast<float*>(smem4);  // (Fc, Fcand, K)
  float* sv = sctx + Fc * Fcand * K;              // (Fc,)
  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int nn = min(kTileN, N - n0);

  const int ctx_len = Fc * Fcand * K;
  for (int t = threadIdx.x; t < ctx_len; t += blockDim.x) {
    const int i = t / (Fcand * K);
    const int rem = t - i * Fcand * K;
    const int j = rem / K;
    const int k = rem - j * K;
    sctx[t] = ectx[r * st.ctx_r + i * st.ctx_i + j * st.ctx_j + k];
  }
  for (int t = threadIdx.x; t < Fc; t += blockDim.x)
    sv[t] = vctx[static_cast<int64_t>(r) * Fc + t];
  __syncthreads();

  const int64_t rn0 = static_cast<int64_t>(r) * N + n0;  // first (r, n) row

  // ctx-cand block: (nn, Fc, Fcand) outputs
  const int nxc = Fc * Fcand;
  for (int o = threadIdx.x; o < nn * nxc; o += blockDim.x) {
    const int dn = o / nxc;
    const int rem = o - dn * nxc;
    const int i = rem / Fcand;
    const int jc = rem - i * Fcand;
    const int64_t g = (rn0 + dn) * Fcand + jc;  // candidate row (r, n, jc)
    float s = 0.f, z = 0.f;
    if constexpr (Q8) {
      s = scale[g];
      z = zero[g];
    }
    const CandT* q = ecx + r * st.x_r + (n0 + dn) * st.x_n + jc * st.x_j +
                     i * st.x_i;
    const float d = dot_ctx<CandT, KC>(sctx + (i * Fcand + jc) * K, q, K, s, z);
    xc[(rn0 + dn) * nxc + rem] = d * sv[i] * vcand[g];
  }

  // cand-cand block: (nn, Fcand, Fcand) outputs
  const int naa = Fcand * Fcand;
  for (int o = threadIdx.x; o < nn * naa; o += blockDim.x) {
    const int dn = o / naa;
    const int rem = o - dn * naa;
    const int ic = rem / Fcand;
    const int jc = rem - ic * Fcand;
    const int64_t gi = (rn0 + dn) * Fcand + ic;
    const int64_t gj = (rn0 + dn) * Fcand + jc;
    float si = 0.f, zi = 0.f, sj = 0.f, zj = 0.f;
    if constexpr (Q8) {
      si = scale[gi];
      zi = zero[gi];
      sj = scale[gj];
      zj = zero[gj];
    }
    const CandT* base = ecc + r * st.c_r + (n0 + dn) * st.c_n;
    const CandT* p = base + ic * st.c_i + jc * st.c_j;
    const CandT* q = base + jc * st.c_i + ic * st.c_j;
    const float d = dot_cand<CandT, KC>(p, q, K, si, zi, sj, zj);
    aa[(rn0 + dn) * naa + rem] = d * vcand[gi] * vcand[gj];
  }
}

template <typename CandT, int KC>
int launch_candidates(const void* ectx, const void* vctx, const void* ecx,
                      const void* ecc, const void* scale, const void* zero,
                      const void* vcand, void* xc, void* aa,
                      const int64_t* strides, int64_t R, int64_t N, int64_t Fc,
                      int64_t Fcand, int64_t K, cudaStream_t stream) {
  CandStrides st;
  st.ctx_r = strides[0]; st.ctx_i = strides[1]; st.ctx_j = strides[2];
  st.x_r = strides[3]; st.x_n = strides[4]; st.x_j = strides[5]; st.x_i = strides[6];
  st.c_r = strides[7]; st.c_n = strides[8]; st.c_i = strides[9]; st.c_j = strides[10];
  const size_t smem = (Fc * Fcand * K + Fc) * sizeof(float);
  auto kernel = ffm_candidate_matrices_kernel<CandT, KC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((N + kTileN - 1) / kTileN),
                  static_cast<unsigned>(R));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ectx), static_cast<const float*>(vctx),
      static_cast<const CandT*>(ecx), static_cast<const CandT*>(ecc),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const float*>(vcand), static_cast<float*>(xc),
      static_cast<float*>(aa), st, static_cast<int>(N), static_cast<int>(Fc),
      static_cast<int>(Fcand), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

// The main path's body (see the header): a thread owns four outputs of one
// (r, n) row; the first n_xc threads take xc, the rest aa.
struct DirectPlan {
  int64_t ctx_r, ctx_i;          // element strides of ectx (ctx_j == 8)
  int64_t x_r, x_n, x_j, x_i;    // of ecx
  int64_t c_r, c_n, c_i;         // of ecc (c_j == 8)
  int N, Fc, Fcand;
  FastDiv quads, fc, fcand, n;   // Fcand / 4, Fc, Fcand, N
  int n_xc, total;               // threads of the xc part, of both parts
};

template <typename CandT>
__global__ void __launch_bounds__(kDirectThreads)
ffm_candidate_direct_kernel(const float* __restrict__ ectx,
                            const float* __restrict__ vctx,
                            const CandT* __restrict__ ecx,
                            const CandT* __restrict__ ecc,
                            const float* __restrict__ scale,
                            const float* __restrict__ zero,
                            const float* __restrict__ vcand,
                            float* __restrict__ xc, float* __restrict__ aa,
                            const DirectPlan p) {
  constexpr bool Q8 = std::is_same<CandT, int8_t>::value;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.total) return;
  const bool is_xc = g < p.n_xc;
  const uint32_t u = is_xc ? g : g - p.n_xc;
  const uint32_t t = quo(u, p.quads);
  const int jc0 = 4 * static_cast<int>(u - t * p.quads.d);
  const uint32_t rn = quo(t, is_xc ? p.fc : p.fcand);   // the (r, n) row
  const int row = t - rn * (is_xc ? p.fc.d : p.fcand.d);  // i or ic
  const uint32_t r = quo(rn, p.n);
  const int n = rn - r * p.n.d;
  const int64_t g0 = static_cast<int64_t>(rn) * p.Fcand + jc0;  // (r, n, jc0)
  const float4 v4 = *reinterpret_cast<const float4*>(vcand + g0);
  float4 s4 = {}, z4 = {};
  if constexpr (Q8) {
    s4 = *reinterpret_cast<const float4*>(scale + g0);
    z4 = *reinterpret_cast<const float4*>(zero + g0);
  }
  const float sj[4] = {s4.x, s4.y, s4.z, s4.w};
  const float zj[4] = {z4.x, z4.y, z4.z, z4.w};
  const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
  float o[4];
  if (is_xc) {
    // context rows (i, jc0..jc0+3), candidate rows (r, n, jc, i)
    const float* a = ectx + r * p.ctx_r + row * p.ctx_i + jc0 * 8;
    float av[32], c[4][8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<float4*>(&av[4 * q]) =
          reinterpret_cast<const float4*>(a)[q];
    const CandT* x = ecx + r * p.x_r + n * p.x_n + row * p.x_i;
#pragma unroll
    for (int q = 0; q < 4; ++q) load8(x + (jc0 + q) * p.x_j, c[q]);
    const float sv = vctx[static_cast<int64_t>(r) * p.Fc + row];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc = fmaf(av[8 * q + k], dq<Q8>(c[q][k], sj[q], zj[q]), acc);
      o[q] = acc * sv * vj[q];
    }
    *reinterpret_cast<float4*>(xc + (static_cast<int64_t>(rn) * p.Fc + row) *
                                        p.Fcand + jc0) =
        make_float4(o[0], o[1], o[2], o[3]);
  } else {
    // rows (r, n, ic, jc0..jc0+3) and (r, n, jc, ic), each with its grid
    const CandT* base = ecc + r * p.c_r + n * p.c_n;
    float pr[4][8], qr[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      load8(base + row * p.c_i + (jc0 + q) * 8, pr[q]);
      load8(base + (jc0 + q) * p.c_i + row * 8, qr[q]);
    }
    const int64_t gi = static_cast<int64_t>(rn) * p.Fcand + row;
    const float vi = vcand[gi];
    float si = 0.f, zi = 0.f;
    if constexpr (Q8) {
      si = scale[gi];
      zi = zero[gi];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc = fmaf(dq<Q8>(pr[q][k], si, zi), dq<Q8>(qr[q][k], sj[q], zj[q]),
                   acc);
      o[q] = acc * vi * vj[q];
    }
    *reinterpret_cast<float4*>(aa + gi * p.Fcand + jc0) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Whether a call fits the direct body: K = 8, Fcand a multiple of 4, the
// context rows (jc, k) and candidate-by-candidate rows (jc, k) contiguous,
// every row aligned for its vector loads (16 bytes; int8 candidate rows 8).
template <typename CandT>
bool direct_fits(const void* ectx, const void* ecx, const void* ecc,
                 const void* scale, const void* zero, const void* vcand,
                 const int64_t* st, int64_t R, int64_t N, int64_t Fc,
                 int64_t Fcand, int64_t K) {
  const int64_t sz = sizeof(CandT);
  const int64_t ra = sz == 1 ? 8 : 16;
  auto aligned = [](const void* q, int64_t a) {
    return reinterpret_cast<uintptr_t>(q) % a == 0;
  };
  bool ok = K == 8 && Fcand > 0 && Fcand % 4 == 0 &&
            R * N * (Fc + Fcand) * (Fcand / 4) < (int64_t{1} << 31) &&
            st[2] == 8 && st[10] == 8 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
            aligned(ectx, 16) && aligned(vcand, 16) && aligned(ecx, ra) &&
            aligned(ecc, ra) &&
            (sz == 4 || (aligned(scale, 16) && aligned(zero, 16)));
  for (int q = 3; q < 10; ++q) ok = ok && st[q] * sz % ra == 0;
  return ok;
}

template <typename CandT>
int launch_direct(const void* ectx, const void* vctx, const void* ecx,
                  const void* ecc, const void* scale, const void* zero,
                  const void* vcand, void* xc, void* aa, const int64_t* st,
                  int64_t R, int64_t N, int64_t Fc, int64_t Fcand,
                  cudaStream_t stream) {
  const int64_t quads = Fcand / 4;
  const int64_t total = R * N * (Fc + Fcand) * quads;
  DirectPlan p;
  p.ctx_r = st[0]; p.ctx_i = st[1];
  p.x_r = st[3]; p.x_n = st[4]; p.x_j = st[5]; p.x_i = st[6];
  p.c_r = st[7]; p.c_n = st[8]; p.c_i = st[9];
  p.N = static_cast<int>(N);
  p.Fc = static_cast<int>(Fc);
  p.Fcand = static_cast<int>(Fcand);
  p.quads = fast_div(static_cast<uint32_t>(quads));
  p.fc = fast_div(static_cast<uint32_t>(Fc));
  p.fcand = fast_div(static_cast<uint32_t>(Fcand));
  p.n = fast_div(static_cast<uint32_t>(N));
  p.n_xc = static_cast<int>(R * N * Fc * quads);
  p.total = static_cast<int>(total);
  ffm_candidate_direct_kernel<CandT>
      <<<static_cast<unsigned>((total + kDirectThreads - 1) / kDirectThreads),
         kDirectThreads, 0, stream>>>(
          static_cast<const float*>(ectx), static_cast<const float*>(vctx),
          static_cast<const CandT*>(ecx), static_cast<const CandT*>(ecc),
          static_cast<const float*>(scale), static_cast<const float*>(zero),
          static_cast<const float*>(vcand), static_cast<float*>(xc),
          static_cast<float*>(aa), p);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Eight consecutive bf16 elements as floats: one 16-byte load.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = __bfloat162float(h[k]);
}

struct InteractionPlan {
  FastDiv ff, f;  // F * F, F
  int K;
  int total;      // B * F * F threads, one per output
};

// K4 (see the header): thread g computes D[b, i, j] = out[g]. KC == 8
// loads both K = 8 rows as vectors; KC == 0 loops over a runtime K.
template <typename T, int KC>
__global__ void __launch_bounds__(kDirectThreads)
ffm_interaction_matrix_kernel(const T* __restrict__ e, const T* __restrict__ v,
                              T* __restrict__ out, const InteractionPlan p) {
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= static_cast<uint32_t>(p.total)) return;
  const uint32_t b = quo(g, p.ff);
  const uint32_t ij = g - b * p.ff.d;
  const uint32_t i = quo(ij, p.f);
  const uint32_t j = ij - i * p.f.d;
  const int64_t F = p.f.d;
  const int64_t K = KC ? KC : p.K;
  const int64_t bf = static_cast<int64_t>(b) * F;  // row (b, 0) of v
  const T* a = e + ((bf + i) * F + j) * K;         // E[b, i, j, :]
  const T* c = e + ((bf + j) * F + i) * K;         // E[b, j, i, :]
  const float vi = to_f32(v[bf + i]);
  const float vj = to_f32(v[bf + j]);
  float acc = 0.f;
  if constexpr (KC == 8) {
    float x[8], y[8];
    load8(a, x);
    load8(c, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(x[k], y[k], acc);
  } else {
    for (int k = 0; k < K; ++k) acc = fmaf(to_f32(a[k]), to_f32(c[k]), acc);
  }
  store(out + g, acc * (vi * vj));
}

template <typename T>
int launch_interaction(const void* e, const void* v, void* out, int64_t B,
                       int64_t F, int64_t K, cudaStream_t stream) {
  const int64_t total = B * F * F;
  if (total >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  InteractionPlan p;
  p.ff = fast_div(static_cast<uint32_t>(F * F));
  p.f = fast_div(static_cast<uint32_t>(F));
  p.K = static_cast<int>(K);
  p.total = static_cast<int>(total);
  const unsigned blocks =
      static_cast<unsigned>((total + kDirectThreads - 1) / kDirectThreads);
  // K = 8 rows (32 bytes f32, 16 bf16) are all 16-byte aligned when e is
  auto kernel = K == 8 && reinterpret_cast<uintptr_t>(e) % 16 == 0
                    ? &ffm_interaction_matrix_kernel<T, 8>
                    : &ffm_interaction_matrix_kernel<T, 0>;
  kernel<<<blocks, kDirectThreads, 0, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(v), static_cast<T*>(out),
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ffm_candidate_matrices(const void* ectx, const void* vctx,
                                      const void* ecx, const void* ecc,
                                      const void* vcand, void* xc, void* aa,
                                      const void* strides, int64_t R, int64_t N,
                                      int64_t Fc, int64_t Fcand, int64_t K,
                                      int64_t vec8, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const auto* st = static_cast<const int64_t*>(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (direct_fits<float>(ectx, ecx, ecc, nullptr, nullptr, vcand, st, R, N,
                         Fc, Fcand, K))
    return launch_direct<float>(ectx, vctx, ecx, ecc, nullptr, nullptr, vcand,
                                xc, aa, st, R, N, Fc, Fcand, s);
  if (vec8)
    return launch_candidates<float, 8>(ectx, vctx, ecx, ecc, nullptr, nullptr,
                                       vcand, xc, aa, st, R, N, Fc, Fcand, K, s);
  return launch_candidates<float, 0>(ectx, vctx, ecx, ecc, nullptr, nullptr,
                                     vcand, xc, aa, st, R, N, Fc, Fcand, K, s);
}

extern "C" int ffm_candidate_matrices_q8(const void* ectx, const void* vctx,
                                         const void* qcx, const void* qcc,
                                         const void* vcand, const void* scale,
                                         const void* zero, void* xc, void* aa,
                                         const void* strides, int64_t R,
                                         int64_t N, int64_t Fc, int64_t Fcand,
                                         int64_t K, int64_t vec8, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const auto* st = static_cast<const int64_t*>(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (direct_fits<int8_t>(ectx, qcx, qcc, scale, zero, vcand, st, R, N, Fc,
                          Fcand, K))
    return launch_direct<int8_t>(ectx, vctx, qcx, qcc, scale, zero, vcand, xc,
                                 aa, st, R, N, Fc, Fcand, s);
  if (vec8)
    return launch_candidates<int8_t, 8>(ectx, vctx, qcx, qcc, scale, zero,
                                        vcand, xc, aa, st, R, N, Fc, Fcand, K, s);
  return launch_candidates<int8_t, 0>(ectx, vctx, qcx, qcc, scale, zero, vcand,
                                      xc, aa, st, R, N, Fc, Fcand, K, s);
}

extern "C" int ffm_interaction_matrix(const void* e, const void* v, void* out,
                                      int64_t B, int64_t F, int64_t K,
                                      int64_t bf16, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_interaction<__nv_bfloat16>(e, v, out, B, F, K, s);
  return launch_interaction<float>(e, v, out, B, F, K, s);
}
