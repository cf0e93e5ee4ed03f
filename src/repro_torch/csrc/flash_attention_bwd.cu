// K13 (dQ) and K12 (dK, dV): the backward of flash attention (K11,
// flash_attention.cu), for softmax(q k^T D^-1/2 + mask) v with GQA and a
// causal / sliding-window / no mask.
//
// Replaces: no Pallas kernel; the port's own. The JAX package trains through
//   its jnp flash (src/repro/models/attention.py:36, flash_attention), which
//   jax.grad differentiates through lax.scan; its Pallas kernel has no
//   backward and no train step calls it. The port sends every CUDA tensor to
//   K11, so a train step on the card needs K11's gradient: these two kernels,
//   behind the torch.autograd.Function in kernels/flash_attention/ops.py.
//
// The arithmetic (ref.py's flash_attention_bwd_ref): from K11's output O and
//   its row log-sum-exp lse (natural log), P = exp(S D^-1/2 - lse) (0 where
//   masked), Delta = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - Delta),
//   dQ = dS K D^-1/2, dK = dS^T Q D^-1/2; dK and dV summed over the G query
//   heads of each kv head. Inputs f32 or bf16; every product and sum in f32
//   (expf, no fast math); gradients written in the inputs' dtype. One
//   instance per (D, Dv) serves both dtypes: a flag picks the conversion
//   where tiles are staged in shared memory and results stored.
//
// What bounds them on the H100: 2 (3 D + 2 Dv) operations per (row, column)
//   pair the mask keeps (S, dO V^T, dV, dQ, dK), against the bytes of q, k,
//   v, O, dO, lse read once and dq, dk, dv written once. At llama3.2-1b's
//   train step (B = 4, S = 1024, H = 32, Kv = 8, D = 64, bf16, causal) that
//   is 43.0 GFLOP: 43.5 us at the 989 TFLOP/s bf16 tensor peak, against
//   about 50 MB, 15 us at 3.35 TB/s, so operations bound it. This first
//   version runs on CUDA-core f32 FMAs (67 TFLOP/s peak), so it cannot come
//   near that bound; tensor cores (wgmma, as K11's bf16 body) are its
//   redesign, a later change.
//
// Design (simple first):
//   - Both kernels: 256 threads, thread (ty, tx) = (tid / 16, tid % 16); 64
//     rows per q tile and 64 keys per k tile; tiles staged in shared memory
//     as f32 rows of W + 4 floats (16-byte rows whose starts fall on
//     different banks), rows past Sq or Sk zero-filled and masked, nothing
//     padded in device memory. A 64 x 64 block of scores is 4 x 4 per
//     thread (rows / keys ty + 16 i, columns tx + 16 j), as in K11's f32
//     body.
//   - K13 (dQ), one CTA per (b, h, q tile): loads its Q and dO rows and
//     lse; Delta per row (its 16 lanes split the Dv columns, then an xor
//     tree), written (B, H, Sq) f32 for K12; then over the k tiles the mask
//     leaves (the forward's block predicate): S, dP = dO V^T, dS into shared
//     memory, dQ += dS K in registers (rows ty + 16 i, columns tx D/16 ..).
//   - K12 (dK, dV), one CTA per (b, kv head, k tile): K and V tiles stay in
//     shared memory, dK and dV in registers (keys ty + 16 i); it loops over
//     the G query heads of the kv head in order and, for each, over the q
//     tiles that can see its keys (under the causal mask from the tile of
//     row k0 on; under a window up to row k0 + 63 + window - 1): S^T, dP^T,
//     P^T and dS^T into shared memory, then dV += P^T dO and dK += dS^T Q.
//     It runs after K13 on the stream, which wrote Delta.
//   - No atomics: each output element has one writer and every sum runs in
//     a fixed order, so two runs give the same bits; GQA's sum over heads
//     happens inside K12's CTA.
//   - Shared memory (floats): K13 2 x 64 (D + 4) + 2 x 64 (Dv + 4) + 64 x 68
//     (dS), 185,344 B at (192, 128); K12 the same tiles plus P^T and dS^T
//     (2 x 64 x 68) and 128 floats of lse and Delta, 203,264 B at (192,
//     128), both under the 232,448 B a block may use (dK and dV live in
//     registers: 80 floats a thread at (192, 128)). At D = Dv = 64 K12 takes
//     104,960 B, so two CTAs share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // rows per q tile, keys per k tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kB + 4;    // row stride (floats) of the P and dS tiles

// element i of an input array of f32, or of bf16 when bf16 is set (a flag
// uniform over the grid: one instance serves both dtypes, and the
// conversions sit only where tiles are staged and results stored)
__device__ __forceinline__ float load(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, int64_t i, float x, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows r0 .. r0 + 63 of head `head` of a (B, S, heads, W) array into
// shared memory as f32 rows of W + 4 floats; rows past S are zeros
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          bool bf16, int64_t b, int64_t r0,
                                          int64_t S, int heads, int head) {
  for (int idx = threadIdx.x; idx < kB * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int64_t row = r0 + r;
    dst[r * (W + 4) + c] =
        row < S ? load(src, ((b * S + row) * heads + head) * W + c, bf16)
                : 0.0f;
  }
}

// s[i][j] = a row (ty + 16 i) . b row (tx + 16 j) over W columns (tiles of
// rows W + 4 floats apart), f32 FMAs in column order
template <int W>
__device__ __forceinline__ void dots(float (&s)[4][4], const float* a,
                                     const float* bm, int ty, int tx) {
  constexpr int S = W + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * S + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&bm[(tx + 16 * j) * S + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        s[i][j] = fmaf(av[i].w, bv[j].w, x);
      }
  }
}

// the pair (row, col) the mask keeps (K11's: causal aligned at position 0)
__device__ __forceinline__ bool live(int64_t row, int64_t col, int64_t Sq,
                                     int64_t Sk, int causal, int64_t window) {
  return row < Sq && col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

template <int D, int Dv>
constexpr int dq_smem_floats() {
  return 2 * kB * (D + 4) + 2 * kB * (Dv + 4) + kB * kPS;
}

template <int D, int Dv>
constexpr int dkdv_smem_floats() {
  return 2 * kB * (D + 4) + 2 * kB * (Dv + 4) + 2 * kB * kPS + 2 * kB;
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const void* q, const void* k, const void* v,
                              const void* o, const float* __restrict__ lse,
                              const void* dout, void* dq,
                              float* __restrict__ delta, int64_t Sq, int64_t Sk,
                              int H, int Kv, int causal, int64_t window,
                              float scale, bool bf16) {
  constexpr int QS = D + 4, VS = Dv + 4, DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * QS;
  float* Ks = dOs + kB * VS;
  float* Vs = Ks + kB * QS;
  float* dSs = Vs + kB * VS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kB;
  const int kvh = h / (H / Kv);
  load_tile<D>(Qs, q, bf16, b, q0, Sq, H, h);
  load_tile<Dv>(dOs, dout, bf16, b, q0, Sq, H, h);
  __syncthreads();

  // Delta and lse of rows ty + 16 i: the row's 16 lanes take columns tx,
  // tx + 16, ..., then an xor tree gives every lane the sum
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    float part = 0.0f;
    if (row < Sq)
      for (int c = tx; c < Dv; c += 16)
        part = fmaf(dOs[(ty + 16 * i) * VS + c],
                    load(o, ((b * Sq + row) * H + h) * Dv + c, bf16), part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    dl[i] = part;
    ls[i] = row < Sq ? lse[(b * H + h) * Sq + row] : 0.0f;
    if (tx == 0 && row < Sq) delta[(b * H + h) * Sq + row] = part;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;

  const int64_t q_last = q0 + kB - 1;
  const int64_t nk = (Sk + kB - 1) / kB;
  for (int64_t t = 0; t < nk; ++t) {
    const int64_t k0 = t * kB;
    // K11's block predicate, uniform over the CTA
    if (causal && k0 > q_last) break;  // every later tile is dead too
    if (window > 0 && k0 + kB - 1 <= q0 - window) continue;

    __syncthreads();  // the last tile's readers are done
    load_tile<D>(Ks, k, bf16, b, k0, Sk, Kv, kvh);
    load_tile<Dv>(Vs, v, bf16, b, k0, Sk, Kv, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, ty, tx);
    dots<Dv>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = live(q0 + ty + 16 * i, k0 + tx + 16 * j, Sq, Sk,
                               causal, window);
        const float p = keep ? expf(s[i][j] * scale - ls[i]) : 0.0f;
        dSs[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys, in key order
#pragma unroll 2
    for (int j = 0; j < kB; j += 4) {
      float4 sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sa[i] = *reinterpret_cast<const float4*>(&dSs[(ty + 16 * i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kr[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) kr[c] = Ks[(j + jj) * QS + tx * DC + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc[i][c] = fmaf(lane(sa[i], jj), kr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const int64_t base = ((b * Sq + row) * H + h) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(dq, base + c, acc[i][c] * scale, bf16);
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const void* q, const void* k, const void* v,
                                const void* dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, void* dk,
                                void* dv, int64_t Sq, int64_t Sk, int H,
                                int Kv, int causal, int64_t window,
                                float scale, bool bf16) {
  constexpr int QS = D + 4, VS = Dv + 4, DC = D / 16, VC = Dv / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * QS;
  float* Qs = Vs + kB * VS;
  float* dOs = Qs + kB * QS;
  float* Ps = dOs + kB * VS;
  float* dSs = Ps + kB * kPS;
  float* Ls = dSs + kB * kPS;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kB;
  const int G = H / Kv;
  load_tile<D>(Ks, k, bf16, b, k0, Sk, Kv, kvh);
  load_tile<Dv>(Vs, v, bf16, b, k0, Sk, Kv, kvh);

  float gk[4][DC], gv[4][VC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < VC; ++c) gv[i][c] = 0.0f;
  }

  // the q tiles whose rows can see keys k0 .. k0 + 63: from row k0 under
  // the causal mask; up to row k0 + 63 + window - 1 under a window
  const int64_t nq = (Sq + kB - 1) / kB;
  const int64_t t_lo = causal ? k0 / kB : 0;
  int64_t t_hi = nq;
  if (window > 0) {
    const int64_t last = (k0 + kB - 1 + window - 1) / kB + 1;
    t_hi = last < nq ? last : nq;
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int64_t t = t_lo; t < t_hi; ++t) {
      const int64_t q0 = t * kB;
      __syncthreads();  // the last tile's readers are done
      load_tile<D>(Qs, q, bf16, b, q0, Sq, H, h);
      load_tile<Dv>(dOs, dout, bf16, b, q0, Sq, H, h);
      if (tid < kB) {
        const int64_t row = q0 + tid;
        Ls[tid] = row < Sq ? lse[(b * H + h) * Sq + row] : 0.0f;
        Ds[tid] = row < Sq ? delta[(b * H + h) * Sq + row] : 0.0f;
      }
      __syncthreads();

      // transposed blocks: keys ty + 16 i, rows tx + 16 j
      float s[4][4], dp[4][4];
      dots<D>(s, Ks, Qs, ty, tx);
      dots<Dv>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool keep = live(q0 + r, k0 + ty + 16 * i, Sq, Sk, causal,
                                 window);
          const float p = keep ? expf(s[i][j] * scale - Ls[r]) : 0.0f;
          Ps[(ty + 16 * i) * kPS + r] = p;
          dSs[(ty + 16 * i) * kPS + r] = p * (dp[i][j] - Ds[r]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 rows, in row order
#pragma unroll 2
      for (int r = 0; r < kB; r += 4) {
        float4 pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (ty + 16 * i) * kPS + r;
          pa[i] = *reinterpret_cast<const float4*>(&Ps[at]);
          sa[i] = *reinterpret_cast<const float4*>(&dSs[at]);
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float dor[VC], qr[DC];
#pragma unroll
          for (int c = 0; c < VC; ++c)
            dor[c] = dOs[(r + rr) * VS + tx * VC + c];
#pragma unroll
          for (int c = 0; c < DC; ++c) qr[c] = Qs[(r + rr) * QS + tx * DC + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int c = 0; c < VC; ++c)
              gv[i][c] = fmaf(lane(pa[i], rr), dor[c], gv[i][c]);
#pragma unroll
            for (int c = 0; c < DC; ++c)
              gk[i][c] = fmaf(lane(sa[i], rr), qr[c], gk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const int64_t row = (b * Sk + key) * Kv + kvh;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(dk, row * D + tx * DC + c, gk[i][c] * scale, bf16);
#pragma unroll
    for (int c = 0; c < VC; ++c)
      store(dv, row * Dv + tx * VC + c, gv[i][c], bf16);
  }
}

// one backward call's arguments, as the C entries take them
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int64_t B, Sq, Sk, H, Kv, causal, window, bf16;
  float scale;
  cudaStream_t stream;
};

template <int D, int Dv>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem_floats<D, Dv>() * static_cast<int>(sizeof(float));
  auto* kernel = flash_attention_bwd_dq_kernel<D, Dv>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.Sq + kB - 1) / kB),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.lse, a.dout, a.dq, a.delta, a.Sq, a.Sk,
      static_cast<int>(a.H), static_cast<int>(a.Kv), a.causal != 0, a.window,
      a.scale, a.bf16 != 0);
  return cudaGetLastError();
}

template <int D, int Dv>
cudaError_t launch_dkdv(const Args& a) {
  const int smem = dkdv_smem_floats<D, Dv>() * static_cast<int>(sizeof(float));
  auto* kernel = flash_attention_bwd_dkdv_kernel<D, Dv>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.Sk + kB - 1) / kB),
                  static_cast<unsigned>(a.Kv), static_cast<unsigned>(a.B));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.Sq, a.Sk,
      static_cast<int>(a.H), static_cast<int>(a.Kv), a.causal != 0, a.window,
      a.scale, a.bf16 != 0);
  return cudaGetLastError();
}

// (D, Dv) as one case label of the dispatch's switch
constexpr int64_t pair(int64_t d, int64_t dv) { return d << 16 | dv; }

// the (D, Dv) pairs of K11 (ops.HEAD_DIMS), one instance each for both
// dtypes: DQ_CASE / DKDV_CASE below expand one case label per pair
#define REPRO_FLASH_BWD_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(48, 32) X(192, 128)

cudaError_t dispatch_dq(const Args& a, int64_t D, int64_t Dv) {
  switch (pair(D, Dv)) {
#define DQ_CASE(d, dv) \
  case pair(d, dv):    \
    return launch_dq<d, dv>(a);
    REPRO_FLASH_BWD_PAIRS(DQ_CASE)
#undef DQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkdv(const Args& a, int64_t D, int64_t Dv) {
  switch (pair(D, Dv)) {
#define DKDV_CASE(d, dv) \
  case pair(d, dv):      \
    return launch_dkdv<d, dv>(a);
    REPRO_FLASH_BWD_PAIRS(DKDV_CASE)
#undef DKDV_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Kv,
           int64_t D, int64_t Dv, int64_t window) {
  constexpr int64_t kMax = 0x7fffffff;
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && Kv > 0 && H % Kv == 0 &&
         window >= 0 && window <= kMax && Sq <= kMax && Sk <= kMax &&
         B <= 65535 && H <= 65535 && D > 0 && Dv > 0;
}

}  // namespace

// K13. q: (B, Sq, H, D), k: (B, Sk, Kv, D), v: (B, Sk, Kv, Dv), o and dout:
// (B, Sq, H, Dv), dq: (B, Sq, H, D), all contiguous and of one dtype (f32,
// or bf16 when bf16 != 0); lse (K11's, natural log) and delta (written
// here): (B, H, Sq) f32; (D, Dv) one of K11's pairs; window 0 = no window;
// scale = D^-1/2 rounded to f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* dq, void* delta, int64_t B,
                                      int64_t Sq, int64_t Sk, int64_t H,
                                      int64_t Kv, int64_t D, int64_t Dv,
                                      int64_t causal, int64_t window,
                                      int64_t bf16, float scale, void* stream) {
  if (!valid(B, Sq, Sk, H, Kv, D, Dv, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, nullptr, nullptr, B, Sq, Sk, H,
               Kv, causal, window, bf16, scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dq(a, D, Dv));
}

// K12. q, k, v, dout as for K13; lse and delta: (B, H, Sq) f32, delta as
// K13 wrote it (launch K12 after K13 on the same stream); dk: (B, Sk, Kv, D),
// dv: (B, Sk, Kv, Dv) in the inputs' dtype.
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int64_t B,
                                        int64_t Sq, int64_t Sk, int64_t H,
                                        int64_t Kv, int64_t D, int64_t Dv,
                                        int64_t causal, int64_t window,
                                        int64_t bf16, float scale,
                                        void* stream) {
  if (!valid(B, Sq, Sk, H, Kv, D, Dv, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr,
               dk, dv, B, Sq, Sk, H, Kv, causal, window, bf16, scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dkdv(a, D, Dv));
}
