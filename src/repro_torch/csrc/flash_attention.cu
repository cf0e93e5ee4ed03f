// K11: flash attention, softmax(q k^T D^-1/2 + mask) v with an online
// softmax, GQA, and causal / sliding-window / no mask.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention_pallas (body _flash_kernel): grid (B*H, q blocks, k
//   blocks) with k innermost; the running max m, the running sum l and the
//   f32 output accumulator persist in VMEM across the sequential k sweep; a
//   block above the causal diagonal or outside the window is skipped; masked
//   scores are the finite NEG_INF = -1e30; P is cast to v's dtype before the
//   PV dot; out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: at the serving prefill's shape (B = 4,
//   S = 1024, H = 32, Kv = 8, D = 64, bf16, causal) the work is 17.2 GFLOP
//   over 41.9 MB of Q, K, V and O: 17.4 us at the 989 TFLOP/s bf16 tensor
//   peak against 12.5 us at 3.35 TB/s, so operations bound it. This kernel
//   uses no tensor cores: its arithmetic runs as f32 FMAs (67 TFLOP/s peak,
//   0.26 ms for the same work), fed from shared memory. It is the simple,
//   right version; wgmma, TMA and bf16 tensor cores are later work.
//
// Design:
//   - One CTA of 256 threads owns a (batch row b, query head h, 64-row query
//     tile) outright and writes its output once: no atomics, no split of
//     the k sweep across CTAs. The TPU grid's sequential k axis becomes a
//     loop over 64-column k tiles. Query head h reads KV head h / (H / Kv)
//     of the same batch row, as the Pallas index map does; q, k and v are
//     read in place from their (B, S, heads, D) layouts.
//   - A dead tile (every column above the causal diagonal, or every column
//     at or before the window's start, for every row of the tile) is
//     skipped by the whole CTA, with the Pallas kernel's predicate.
//   - Tiles are staged in shared memory as f32 (bf16 widened exactly);
//     rows past Sq or Sk are zero-filled and masked (cols < Sk), never
//     padded in device memory.
//   - Thread (ty, tx) = (tid / 16, tid % 16) owns the scores of rows
//     ty + 16 i and columns tx + 16 j (i, j < 4) and the outputs of the same
//     rows, columns tx * D/16 .. + D/16. A row's 64 scores sit in the 16
//     lanes of one half-warp, so the row max and sum are xor-shuffle trees
//     (identical in every lane) and m, l and the rescale factor stay in
//     registers; only P goes through shared memory, rounded to v's dtype
//     first (p.astype(v.dtype) in the Pallas kernel), while l sums the
//     unrounded p as the Pallas kernel does.
//   - The dot is scaled after it is taken; masked scores are -1e30, so a
//     row whose first live tile is wholly masked for it gets p = 1 there
//     and the next tile's exp(-1e30 - m) = 0 wipes it out, as in both JAX
//     versions (with -INFINITY that would be inf - inf = NaN).
//   - expf and IEEE division (no fast math): the f32 case is held to 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // k columns per tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr float kNegInf = -1e30f;
constexpr int kPS = kBK + 4;    // row stride of P in shared memory (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// shared memory of one CTA (floats): Q and K tiles with rows of D + 4 (16-byte
// rows whose starts fall on different banks), the V tile, the P tile
template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t Sq, int64_t Sk, int H, int Kv, int causal,
                       int64_t window, float scale) {
  constexpr int QS = D + 4;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int kvh = h / (H / Kv);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t row = q0 + r;
    Qs[r * QS + d] = row < Sq ? to_f32(q[((b * Sq + row) * H + h) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int64_t q_last = q0 + kBQ - 1;
  const int64_t nk = (Sk + kBK - 1) / kBK;
  for (int64_t t = 0; t < nk; ++t) {
    const int64_t k0 = t * kBK;
    // the Pallas kernel's block_live, uniform over the CTA
    if (causal && k0 > q_last) break;  // every later tile is dead too
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();  // the last tile's readers are done (and Q is stored)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int64_t col = k0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (col < Sk) {
        const int64_t off = ((b * Sk + col) * Kv + kvh) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * QS + d] = kk;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          s[i][j] = fmaf(qa[i].w, kb[j].w, a);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        const bool live = col < Sk && (!causal || col <= row) &&
                          (window <= 0 || col > row - window);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[i][c] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vr[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vr[c] = Vs[(j + jj) * D + tx * DC + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            pv[i][c] = fmaf(lane(pa[i], jj), vr[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = acc[i][c] * corr[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((b * Sq + row) * H + h) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Kv,
                   int64_t causal, int64_t window, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto* kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk,
      static_cast<int>(H), static_cast<int>(Kv), causal != 0, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t D, const void* q, const void* k, const void* v,
                     void* out, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                     int64_t Kv, int64_t causal, int64_t window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, Kv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, Sk, Kv, D), out: (B, Sq, H, D), all contiguous
// and of one dtype (f32, or bf16 when bf16 != 0); D in {16, 32, 64, 128};
// window 0 = no window; scale = D^-1/2 rounded to f32
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t B, int64_t Sq, int64_t Sk,
                               int64_t H, int64_t Kv, int64_t D, int64_t causal,
                               int64_t window, int64_t bf16, float scale,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 ||
      window < 0 || B > 65535 || H > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, Kv, causal,
                                     window, scale, s)
           : dispatch<float>(D, q, k, v, out, B, Sq, Sk, H, Kv, causal, window,
                             scale, s);
  return static_cast<int>(err);
}
