// K10: the §4.3 block-skip ReLU weight gradient dW = x^T g_masked.
//
// Replaces: src/repro/kernels/sparse_mlp/sparse_mlp.py
//   sparse_weight_grad_pallas (_sparse_dw_kernel): dW[i, j] = sum_b x[b, i] g[b, j]
//   with g already masked by the ReLU's activations, skipping every
//   (batch block, j-tile) whose masked-gradient block is all zero: the paper's
//   "identify zero global gradient scenarios upfront, prior to updating any
//   weights".
//
// What bounds it on the H100: at the training path's shapes (B = 512 rows;
//   layer 0 I = 277, J = 64; layer 1 I = 64, J = 32) the work is 18.2 / 2.1
//   MFLOP over 0.77 / 0.20 MB, 0.27 / 0.06 us at 67 TFLOP/s f32 or 3.35 TB/s.
//   Both are far under a launch, so what sets the time is the chain of
//   dependent steps inside a CTA (global round trips, barriers), not the FMA
//   rate or the bytes. The design issues every load of a CTA before its one
//   wait.
//
// Design:
//   - One CTA per 16 x 16 tile of dW (layer 0: 18 x 4 = 72 CTAs; layer 1:
//     4 x 2 = 8). The CTA takes the whole batch in 128-row blocks, in a
//     fixed order; nothing is carried between CTAs, no atomics. (A 4-CTA
//     thread-block cluster per tile that split the batch and reduced through
//     distributed shared memory was measured beside it: faster at layer 1,
//     slower at layer 0, slower for the pair, so it is not kept.)
//   - Every load is in flight before the first wait: the CTA issues the x
//     and the g tile of each block (up to kMaxStage blocks, 16 KiB each)
//     with cp.async into shared memory, 16-byte copies where the row stride
//     and the base allow it (layer 0's x, 277 floats a row, takes 4-byte
//     copies; TMA cannot map its 1,108-byte stride), then one wait and one
//     barrier. A larger batch walks its blocks in stages of kMaxStage.
//     Ragged edges are zero-filled by the copies (src-size 0).
//   - The skip: each warp owns 16 rows of a block and tests its 16 x 16
//     piece of the g tile, already in shared memory, with __any_sync; an
//     all-zero piece adds exactly 0 even where x holds inf or NaN (x is
//     loaded anyway, as the Pallas BlockSpec does; only the FMAs are
//     skipped). The plain einsum would give NaN there.
//   - Plain f32 FMAs on CUDA cores (tensor cores would need TF32): every
//     lane keeps 2 x 4 outputs in registers, one float2 of x and one float4
//     of g per row. The 8 warp partials are summed through shared memory in
//     warp order, so the result is bit-identical from launch to launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;                         // dW tile rows (i) and columns (j)
constexpr int kBK = 128;                       // batch rows per block
constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBK / kWarps;     // 16: the skip granularity
constexpr int kMaxStage = 4;                   // blocks in shared memory at once
constexpr int kDefaultSmem = 48 * 1024;

static_assert(kT * kT == kThreads, "one thread per output in the final sum");
static_assert(kRowsPerWarp == 16, "the skip test reads 16 rows per warp");

struct Block {                                 // one batch block's tiles
  float x[kBK][kT];
  float g[kBK][kT];
};

// cp.async of `Bytes` from global to shared memory; src_bytes = 0 writes
// zeros without reading (the ragged edge)
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
  }
}

// Issue the copies of one (kBK x kT) tile: rows b0.. of `src` (row length
// n), columns c0..c0+kT-1. vec: 16-byte copies (n % 4 == 0, src 16-aligned).
__device__ __forceinline__ void load_tile(float (*dst)[kT], const float* src,
                                          int64_t b0, int64_t B, int64_t n,
                                          int64_t c0, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kBK * kT / 4 / kThreads; ++q) {
      const int c = tid + kThreads * q;
      const int row = c / (kT / 4), col = c % (kT / 4) * 4;
      const int64_t b = b0 + row;
      const bool ok = b < B && c0 + col < n;
      cp_async<16>(&dst[row][col], ok ? src + b * n + c0 + col : src,
                   ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBK * kT / kThreads; ++q) {
      const int e = tid + kThreads * q;
      const int row = e / kT, col = e % kT;
      const int64_t b = b0 + row;
      const bool ok = b < B && c0 + col < n;
      cp_async<4>(&dst[row][col], ok ? src + b * n + c0 + col : src,
                  ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_weight_grad_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ out, int64_t B, int64_t I,
                          int64_t J, int stage, bool vec_x, bool vec_g) {
  extern __shared__ float4 smem4[];
  Block* blk = reinterpret_cast<Block*>(smem4);  // `stage` blocks
  __shared__ float red[kWarps][kT * kT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kT;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kT;
  const int64_t nb = (B + kBK - 1) / kBK;
  // compute: this lane's 2 x 4 outputs
  const int ii = 2 * (lane >> 2), jj = 4 * (lane & 3);

  float acc[2][4] = {};
  for (int64_t s0 = 0; s0 < nb; s0 += stage) {
    const int ns = static_cast<int>(nb - s0 < stage ? nb - s0 : stage);
    if (s0) __syncthreads();  // the last stage's tiles are consumed
    for (int q = 0; q < ns; ++q) {
      const int64_t b0 = (s0 + q) * kBK;
      load_tile(blk[q].g, g, b0, B, J, j0, vec_g, tid);
      load_tile(blk[q].x, x, b0, B, I, i0, vec_x, tid);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int q = 0; q < ns; ++q) {
      const float(*xs)[kT] = blk[q].x + warp * kRowsPerWarp;
      const float(*gs)[kT] = blk[q].g + warp * kRowsPerWarp;
      // the upfront skip: this warp's 16 x 16 piece of the g tile
      const float4 p = *reinterpret_cast<const float4*>(&gs[lane >> 2][jj]);
      const float4 r = *reinterpret_cast<const float4*>(&gs[8 + (lane >> 2)][jj]);
      const bool nz = p.x != 0.f || p.y != 0.f || p.z != 0.f || p.w != 0.f ||
                      r.x != 0.f || r.y != 0.f || r.z != 0.f || r.w != 0.f;
      if (!__any_sync(0xffffffffu, nz)) continue;
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const float2 a = *reinterpret_cast<const float2*>(&xs[k][ii]);
        const float4 c = *reinterpret_cast<const float4*>(&gs[k][jj]);
        acc[0][0] = fmaf(a.x, c.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, c.y, acc[0][1]);
        acc[0][2] = fmaf(a.x, c.z, acc[0][2]);
        acc[0][3] = fmaf(a.x, c.w, acc[0][3]);
        acc[1][0] = fmaf(a.y, c.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, c.y, acc[1][1]);
        acc[1][2] = fmaf(a.y, c.z, acc[1][2]);
        acc[1][3] = fmaf(a.y, c.w, acc[1][3]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][(ii + a) * kT + jj + c] = acc[a][c];
  __syncthreads();
  float s = red[0][tid];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w][tid];
  const int64_t i = i0 + tid / kT, j = j0 + tid % kT;
  if (i < I && j < J) out[i * J + j] = s;
}

}  // namespace

// x: (B, I) f32, g: (B, J) f32, out: (I, J) f32, all contiguous
extern "C" int sparse_weight_grad(const void* x, const void* g, void* out,
                                  int64_t B, int64_t I, int64_t J, void* stream) {
  if (B < 0 || I <= 0 || J <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (I + kT - 1) / kT, gy = (J + kT - 1) / kT;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the batch's blocks, held in shared memory kMaxStage at a time
  const int64_t nb = (B + kBK - 1) / kBK;
  const int stage = static_cast<int>(nb < 1 ? 1 : nb < kMaxStage ? nb : kMaxStage);
  const size_t smem = stage * sizeof(Block);
  // static shared memory: the warp partials
  if (smem + kWarps * kT * kT * 4 > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const bool vec_x = I % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_g = J % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  sparse_weight_grad_kernel<<<dim3(static_cast<unsigned>(gx),
                                   static_cast<unsigned>(gy)),
                              kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xf, gf, static_cast<float*>(out), B, I, J, stage, vec_x, vec_g);
  return static_cast<int>(cudaGetLastError());
}
