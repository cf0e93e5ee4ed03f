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
//   dependent steps inside a CTA (global loads, barriers), not the FMA rate.
//
// Design:
//   - One CTA per 16 x 16 tile of dW (layer 0: 18 x 4 = 72 CTAs). The CTA
//     walks the batch in blocks of 128 rows in a fixed order. The TPU grid's
//     sequential reduction axis becomes this loop; nothing is carried between
//     CTAs, no split across CTAs, no atomics.
//   - Each block: every thread loads 8 values of the g tile into registers,
//     and __syncthreads_or over "any value != 0" decides for the whole CTA
//     whether the block is live. Only a live block loads its x tile; both
//     tiles go to shared memory. The next block's g values are loaded while
//     this block's FMAs run.
//   - Inside a block the 8 warps split the 128 rows (16 each) and every lane
//     keeps 2 x 4 outputs in registers (one float2 of x and one float4 of g
//     from shared memory per row: 8 FMAs for 2 loads). At the end the 8 warp
//     partials are summed through shared memory in warp order, so the result
//     is bit-identical from launch to launch.
//   - Ragged edges are masked (zeros in shared memory, guarded stores); the
//     Pallas wrapper pads the arrays instead.
//   - As with the Pallas kernel, a skipped block contributes exactly 0 even
//     where x holds inf or NaN; the plain einsum would give NaN there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTI = 16;                        // dW tile rows (i)
constexpr int kTJ = 16;                        // dW tile columns (j)
constexpr int kBK = 128;                       // batch rows per block
constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBK / kWarps;     // 16
constexpr int kPer = kBK * kTJ / kThreads;     // tile values each thread loads: 8
constexpr int kLoadRows = kThreads / kTJ;      // rows a load pass covers: 16

static_assert(kTI == kTJ, "one loader mapping serves both tiles");
static_assert(kTI * kTJ == kThreads, "one thread per output in the final sum");

__global__ void __launch_bounds__(kThreads)
sparse_weight_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          float* __restrict__ out, int64_t B, int64_t I, int64_t J) {
  __shared__ __align__(16) float xs[kBK][kTI];
  __shared__ __align__(16) float gs[kBK][kTJ];
  __shared__ float red[kWarps][kTI * kTJ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kTJ;
  // loader: value q of this thread is row lr + 16 q, column lc of the tile
  // (a warp reads 16 consecutive floats of two rows)
  const int lc = tid % kTJ, lr = tid / kTJ;
  const bool x_in = i0 + lc < I, g_in = j0 + lc < J;
  // compute: this lane's 2 x 4 outputs
  const int ii = 2 * (lane >> 2), jj = 4 * (lane & 3);

  float acc[2][4] = {};
  float gr[kPer];
  auto load_g = [&](int64_t b0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int64_t b = b0 + lr + kLoadRows * q;
      gr[q] = (g_in && b < B) ? __ldg(g + b * J + j0 + lc) : 0.0f;
    }
  };

  load_g(0);
  for (int64_t b0 = 0; b0 < B; b0 += kBK) {
    bool nz = false;
#pragma unroll
    for (int q = 0; q < kPer; ++q) nz |= gr[q] != 0.0f;
    // the upfront skip; also the barrier that frees the tiles of the last block
    const bool live = __syncthreads_or(nz);
    if (live) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int r = lr + kLoadRows * q;
        const int64_t b = b0 + r;
        gs[r][lc] = gr[q];
        xs[r][lc] = (x_in && b < B) ? __ldg(x + b * I + i0 + lc) : 0.0f;
      }
    }
    if (b0 + kBK < B) load_g(b0 + kBK);
    if (live) {
      __syncthreads();
#pragma unroll 4
      for (int k = warp * kRowsPerWarp; k < (warp + 1) * kRowsPerWarp; ++k) {
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
    for (int c = 0; c < 4; ++c) red[warp][(ii + a) * kTJ + jj + c] = acc[a][c];
  __syncthreads();
  float s = red[0][tid];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w][tid];
  const int64_t i = i0 + tid / kTJ, j = j0 + tid % kTJ;
  if (i < I && j < J) out[i * J + j] = s;
}

}  // namespace

// x: (B, I) f32, g: (B, J) f32, out: (I, J) f32, all contiguous
extern "C" int sparse_weight_grad(const void* x, const void* g, void* out,
                                  int64_t B, int64_t I, int64_t J, void* stream) {
  if (B < 0 || I <= 0 || J <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (I + kTI - 1) / kTI, gy = (J + kTJ - 1) / kTJ;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  sparse_weight_grad_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(out), B, I, J);
  return static_cast<int>(cudaGetLastError());
}
