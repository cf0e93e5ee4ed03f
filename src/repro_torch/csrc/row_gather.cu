// K1: gather rows of an int8 row-quantized table and dequantize them.
//
// Replaces: src/repro/kernels/row_gather/row_gather.py:gather_dequant_rows_q8
//   (Pallas body _gather_dequant_kernel):
//   out[i, :] = codes[idx[i], :] * scale[idx[i]] + zero[idx[i]].
//
// What bounds it on the H100: bytes, and at serving shapes the launch
//   itself. A gathered row reads its L int8 codes, two f32 grid scalars and
//   one int32 index and writes 4L bytes of f32; at the default width (F=24,
//   K=8, L=192) that is 204 B in and 768 B out for 2 flops per element, far
//   under the card's ops:byte balance. The main path gathers 1,536 such rows
//   (1.49 MB, ~0.45 us at 3.35 TB/s), less than a launch costs, so what sets
//   the time is the launch and each thread's chain of dependent loads: the
//   index, then the codes and the grid, then the stores.
//
// Design: the Pallas kernel rides the indices in as scalar prefetch and DMAs
//   one row per grid step. Hopper's TMA has no indexed-row gather, so here
//   the work is flat: one thread per 8 codes of one gathered row (24 threads
//   for a 192-code row, 36,864 at the main path, kThreads to a block), so no
//   lane idles whatever the row length. A thread loads its row's index, then
//   issues together its 8-byte code load and the row's scale and zero (the
//   lanes of one row read the same index and grid, which L1 broadcasts);
//   it widens the codes in registers and writes two float4 to 32 contiguous
//   bytes, neighbouring lanes to neighbouring bytes, so every store fills
//   whole sectors. The thread index is split into (row, piece) with a
//   FastDiv. (A warp per row of 16-byte loads would keep 12 of 32 lanes
//   busy on a 192-code row, each store half-filling its sectors.) The
//   dequant is spelled __fmul_rn/__fadd_rn so that nvcc cannot contract
//   it into an FMA: the result equals the plain version
//   `codes.float() * scale + zero` bit for bit. Rows whose length is not a
//   multiple of 8 (or buffers not 8-byte aligned) take one code per thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dequant(int8_t c, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), s), z);
}

// Thread g dequantizes codes [W g, W g + W) of the flat (m, rowlen) output:
// piece g % pieces of gathered row g / pieces (pieces = rowlen / W).
template <int W>
__global__ void __launch_bounds__(kThreads)
gather_dequant_rows_q8_kernel(const int8_t* __restrict__ codes,
                              const float* __restrict__ scale,
                              const float* __restrict__ zero,
                              const int32_t* __restrict__ idx,
                              float* __restrict__ out, const FastDiv pieces,
                              const uint32_t total) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const uint32_t row = quo(g, pieces);
  const uint32_t piece = g - row * pieces.d;
  const int64_t src = idx[row];
  const int8_t* in = codes + src * pieces.d * W + piece * W;
  float* dst = out + static_cast<int64_t>(g) * W;
  if constexpr (W == 8) {
    const int2 raw = __ldg(reinterpret_cast<const int2*>(in));
    const float s = __ldg(scale + src);
    const float z = __ldg(zero + src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
    float4* o = reinterpret_cast<float4*>(dst);
    o[0] = make_float4(dequant(c[0], s, z), dequant(c[1], s, z),
                       dequant(c[2], s, z), dequant(c[3], s, z));
    o[1] = make_float4(dequant(c[4], s, z), dequant(c[5], s, z),
                       dequant(c[6], s, z), dequant(c[7], s, z));
  } else {
    *dst = dequant(__ldg(in), __ldg(scale + src), __ldg(zero + src));
  }
}

template <int W>
int launch_gather(const void* codes, const void* scale, const void* zero,
                  const void* idx, void* out, int64_t m, int64_t rowlen,
                  cudaStream_t stream) {
  const int64_t total = m * (rowlen / W);
  if (total >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  gather_dequant_rows_q8_kernel<W>
      <<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(static_cast<const int8_t*>(codes),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(zero),
                   static_cast<const int32_t*>(idx), static_cast<float*>(out),
                   fast_div(static_cast<uint32_t>(rowlen / W)),
                   static_cast<uint32_t>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: rowlen % 8 == 0 and codes 8-byte aligned (out is fresh, so aligned)
extern "C" int gather_dequant_rows_q8(const void* codes, const void* scale,
                                      const void* zero, const void* idx,
                                      void* out, int64_t m, int64_t rowlen,
                                      int64_t vec, void* stream) {
  if (m <= 0 || rowlen <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_gather<8>(codes, scale, zero, idx, out, m, rowlen, s);
  return launch_gather<1>(codes, scale, zero, idx, out, m, rowlen, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
