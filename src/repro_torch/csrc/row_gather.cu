// K1: gather rows of an int8 row-quantized table and dequantize them.
//
// Replaces: src/repro/kernels/row_gather/row_gather.py:gather_dequant_rows_q8
//   (Pallas body _gather_dequant_kernel):
//   out[i, :] = codes[idx[i], :] * scale[idx[i]] + zero[idx[i]].
//
// What bounds it on the H100: bytes. A gathered row reads its L int8 codes,
//   two f32 grid scalars and one int32 index and writes 4L bytes of f32; at
//   the default width (F=24, K=8, L=192) that is 204 B in and 768 B out for
//   2 flops per element, far under the card's ops:byte balance.
//
// Design: the Pallas kernel rides the indices in as scalar prefetch and DMAs
//   one row per grid step. Hopper's TMA has no indexed-row gather, so here a
//   warp owns one gathered row: every lane reads the row's index and grid
//   (one broadcast transaction each), lanes read the codes as 16-byte vectors
//   (12 lanes for a 192-byte row), widen them in registers and write float4s,
//   so each row is one coalesced read and one coalesced write. Warps stride
//   over rows. The dequant is spelled __fmul_rn/__fadd_rn so that nvcc cannot
//   contract it into an FMA: the result equals the plain version
//   `codes.float() * scale + zero` bit for bit. Rows whose length is not a
//   multiple of 16 bytes (or unaligned buffers) take a byte-wise loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float dequant(int8_t c, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), s), z);
}

template <bool VEC>
__global__ void gather_dequant_rows_q8_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ scale,
    const float* __restrict__ zero, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t m, int64_t rowlen) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       row < m; row += stride) {
    const int64_t src = idx[row];
    const float s = scale[src];
    const float z = zero[src];
    const int8_t* in = codes + src * rowlen;
    float* dst = out + row * rowlen;
    if (VEC) {
      const int64_t nvec = rowlen >> 4;
      for (int64_t c = lane; c < nvec; c += 32) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(in) + c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        float4* o = reinterpret_cast<float4*>(dst) + c * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = make_float4(dequant(b[4 * q + 0], s, z),
                             dequant(b[4 * q + 1], s, z),
                             dequant(b[4 * q + 2], s, z),
                             dequant(b[4 * q + 3], s, z));
        }
      }
    } else {
      for (int64_t c = lane; c < rowlen; c += 32) dst[c] = dequant(in[c], s, z);
    }
  }
}

}  // namespace

extern "C" int gather_dequant_rows_q8(const void* codes, const void* scale,
                                      const void* zero, const void* idx,
                                      void* out, int64_t m, int64_t rowlen,
                                      int64_t vec, void* stream) {
  if (m <= 0) return 0;
  int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* s = static_cast<const float*>(scale);
  const auto* z = static_cast<const float*>(zero);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  if (vec) {
    gather_dequant_rows_q8_kernel<true><<<grid, block, 0, st>>>(c, s, z, i, o, m, rowlen);
  } else {
    gather_dequant_rows_q8_kernel<false><<<grid, block, 0, st>>>(c, s, z, i, o, m, rowlen);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
