// K7-K9: the paper's 16-bit wire quantization (§6) over the flat weight space.
//
// Replaces: src/repro/kernels/quantize/quantize.py
//   K7 minmax            (_minmax_kernel):   (min(w), max(w)) of a flat f32 array;
//   K8 quantize_pallas   (_quant_kernel):    clip(round((w - w_min) / bucket), 0, 65535);
//   K9 dequantize_pallas (_dequant_kernel):  w_min + float(q) * bucket.
//
// What bounds them on the H100: bytes. Each is one streaming pass with a few
//   flops per element: K7 reads 4 B per weight, K8 reads 4 and writes 2, K9
//   reads 2 and writes 4. At the default config (n ~ 50.6 M weights) that is
//   202 / 303 / 303 MB, 60 / 91 / 91 us at 3.35 TB/s.
//
// Design: grid-stride loops over 16-byte float4 loads (K9: 8-byte code loads)
//   with a scalar loop for the tail and for buffers the wrapper found
//   unaligned; the length arrives as an argument, nothing is padded (the Pallas
//   wrapper pads to its block).
//   - K7: the TPU grid carries (min, max) from step to step in one output
//     block; blocks here run in no order, so each block reduces its share and
//     writes a partial, and the last block to finish (a ticket counter, after
//     a __threadfence) reduces the partials and writes the result: one launch.
//     The reduction runs on an order-preserving unsigned encoding of the
//     floats, so min and max are exact and independent of the order (-0.0
//     orders below +0.0). NaN propagates as jnp.min / jnp.max do: a NaN maps
//     to the smallest key for the min and the largest for the max, and both
//     keys decode to NaN.
//   - K8: codes must equal the JAX package's _quantize_core (and so the
//     numpy-free frames of both packages) bit for bit: __fsub_rn then an IEEE
//     __fdiv_rn (no reciprocal), rintf (half to even, as jnp.round), clip to
//     [0, 65535]. Codes are stored as 16 bits, half the bytes of the Pallas
//     kernel's int32 output and of the copy to the host.
//   - K9: __fadd_rn(w_min, __fmul_rn(q, bucket)), no FMA contraction, so the
//     floats equal the receiver's numpy decode (quantization.py:541-542) bit
//     for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void take(float x, uint32_t& kmin, uint32_t& kmax) {
  const bool nan = x != x;
  const uint32_t k = order_key(x);
  kmin = min(kmin, nan ? 0u : k);
  kmax = max(kmax, nan ? 0xffffffffu : k);
}

// block-wide (min, max) of the threads' keys; the result is valid in thread 0
__device__ __forceinline__ void block_reduce(uint32_t& kmin, uint32_t& kmax) {
  __shared__ uint32_t smin[kThreads / 32], smax[kThreads / 32];
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    smin[warp] = kmin;
    smax[warp] = kmax;
  }
  __syncthreads();
  if (warp == 0) {
    kmin = lane < kThreads / 32 ? smin[lane] : 0xffffffffu;
    kmax = lane < kThreads / 32 ? smax[lane] : 0u;
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
  }
  __syncthreads();
}

__global__ void minmax_kernel(const float* __restrict__ w, int64_t n, int vec,
                              uint32_t* __restrict__ partials,
                              unsigned int* __restrict__ ticket,
                              float* __restrict__ out) {
  uint32_t kmin = 0xffffffffu, kmax = 0u;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t nvec = n >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int64_t i = tid; i < nvec; i += stride) {
      const float4 x = __ldg(w4 + i);
      take(x.x, kmin, kmax);
      take(x.y, kmin, kmax);
      take(x.z, kmin, kmax);
      take(x.w, kmin, kmax);
    }
    tail = nvec << 2;
  }
  for (int64_t i = tail + tid; i < n; i += stride) take(__ldg(w + i), kmin, kmax);
  block_reduce(kmin, kmax);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = kmin;
    partials[2 * blockIdx.x + 1] = kmax;
    __threadfence();  // partials visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partial is visible (read past L1)
  kmin = 0xffffffffu;
  kmax = 0u;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    kmin = min(kmin, __ldcg(partials + 2 * b));
    kmax = max(kmax, __ldcg(partials + 2 * b + 1));
  }
  block_reduce(kmin, kmax);
  if (threadIdx.x == 0) {
    out[0] = key_float(kmin);
    out[1] = key_float(kmax);
  }
}

__device__ __forceinline__ uint16_t code(float x, float w_min, float bucket) {
  float q = rintf(__fdiv_rn(__fsub_rn(x, w_min), bucket));
  q = fminf(fmaxf(q, 0.0f), 65535.0f);
  return static_cast<uint16_t>(static_cast<int>(q));
}

__global__ void quantize_codes_kernel(const float* __restrict__ w, int64_t n,
                                      float w_min, float bucket, int vec,
                                      uint16_t* __restrict__ q) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t nvec = n >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    ushort4* q4 = reinterpret_cast<ushort4*>(q);
    for (int64_t i = tid; i < nvec; i += stride) {
      const float4 x = __ldg(w4 + i);
      q4[i] = make_ushort4(code(x.x, w_min, bucket), code(x.y, w_min, bucket),
                           code(x.z, w_min, bucket), code(x.w, w_min, bucket));
    }
    tail = nvec << 2;
  }
  for (int64_t i = tail + tid; i < n; i += stride) q[i] = code(__ldg(w + i), w_min, bucket);
}

__device__ __forceinline__ float decode(uint16_t c, float w_min, float bucket) {
  return __fadd_rn(w_min, __fmul_rn(static_cast<float>(c), bucket));
}

__global__ void dequantize_codes_kernel(const uint16_t* __restrict__ q, int64_t n,
                                        float w_min, float bucket, int vec,
                                        float* __restrict__ w) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t nvec = n >> 2;
    const ushort4* q4 = reinterpret_cast<const ushort4*>(q);
    float4* w4 = reinterpret_cast<float4*>(w);
    for (int64_t i = tid; i < nvec; i += stride) {
      const ushort4 c = __ldg(q4 + i);
      w4[i] = make_float4(decode(c.x, w_min, bucket), decode(c.y, w_min, bucket),
                          decode(c.z, w_min, bucket), decode(c.w, w_min, bucket));
    }
    tail = nvec << 2;
  }
  for (int64_t i = tail + tid; i < n; i += stride) w[i] = decode(__ldg(q + i), w_min, bucket);
}

unsigned grid_for(int64_t n) {
  int64_t blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// partials: 2 * 1056 (2 * kMaxBlocks) uint32 of scratch; ticket: one uint32
// that is 0 at the launch; out: two f32 (min, max)
extern "C" int minmax(const void* w, void* partials, void* ticket, void* out,
                      int64_t n, int64_t vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  minmax_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), n, static_cast<int>(vec),
      static_cast<uint32_t*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_codes(const void* w, void* q, float w_min, float bucket,
                              int64_t n, int64_t vec, void* stream) {
  if (n <= 0) return 0;
  quantize_codes_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), n, w_min, bucket, static_cast<int>(vec),
      static_cast<uint16_t*>(q));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_codes(const void* q, void* w, float w_min, float bucket,
                                int64_t n, int64_t vec, void* stream) {
  if (n <= 0) return 0;
  dequantize_codes_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), n, w_min, bucket, static_cast<int>(vec),
      static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}
