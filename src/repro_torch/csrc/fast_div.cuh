// Division by a runtime divisor with a multiply and a shift, for kernels
// that split a flat thread index by runtime extents (K1, K2/K3, K4,
// K5/K6). The divisor's magic number is found once on the host; on the
// device the quotient costs one __umulhi and one shift instead of a
// ~20-instruction integer division, on the chain each thread walks before
// its first load.
// Exact for n < 2^31 (the callers keep their flat indices below that).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int l = 0;
    while ((1u << l) < d) ++l;  // ceil(log2 d)
    const int p = 31 + l;
    f.mul = static_cast<uint32_t>(((1ull << p) + d - 1) / d);
    f.shr = static_cast<uint32_t>(p - 32);
  }
  return f;
}

__device__ __forceinline__ uint32_t quo(uint32_t n, FastDiv f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

}  // namespace
