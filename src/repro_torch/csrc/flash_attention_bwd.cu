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
//   masked), Delta = rowsum(dO o O), dV = P^T dO, dS = P o (dP - Delta) with
//   dP = dO V^T, dQ = dS K D^-1/2, dK = dS^T Q D^-1/2; dK and dV summed over
//   the G query heads of each kv head. K13 writes Delta, (B, H, Sq) f32, for
//   K12, which runs after it on the stream.
//
// What bounds them on the H100: 2 (3 D + 2 Dv) operations per (row, column)
//   pair the mask keeps (S, dP, dV, dQ, dK; K13 recomputes S and dP, so the
//   two kernels do 2 (4 D + 3 Dv) between them), against the bytes of q, k,
//   v, O, dO, lse read once and dq, dk, dv written once. At llama3.2-1b's
//   train step (B = 4, S = 1024, H = 32, Kv = 8, D = 64, bf16, causal) K13
//   needs 25.8 GFLOP (26.1 us at the 989 TFLOP/s bf16 tensor peak) and K12
//   34.4 GFLOP (34.8 us), against about 50 MB each, 15 us at 3.35 TB/s:
//   operations bound them, and only the tensor cores come near that bound.
//
// Two bodies per kernel, chosen by dtype in the C entries at the end, each
// instantiated per (qk head dim D, v head dim Dv) of K11's pairs:
//   - bf16: flash_attention_bwd_dq_kernel_wgmma (K13) and
//     flash_attention_bwd_dkdv_kernel_wgmma (K12), TMA, mbarriers, wgmma and
//     setmaxnreg (sm_90a; the building blocks in hopper.cuh, as K11's).
//   - f32: flash_attention_bwd_dq_kernel and flash_attention_bwd_dkdv_kernel,
//     CUDA-core f32 FMAs and expf, held to 1e-4 of max |g|, which a TF32
//     wgmma cannot meet; they serve the f32 oracle and sweeps.
//
// The bf16 bodies (K11's shape: a CTA of two consumer warpgroups of 64 rows
// and one producer warpgroup whose one thread issues every TMA load; the
// producer lowers its registers with setmaxnreg, the consumers raise
// theirs):
//   - K13, one CTA per (b, h, 128-row q tile), items numbered longest first
//     (q tiles from the last one down, (b, h) fastest). Q and dO are loaded
//     once; K and V tiles of 64 keys stream through a ring of 3 stages (a
//     full and an empty mbarrier each) over K11's live tiles. Each consumer
//     first forms Delta of its rows from O and dO in device memory (the 4
//     threads of a quad split a row's columns, 2 shuffles) and writes it.
//     Per tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands
//     K-major in shared memory), then dS = P o (dP - Delta) on the
//     accumulator fragment with P = 2^(S D^-1/2 log2 e - lse log2 e), then
//     dQ += dS K (dS rounded to bf16 in registers as the A operand, K read
//     MN-major: the transpose bit, as K11's PV reads V). The dQ product is
//     issued alone after dS: issued with the next tile's S and dP, it made
//     ptxas serialize every wgmma and spill from (112, 112) up.
//   - K12, one CTA per (b, kv head, 64-key tile), items numbered longest
//     first under the causal mask (key tiles from the first one up, (b, kv
//     head) fastest). K and V are loaded once; Q and dO tiles of 64 rows
//     stream through a 3-stage ring, over the G query heads in order and,
//     for each, the q tiles that can see the CTA's keys (from row k0 under
//     the causal mask; up to row k0 + 63 + window - 1 under a window): K11's
//     forward with the roles of Q and K swapped. Both consumer warpgroups
//     cover the CTA's 64 keys and split the work, so each holds one
//     persistent accumulator: warpgroup 0 forms S^T = K Q^T (m64n64k16,
//     K-major), P^T on the fragment (each column is a q row; its lse sits in
//     shared memory, staged by the warpgroup's own threads into two
//     alternating buffers behind a named barrier), rounds it to bf16, hands
//     it to warpgroup 1 through shared memory (two buffers, each thread's 16
//     packed pairs, behind full / empty mbarriers) and runs dV += P^T dO (P^T
//     from registers, dO MN-major); warpgroup 1 forms dP^T = V dO^T, dS^T =
//     P^T o (dP^T - Delta) from the handed P^T, rounds it and runs dK +=
//     dS^T Q (Q MN-major). With dK and dV in one warpgroup (224
//     accumulators a thread at (192, 128)) ptxas serialized every wgmma and
//     spilled from (112, 112) up.
//   - Q / K and V / dO each have their own shared layout (Layout<W>, W = D
//     or Dv, as K11's): widths 112 and 48 are held as whole 64-column boxes,
//     TMA's out-of-bounds fill zeroing the rest (nothing is padded in device
//     memory); S and dP take W / 16 k16 steps and never read the zeros; dQ
//     and dK at D = 112 run n128 over them and store D columns. Rows past Sq
//     or Sk are zero-filled by TMA and masked. v and dO are taken at their
//     own width, never padded.
//   - The wgmma groups of each loop are straight-line code, as in K11.
//
// Numerics of the bf16 bodies: P and dS are rounded to bf16 before their
//   products (K12's dS^T from the rounded P^T), every product and sum is
//   f32, gradients are rounded to bf16 once; 2^x is ex2.approx (about 2
//   ulp) with log2(e) folded into the scale and the lse. chip_smoke.py
//   holds them to 2u (A + |g_plain|) + 1e-4 max |g_plain| per element, A
//   the same products on absolute values (ref.flash_attention_bwd_abs_ref).
//
// Both bodies: no atomics. Each output element has one writer and every sum
// runs in a fixed order, so two calls give the same bits; GQA's sum over
// heads happens inside K12's CTA.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 bodies: TMA, mbarriers and wgmma (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kWgmmaThreads = 3 * kWgThreads;  // 2 consumers + 1 producer
constexpr int kConsumerWarps = 8;
// K13's q rows per CTA, 64 per consumer warpgroup; and the 64 rows of every
// streamed tile (K13: keys; K12: q rows, and K12's keys per CTA), the N of
// the S and dP products and the k extent of the dQ / dK / dV products
constexpr int kCtaRows = 128;
constexpr int kTileRows = 64;

// K13's shared memory: Q and dO (128 rows each), per stage a 64-key K and V
// tile, the barriers (Q full, per stage full, per stage empty), 1024 B of
// slack to align; 3 stages fit at every pair (205,880 B at (192, 128))
template <int D, int Dv>
struct DqTile {
  using QK = Layout<D>;
  using V = Layout<Dv>;
  static constexpr int kQBytes = kCtaRows * QK::kDP * 2;
  static constexpr int kDoBytes = kCtaRows * V::kDP * 2;
  static constexpr int kKBytes = kTileRows * QK::kDP * 2;
  static constexpr int kStageBytes = kKBytes + kTileRows * V::kDP * 2;
  static constexpr int kFixed = kQBytes + kDoBytes;
  static constexpr int kStages = 3;
  static constexpr int kBarOffset = kFixed + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmemBytes <= kSmemMax, "K13's tiles exceed shared memory");
};

// K12's: K and V (64 keys each), per stage a 64-row Q and dO tile, two
// buffers of P^T handed from warpgroup 0 to warpgroup 1 (each thread's 16
// packed pairs, thread-fastest), per consumer warpgroup two buffers of the
// tile rows' lse (warpgroup 0) or Delta (warpgroup 1), the barriers (K / V
// full, per stage full and empty, per P^T buffer full and empty), 1024 B of
// slack; 3 stages fit at every pair (182,360 B at (192, 128))
template <int D, int Dv>
struct DkdvTile {
  using QK = Layout<D>;
  using V = Layout<Dv>;
  static constexpr int kKBytes = kTileRows * QK::kDP * 2;
  static constexpr int kVBytes = kTileRows * V::kDP * 2;
  static constexpr int kQBytes = kTileRows * QK::kDP * 2;
  static constexpr int kStageBytes = kQBytes + kTileRows * V::kDP * 2;
  static constexpr int kFixed = kKBytes + kVBytes;
  static constexpr int kStages = 3;
  static constexpr int kPOffset = kFixed + kStages * kStageBytes;
  static constexpr int kPWords = kTileRows / 4 * kWgThreads;  // one buffer
  static constexpr int kStatOffset = kPOffset + 2 * kPWords * 4;
  static constexpr int kBarOffset = kStatOffset + 2 * 2 * kTileRows * 4;
  static constexpr int kSmemBytes =
      kBarOffset + (1 + 2 * kStages + 4) * 8 + 1024;
  static_assert(kSmemBytes <= kSmemMax, "K12's tiles exceed shared memory");
};

// the pair (row, col) the mask keeps (K11's: causal aligned at position 0);
// I is int in the bf16 bodies, int64_t in the f32 ones
template <typename I>
__device__ __forceinline__ bool live(I row, I col, I Sq, I Sk, int causal,
                                     I window) {
  return row < Sq && col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// d = A B^T (64 x kTileRows) over W columns as one wgmma group, both
// operands K-major: A's 64 rows start at `a` in a tile whose boxes hold
// ARows rows, B is a kTileRows-row tile. W / 16 k16 steps, so the
// zero-filled columns of W = 48 and 112 are never read; each step's
// descriptors are the two base ones advanced inside its instruction (KK a
// constant: no per-step descriptor is held in registers), and the first
// step overwrites d (nothing of d lives across the loop)
template <int W, int ARows, int... KK>
__device__ __forceinline__ void ss_steps(float (&d)[kTileRows / 2],
                                         uint64_t a, uint64_t b,
                                         std::integer_sequence<int, KK...>) {
  using L = Layout<W>;
  (Wgmma<kTileRows>::ss_at<
       (KK * 16 / L::kBox) * ARows * L::kRowBytes + (KK * 16 % L::kBox) * 2,
       (KK * 16 / L::kBox) * kTileRows * L::kRowBytes +
           (KK * 16 % L::kBox) * 2,
       (KK > 0)>(d, a, b),
   ...);
}

template <int W, int ARows>
__device__ __forceinline__ void issue_ss(float (&d)[kTileRows / 2], uint32_t a,
                                         uint32_t b) {
  using L = Layout<W>;
  ss_steps<W, ARows>(d, gmma_desc(a, 16, L::kSbo, L::kLayout),
                     gmma_desc(b, 16, L::kSbo, L::kLayout),
                     std::make_integer_sequence<int, W / 16>{});
  wgmma_commit();
}

// d += A B as one wgmma group: A (64 x kTileRows) in registers, bf16 packed
// from an accumulator fragment (registers 8kk .. 8kk + 7 of the fragment
// are the A fragment of the k16 step over its columns 16kk .. 16kk + 15); B
// the kTileRows-row tile at b read MN-major (a k16 step is 16 rows down;
// boxes lie kTileRows rows apart). The product is Layout<W>::kDP wide
template <int W, int... KK>
__device__ __forceinline__ void rs_steps(float (&d)[Layout<W>::kDP / 2],
                                         const uint32_t (&a)[kTileRows / 4],
                                         uint64_t b,
                                         std::integer_sequence<int, KK...>) {
  using L = Layout<W>;
  (Wgmma<L::kDP>::template rs_at<KK * 16 * L::kRowBytes>(d, &a[4 * KK], b),
   ...);
}

template <int W>
__device__ __forceinline__ void issue_rs(float (&d)[Layout<W>::kDP / 2],
                                         const uint32_t (&a)[kTileRows / 4],
                                         uint32_t b) {
  using L = Layout<W>;
  rs_steps<W>(d, a,
              gmma_desc(b, kTileRows * L::kRowBytes, L::kSbo, L::kLayout),
              std::make_integer_sequence<int, kTileRows / 16>{});
  wgmma_commit();
}

// the two bf16 halves of a packed pair, as f32
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// one arrival per consumer warp
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// named barriers 1 and 2: the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// bf16 pairs of an f32 accumulator fragment, in register order
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[kTileRows / 4],
                                              const float (&d)[kTileRows / 2]) {
#pragma unroll
  for (int j = 0; j < kTileRows / 4; ++j)
    a[j] = pack_bf16(d[2 * j], d[2 * j + 1]);
}

template <int D, int Dv>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_bwd_dq_kernel_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ delta, int Sq, int Sk, int B, int H, int Kv,
    int causal, int window, float scale, float scale_log2) {
  using T = DqTile<D, Dv>;
  using QK = typename T::QK;
  using V = typename T::V;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem_q = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t smem_do = smem_q + T::kQBytes;
  const uint32_t bar_q = smem_q + T::kBarOffset;
  auto smem_k = [&](int s) { return smem_q + T::kFixed + s * T::kStageBytes; };
  auto smem_v = [&](int s) { return smem_k(s) + T::kKBytes; };
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  // the item and its live 64-key tiles [t0, t1): K11's block predicate over
  // rows q0 .. q0 + 127 (dead tiles form a prefix and a suffix)
  const int BH = B * H, item = static_cast<int>(blockIdx.x);
  const int q0 = ((Sq + kCtaRows - 1) / kCtaRows - 1 - item / BH) * kCtaRows;
  const int b = item % BH / H, h = item % BH % H, kvh = h / (H / Kv);
  int t1 = (Sk + kTileRows - 1) / kTileRows;
  if (causal) t1 = min(t1, (q0 + kCtaRows - 1) / kTileRows + 1);
  // live: k0 + kTileRows - 1 > q0 - window
  const int64_t first = static_cast<int64_t>(q0) - window - kTileRows + 1;
  const int t0 =
      (window > 0 && first >= 0) ? static_cast<int>(first / kTileRows) + 1 : 0;
  const int n_tiles = max(t1 - t0, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(bar_q, T::kQBytes + T::kDoBytes);
      for (int c = 0; c < QK::kBoxes; ++c)
        tma_load(smem_q + c * kCtaRows * QK::kRowBytes, &map_q, bar_q,
                 c * QK::kBox, h, q0, b);
      for (int c = 0; c < V::kBoxes; ++c)
        tma_load(smem_do + c * kCtaRows * V::kRowBytes, &map_do, bar_q,
                 c * V::kBox, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (t0 + i) * kTileRows;
        mbar_wait(bar_empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), T::kStageBytes);
        for (int c = 0; c < QK::kBoxes; ++c)
          tma_load(smem_k(s) + c * kTileRows * QK::kRowBytes, &map_k,
                   bar_full(s), c * QK::kBox, kvh, k0, b);
        for (int c = 0; c < V::kBoxes; ++c)
          tma_load(smem_v(s) + c * kTileRows * V::kRowBytes, &map_v,
                   bar_full(s), c * V::kBox, kvh, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; a thread holds
  // rows row0 and row0 + 8 of each fragment
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x % kWgThreads) / 32, lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);  // column of register 0 in an n8 block
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int rmin = q0 + wg * 64, rmax = rmin + 63;
  const uint32_t q_rows = smem_q + wg * 64 * QK::kRowBytes;
  const uint32_t do_rows = smem_do + wg * 64 * V::kRowBytes;

  // Delta of the thread's two rows (the quad's 4 threads take columns
  // 8 jb + col0 and + 1, then two shuffles) and lse in the log2 domain
  float dl[2], ll[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + row;
    float part = 0.0f;
    if (row < Sq) {
      const int64_t base =
          ((static_cast<int64_t>(b) * Sq + row) * H + h) * Dv + col0;
#pragma unroll
      for (int jb = 0; jb < Dv / 8; ++jb) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + base + 8 * jb));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + 8 * jb));
        part = fmaf(g.x, x.x, part);
        part = fmaf(g.y, x.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[half] = part;
    ll[half] = row < Sq ? lse[at] * kLog2e : 0.0f;
    if (lane % 4 == 0 && row < Sq) delta[at] = part;
  }

  float s[kTileRows / 2], dp[kTileRows / 2], acc[QK::kDP / 2];
  uint32_t ds[kTileRows / 4];
#pragma unroll
  for (int j = 0; j < kTileRows / 2; ++j) s[j] = dp[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < QK::kDP / 2; ++j) acc[j] = 0.0f;

  // per tile, S and dP as one batch, then dS, then the dQ product alone:
  // ptxas keeps these groups asynchronous (issued with the next tile's S and
  // dP, the dQ product made it serialize every wgmma and spill at D >= 112)
  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(bar_full(st), (i / kStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<D, kCtaRows>(s, q_rows, smem_k(st));     // S
    issue_ss<Dv, kCtaRows>(dp, do_rows, smem_v(st));  // dP
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // dS = P o (dP - Delta) in place in dp; a tile inside every bound of
    // the warpgroup's rows skips the mask
    const int k0 = (t0 + i) * kTileRows;
    const bool masked = k0 + kTileRows > Sk ||
                        (causal && k0 + kTileRows - 1 > rmin) ||
                        (window > 0 && k0 <= rmax - window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < kTileRows / 2; ++j) {
        const int r = (j >> 1) & 1;
        const int col = k0 + 8 * (j >> 2) + col0 + (j & 1);
        const float e = ex2(s[j] * scale_log2 - ll[r]);  // then a select
        const float p =
            live(row0 + 8 * r, col, Sq, Sk, causal, window) ? e : 0.0f;
        dp[j] = p * (dp[j] - dl[r]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTileRows / 2; ++j) {
        const int r = (j >> 1) & 1;
        dp[j] = ex2(s[j] * scale_log2 - ll[r]) * (dp[j] - dl[r]);
      }
    }
    pack_fragment(ds, dp);
    fence_regs(acc);
    wgmma_fence();
    issue_rs<D>(acc, ds, smem_k(st));  // dQ += dS K
    wgmma_wait<0>();
    fence_regs(acc);
    release(bar_empty(st), lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    __nv_bfloat16* dst =
        dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D + col0;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)  // the D real columns only
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
          __floats2bfloat162_rn(acc[4 * jb + 2 * half] * scale,
                                acc[4 * jb + 2 * half + 1] * scale);
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_bwd_dkdv_kernel_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int B, int H, int Kv, int causal, int window, float scale,
    float scale_log2) {
  using T = DkdvTile<D, Dv>;
  using QK = typename T::QK;
  using V = typename T::V;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t smem_k = (raw + 1023u) & ~1023u;
  const uint32_t smem_v = smem_k + T::kKBytes;
  const uint32_t bar_kv = smem_k + T::kBarOffset;
  auto smem_q = [&](int s) { return smem_k + T::kFixed + s * T::kStageBytes; };
  auto smem_do = [&](int s) { return smem_q(s) + T::kQBytes; };
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };
  auto bar_p_full = [&](int u) { return bar_kv + 8 * (1 + 2 * kStages + u); };
  auto bar_p_empty = [&](int u) { return bar_kv + 8 * (3 + 2 * kStages + u); };
  uint8_t* const base = smem_raw + (smem_k - raw);

  // the item and the 64-row q tiles [t_lo, t_hi) whose rows can see keys
  // k0 .. k0 + 63, walked for each of the G query heads in order
  const int BKv = B * Kv, item = static_cast<int>(blockIdx.x);
  const int k0 = item / BKv * kTileRows, b = item % BKv / Kv,
            kvh = item % BKv % Kv;
  const int G = H / Kv;
  const int nq = (Sq + kTileRows - 1) / kTileRows;
  const int t_lo = causal ? k0 / kTileRows : 0;
  int t_hi = nq;
  if (window > 0) {
    const int64_t last =
        (static_cast<int64_t>(k0) + kTileRows - 1 + window - 1) / kTileRows + 1;
    t_hi = last < nq ? static_cast<int>(last) : nq;
  }
  const int n_tiles = G * max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumerWarps);
    }
    for (int u = 0; u < 2; ++u) {  // one consumer warpgroup on each side
      mbar_init(bar_p_full(u), kConsumerWarps / 2);
      mbar_init(bar_p_empty(u), kConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(bar_kv, T::kKBytes + T::kVBytes);
      for (int c = 0; c < QK::kBoxes; ++c)
        tma_load(smem_k + c * kTileRows * QK::kRowBytes, &map_k, bar_kv,
                 c * QK::kBox, kvh, k0, b);
      for (int c = 0; c < V::kBoxes; ++c)
        tma_load(smem_v + c * kTileRows * V::kRowBytes, &map_v, bar_kv,
                 c * V::kBox, kvh, k0, b);
      for (int i = 0, h = kvh * G, t = t_lo; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), T::kStageBytes);
        for (int c = 0; c < QK::kBoxes; ++c)
          tma_load(smem_q(s) + c * kTileRows * QK::kRowBytes, &map_q,
                   bar_full(s), c * QK::kBox, h, t * kTileRows, b);
        for (int c = 0; c < V::kBoxes; ++c)
          tma_load(smem_do(s) + c * kTileRows * V::kRowBytes, &map_do,
                   bar_full(s), c * V::kBox, h, t * kTileRows, b);
        if (++t == t_hi) {
          t = t_lo;
          ++h;
        }
      }
    }
    return;
  }

  // consumers: both warpgroups cover the CTA's 64 keys (a thread holds keys
  // key0 and key0 + 8 of each fragment, whose columns are q rows).
  // Warpgroup 0 forms P^T and owns dV, warpgroup 1 forms dS^T and owns dK:
  // one persistent accumulator each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int col0 = 2 * (lane % 4);  // column of register 0 in an n8 block
  const int key0 = k0 + warp * 16 + lane / 4;
  // the warpgroup's two buffers of the tile rows' lse (log2 domain) or
  // Delta, and the P^T buffers: pair j of thread tid at j * 128 + tid
  float* const stats =
      reinterpret_cast<float*>(base + T::kStatOffset) + wg * 2 * kTileRows;
  uint32_t* const p_buf = reinterpret_cast<uint32_t*>(base + T::kPOffset);
  mbar_wait(bar_kv, 0);

  if (wg == 0) {
    float s[kTileRows / 2], gv[V::kDP / 2];
    uint32_t p[kTileRows / 4];
#pragma unroll
    for (int j = 0; j < kTileRows / 2; ++j) s[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < V::kDP / 2; ++j) gv[j] = 0.0f;
    for (int i = 0, h = kvh * G, t = t_lo; i < n_tiles; ++i) {
      const int st = i % kStages, q0 = t * kTileRows, u = i & 1;
      // the tile rows' lse, loaded before the product is waited for
      float stat = 0.0f;
      if (tid < kTileRows && q0 + tid < Sq)
        stat = lse[(static_cast<int64_t>(b) * H + h) * Sq + q0 + tid] * kLog2e;
      if (++t == t_hi) {
        t = t_lo;
        ++h;
      }
      float* const buf = stats + u * kTileRows;
      mbar_wait(bar_full(st), (i / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_ss<D, kTileRows>(s, smem_k, smem_q(st));  // S^T
      if (tid < kTileRows) buf[tid] = stat;
      warpgroup_sync(wg);  // the buffer last read two tiles ago is refilled
      wgmma_wait<0>();
      fence_regs(s);
      // P^T in s; a tile inside every bound of the keys skips the mask
      const bool masked = q0 + kTileRows > Sq || k0 + kTileRows > Sk ||
                          (causal && k0 + kTileRows - 1 > q0) ||
                          (window > 0 && k0 <= q0 + kTileRows - 1 - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < kTileRows / 2; ++j) {
          const int c = 8 * (j >> 2) + col0 + (j & 1);
          const float e = ex2(s[j] * scale_log2 - buf[c]);  // then a select
          s[j] = live(q0 + c, key0 + 8 * ((j >> 1) & 1), Sq, Sk, causal,
                      window)
                     ? e
                     : 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTileRows / 2; ++j)
          s[j] = ex2(s[j] * scale_log2 - buf[8 * (j >> 2) + col0 + (j & 1)]);
      }
      pack_fragment(p, s);
      // hand the rounded P^T to warpgroup 1
      mbar_wait(bar_p_empty(u), ((i >> 1) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kTileRows / 4; ++j)
        p_buf[(u * kTileRows / 4 + j) * kWgThreads + tid] = p[j];
      release(bar_p_full(u), lane);
      fence_regs(gv);
      wgmma_fence();
      issue_rs<Dv>(gv, p, smem_do(st));  // dV += P^T dO
      wgmma_wait<0>();
      fence_regs(gv);
      release(bar_empty(st), lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= Sk) continue;
      __nv_bfloat16* dst =
          dv + ((static_cast<int64_t>(b) * Sk + key) * Kv + kvh) * Dv + col0;
#pragma unroll
      for (int jb = 0; jb < Dv / 8; ++jb)  // the Dv real columns only
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
            __floats2bfloat162_rn(gv[4 * jb + 2 * half],
                                  gv[4 * jb + 2 * half + 1]);
    }
  } else {
    float dp[kTileRows / 2], gk[QK::kDP / 2];
    uint32_t ds[kTileRows / 4];
#pragma unroll
    for (int j = 0; j < kTileRows / 2; ++j) dp[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < QK::kDP / 2; ++j) gk[j] = 0.0f;
    for (int i = 0, h = kvh * G, t = t_lo; i < n_tiles; ++i) {
      const int st = i % kStages, q0 = t * kTileRows, u = i & 1;
      float stat = 0.0f;  // the tile rows' Delta
      if (tid < kTileRows && q0 + tid < Sq)
        stat = delta[(static_cast<int64_t>(b) * H + h) * Sq + q0 + tid];
      if (++t == t_hi) {
        t = t_lo;
        ++h;
      }
      float* const buf = stats + u * kTileRows;
      mbar_wait(bar_full(st), (i / kStages) & 1);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<Dv, kTileRows>(dp, smem_v, smem_do(st));  // dP^T
      if (tid < kTileRows) buf[tid] = stat;
      warpgroup_sync(wg);
      wgmma_wait<0>();
      fence_regs(dp);
      // dS^T = P^T o (dP^T - Delta) from warpgroup 0's rounded P^T
      mbar_wait(bar_p_full(u), (i >> 1) & 1);
#pragma unroll
      for (int j = 0; j < kTileRows / 4; ++j) {
        const uint32_t pj = p_buf[(u * kTileRows / 4 + j) * kWgThreads + tid];
        const float* d = buf + 8 * (j >> 1) + col0;
        ds[j] = pack_bf16(bf16_lo(pj) * (dp[2 * j] - d[0]),
                          bf16_hi(pj) * (dp[2 * j + 1] - d[1]));
      }
      release(bar_p_empty(u), lane);
      fence_regs(gk);
      wgmma_fence();
      issue_rs<D>(gk, ds, smem_q(st));  // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(gk);
      release(bar_empty(st), lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= Sk) continue;
      __nv_bfloat16* dst =
          dk + ((static_cast<int64_t>(b) * Sk + key) * Kv + kvh) * D + col0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb)  // the D real columns only
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
            __floats2bfloat162_rn(gk[4 * jb + 2 * half] * scale,
                                  gk[4 * jb + 2 * half + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 bodies: CUDA-core FMAs (the f32 oracle and sweeps)
// ---------------------------------------------------------------------------
//   - Both kernels: 256 threads, thread (ty, tx) = (tid / 16, tid % 16); 64
//     rows per q tile and 64 keys per k tile; tiles staged in shared memory
//     as rows of W + 4 floats (16-byte rows whose starts fall on different
//     banks), rows past Sq or Sk zero-filled and masked, nothing padded in
//     device memory. A 64 x 64 block of scores is 4 x 4 per thread (rows /
//     keys ty + 16 i, columns tx + 16 j), as in K11's f32 body. Every
//     product and sum in f32 (expf, no fast math).
//   - K13 (dQ), one CTA per (b, h, q tile): loads its Q and dO rows and
//     lse; Delta per row (its 16 lanes split the Dv columns, then an xor
//     tree), written for K12; then over the k tiles the mask leaves (the
//     forward's block predicate): S, dP = dO V^T, dS into shared memory, dQ
//     += dS K in registers (rows ty + 16 i, columns tx D/16 ..).
//   - K12 (dK, dV), one CTA per (b, kv head, k tile): K and V tiles stay in
//     shared memory, dK and dV in registers (keys ty + 16 i); it loops over
//     the G query heads of the kv head in order and, for each, over the q
//     tiles that can see its keys (under the causal mask from the tile of
//     row k0 on; under a window up to row k0 + 63 + window - 1): S^T, dP^T,
//     P^T and dS^T into shared memory, then dV += P^T dO and dK += dS^T Q.
//   - Shared memory (floats): K13 2 x 64 (D + 4) + 2 x 64 (Dv + 4) + 64 x 68
//     (dS), 185,344 B at (192, 128); K12 the same tiles plus P^T and dS^T
//     (2 x 64 x 68) and 128 floats of lse and Delta, 203,264 B at (192,
//     128) (dK and dV live in registers: 80 floats a thread at (192, 128)).

constexpr int kB = 64;         // rows per q tile, keys per k tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kB + 4;    // row stride (floats) of the P and dS tiles

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows r0 .. r0 + 63 of head `head` of a (B, S, heads, W) array into
// shared memory as rows of W + 4 floats; rows past S are zeros
template <int W>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t b, int64_t r0, int64_t S,
                                          int heads, int head) {
  for (int idx = threadIdx.x; idx < kB * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int64_t row = r0 + r;
    dst[r * (W + 4) + c] =
        row < S ? src[((b * S + row) * heads + head) * W + c] : 0.0f;
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
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ o,
                              const float* __restrict__ lse,
                              const float* __restrict__ dout,
                              float* __restrict__ dq,
                              float* __restrict__ delta, int64_t Sq, int64_t Sk,
                              int H, int Kv, int causal, int64_t window,
                              float scale) {
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
  load_tile<D>(Qs, q, b, q0, Sq, H, h);
  load_tile<Dv>(dOs, dout, b, q0, Sq, H, h);
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
                    o[((b * Sq + row) * H + h) * Dv + c], part);
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
    load_tile<D>(Ks, k, b, k0, Sk, Kv, kvh);
    load_tile<Dv>(Vs, v, b, k0, Sk, Kv, kvh);
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
    for (int c = 0; c < DC; ++c) dq[base + c] = acc[i][c] * scale;
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int64_t Sq, int64_t Sk, int H, int Kv,
                                int causal, int64_t window, float scale) {
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
  load_tile<D>(Ks, k, b, k0, Sk, Kv, kvh);
  load_tile<Dv>(Vs, v, b, k0, Sk, Kv, kvh);

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
      load_tile<D>(Qs, q, b, q0, Sq, H, h);
      load_tile<Dv>(dOs, dout, b, q0, Sq, H, h);
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
    for (int c = 0; c < DC; ++c) dk[row * D + tx * DC + c] = gk[i][c] * scale;
#pragma unroll
    for (int c = 0; c < VC; ++c) dv[row * Dv + tx * VC + c] = gv[i][c];
  }
}

// ---------------------------------------------------------------------------
// launches and the C entries
// ---------------------------------------------------------------------------

// one backward call's arguments, as the C entries take them
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int64_t B, Sq, Sk, H, Kv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D, int Dv>
cudaError_t launch_dq_wgmma(const Args& a) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!encode_map<D>(&map_q, a.q, a.B, a.Sq, a.H, kCtaRows) ||
      !encode_map<D>(&map_k, a.k, a.B, a.Sk, a.Kv, kTileRows) ||
      !encode_map<Dv>(&map_v, a.v, a.B, a.Sk, a.Kv, kTileRows) ||
      !encode_map<Dv>(&map_do, a.dout, a.B, a.Sq, a.H, kCtaRows))
    return cudaErrorInvalidValue;
  auto* kernel = flash_attention_bwd_dq_kernel_wgmma<D, Dv>;
  const int smem = DqTile<D, Dv>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t items = (a.Sq + kCtaRows - 1) / kCtaRows * a.B * a.H;
  kernel<<<static_cast<unsigned>(items), kWgmmaThreads, smem, a.stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      static_cast<__nv_bfloat16*>(a.dq), a.delta, static_cast<int>(a.Sq),
      static_cast<int>(a.Sk), static_cast<int>(a.B), static_cast<int>(a.H),
      static_cast<int>(a.Kv), a.causal != 0, static_cast<int>(a.window),
      a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int Dv>
cudaError_t launch_dkdv_wgmma(const Args& a) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!encode_map<D>(&map_q, a.q, a.B, a.Sq, a.H, kTileRows) ||
      !encode_map<D>(&map_k, a.k, a.B, a.Sk, a.Kv, kTileRows) ||
      !encode_map<Dv>(&map_v, a.v, a.B, a.Sk, a.Kv, kTileRows) ||
      !encode_map<Dv>(&map_do, a.dout, a.B, a.Sq, a.H, kTileRows))
    return cudaErrorInvalidValue;
  auto* kernel = flash_attention_bwd_dkdv_kernel_wgmma<D, Dv>;
  const int smem = DkdvTile<D, Dv>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t items = (a.Sk + kTileRows - 1) / kTileRows * a.B * a.Kv;
  kernel<<<static_cast<unsigned>(items), kWgmmaThreads, smem, a.stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      static_cast<int>(a.Sq), static_cast<int>(a.Sk), static_cast<int>(a.B),
      static_cast<int>(a.H), static_cast<int>(a.Kv), a.causal != 0,
      static_cast<int>(a.window), a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

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
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o), a.lse,
      static_cast<const float*>(a.dout), static_cast<float*>(a.dq), a.delta,
      a.Sq, a.Sk, static_cast<int>(a.H), static_cast<int>(a.Kv),
      a.causal != 0, a.window, a.scale);
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
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Sk, static_cast<int>(a.H), static_cast<int>(a.Kv),
      a.causal != 0, a.window, a.scale);
  return cudaGetLastError();
}

// (D, Dv) as one case label of the dispatch's switch
constexpr int64_t pair(int64_t d, int64_t dv) { return d << 16 | dv; }

// the (D, Dv) pairs of K11 (ops.HEAD_DIMS), each with a bf16 (wgmma) and an
// f32 (CUDA-core) instance of both kernels: DQ_CASE / DKDV_CASE below expand
// one case label per pair, the bf16 flag picking the body
#define REPRO_FLASH_BWD_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(48, 32) X(192, 128)

cudaError_t dispatch_dq(const Args& a, int64_t D, int64_t Dv, bool bf16) {
  switch (pair(D, Dv)) {
#define DQ_CASE(d, dv) \
  case pair(d, dv):    \
    return bf16 ? launch_dq_wgmma<d, dv>(a) : launch_dq<d, dv>(a);
    REPRO_FLASH_BWD_PAIRS(DQ_CASE)
#undef DQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkdv(const Args& a, int64_t D, int64_t Dv, bool bf16) {
  switch (pair(D, Dv)) {
#define DKDV_CASE(d, dv) \
  case pair(d, dv):      \
    return bf16 ? launch_dkdv_wgmma<d, dv>(a) : launch_dkdv<d, dv>(a);
    REPRO_FLASH_BWD_PAIRS(DKDV_CASE)
#undef DKDV_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// the sizes one call may take; the bf16 bodies also need one CTA per item
// (`rows` rows a CTA: Sq in K13's 128-row q tiles, Sk in K12's 64-key
// tiles; heads H or Kv) and their TMA operands on 16-byte boundaries
bool valid(int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Kv,
           int64_t D, int64_t Dv, int64_t window, int64_t bf16, int64_t rows,
           int64_t cta_rows, int64_t heads, const void* const* tma,
           int n_tma) {
  constexpr int64_t kMax = 0x7fffffff;
  if (!(B > 0 && Sq > 0 && Sk > 0 && H > 0 && Kv > 0 && H % Kv == 0 &&
        window >= 0 && window <= kMax && Sq <= kMax && Sk <= kMax &&
        B <= 65535 && H <= 65535 && D > 0 && Dv > 0))
    return false;
  if (!bf16) return true;
  if ((rows + cta_rows - 1) / cta_rows * B * heads > kMax) return false;
  for (int i = 0; i < n_tma; ++i)
    if (reinterpret_cast<uintptr_t>(tma[i]) % 16 != 0) return false;
  return true;
}

}  // namespace

// K13. q: (B, Sq, H, D), k: (B, Sk, Kv, D), v: (B, Sk, Kv, Dv), o and dout:
// (B, Sq, H, Dv), dq: (B, Sq, H, D), all contiguous and of one dtype (f32,
// or bf16 when bf16 != 0); lse (K11's, natural log) and delta (written
// here): (B, H, Sq) f32; (D, Dv) one of K11's pairs; window 0 = no window;
// scale = D^-1/2 rounded to f32. bf16 takes the wgmma body and needs q, k,
// v and dout on 16-byte boundaries (TMA); f32 the CUDA-core body.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* dq, void* delta, int64_t B,
                                      int64_t Sq, int64_t Sk, int64_t H,
                                      int64_t Kv, int64_t D, int64_t Dv,
                                      int64_t causal, int64_t window,
                                      int64_t bf16, float scale, void* stream) {
  const void* const tma[4] = {q, k, v, dout};
  if (!valid(B, Sq, Sk, H, Kv, D, Dv, window, bf16, Sq, kCtaRows, H, tma, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, nullptr, nullptr, B, Sq, Sk, H,
               Kv, causal, window, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dq(a, D, Dv, bf16 != 0));
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
  const void* const tma[4] = {q, k, v, dout};
  if (!valid(B, Sq, Sk, H, Kv, D, Dv, window, bf16, Sk, kTileRows, Kv, tma,
             4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr,
               dk, dv, B, Sq, Sk, H, Kv, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dkdv(a, D, Dv, bf16 != 0));
}
