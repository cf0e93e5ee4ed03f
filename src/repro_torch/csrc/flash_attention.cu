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
//   peak against 12.5 us at 3.35 TB/s, so operations bound it, and only the
//   tensor cores (wgmma) can come near that. At deepseek-v2's MLA prefill
//   (B = 4, S = 1024, H = Kv = 128, qk / v head dims 192 / 128, causal)
//   bytes bound it: 671.1 MB, 200.3 us, against 172.0 GFLOP, 173.9 us.
//
// Two bodies, chosen by dtype in one place (the C entry at the end), each
// instantiated per (qk head dim D, v head dim Dv): D = Dv in {16, 32, 64,
// 112, 128}, and MLA's (48, 32) and (192, 128) (deepseek-v2's smoke and
// full configs; v is taken at its own width, never padded to D):
//   - bf16: flash_attention_kernel_wgmma, below. It needs sm_90a (TMA,
//     mbarriers, wgmma, setmaxnreg).
//   - f32: flash_attention_kernel, the CUDA-core body further down (f32
//     FMAs, expf, IEEE division). It is held to 2e-5, which a TF32 wgmma
//     cannot meet, and serves the f32 oracle and sweeps.
//
// The bf16 body (FlashAttention-3's shape, its intra-warpgroup overlap and
// its ping-pong between the two consumer warpgroups):
//   - Work items are (batch row b, query head h, 128-row q tile), numbered
//     longest first: (b, h) fastest, q tiles from the last one down, so the
//     diagonal's short tiles fill the tail. The grid is persistent, one CTA
//     per SM, and CTA c takes items c, c + gridDim, ...; each item's output
//     is written once: no atomics, no split of the k sweep.
//   - A CTA has three warpgroups. Warpgroups 0 and 1 are consumers and own
//     64 q rows each; warpgroup 2 is the producer, lowers its registers with
//     setmaxnreg (the consumers raise theirs), and one of its threads issues
//     every TMA load, running ahead into the next item (its Q as soon as the
//     consumers' last QK^T of this one is done, its K / V as stages free).
//   - Q is loaded once per item by TMA (a full and an empty mbarrier); K
//     and V tiles of 128 keys go through TMA into a ring of kStages stages
//     (3; 2 at (192, 128), whose 3 stages would not fit the 232,448 B a
//     block may hold), each with a K-full, a V-full and an empty mbarrier
//     (the consumers' eight warps arrive on the empty one after the PV
//     wgmma that read V has completed). The tensor maps are built per call
//     over the 4-D (B, S, heads, D or Dv) arrays as they are (row stride
//     H*D, Kv*D or Kv*Dv), so a tile never reads the next batch row and
//     TMA's out-of-bounds zero fill replaces padding; ragged columns are
//     still masked (cols < Sk).
//   - S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//     (both K-major). O += P V is wgmma m64nDk16 with P as the A operand in
//     registers, converted to bf16 in place from the S accumulator fragment
//     (the m64n16 accumulator layout of keys 16kk..16kk+15 is the k16 A
//     fragment), and V as the B operand from shared memory, MN-major
//     (transpose bit set), N = Dv's shared width. P never goes through
//     shared memory.
//   - Q / K and V each have their own shared layout (Layout<W>, W = D or
//     Dv): a width of 16 or 32 is one box whose swizzle equals a row's
//     width (32 B, 64 B); a wider one is 64-column boxes of 128 B swizzle,
//     one after the other (two at 128, three at 192). The wgmma
//     descriptors carry the same swizzle; every tile starts on a 1024 B
//     boundary.
//   - A width that is not whole boxes (D = 112, zamba2's shared block; D =
//     48, MLA's smoke qk dim) is held as the next whole box count (128,
//     64): its tensor maps keep the true columns (a box may reach past
//     them: at 48 the one 64-column box is wider than the row), so TMA's
//     out-of-bounds fill zeroes the rest of every tile in shared memory
//     (nothing is padded in device memory); QK^T takes D / 16 k16 steps
//     and never reads the zeros; PV at Dv = 112 runs n128 over them (14%
//     more PV work than an n112 product, on a layout already proven at D =
//     128), and the epilogue stores Dv columns.
//   - Each consumer issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} as two
//     wgmma groups, runs tile i's softmax while PV is still in flight, then
//     waits for PV and releases stage i - 1: the exp2 work of one tile
//     overlaps the tensor-core work of the last. The two consumers take
//     turns issuing their wgmma groups (named barriers 1 and 2), so one
//     warpgroup's softmax runs while the other's products do.
//   - The online softmax runs on the accumulator fragment: a thread holds
//     two rows, and a row's 128 scores sit in the 4 threads of a quad, so the
//     row max is two __shfl_xor_sync (offsets 1 and 2); m, l and the rescale
//     stay in registers, and l is summed per thread and reduced over the
//     quad once at the end.
//   - Numerics are _flash_kernel's: masked scores are the finite -1e30 (a
//     row whose first live tile is wholly masked gets p = 1 there, wiped out
//     by the next tile's exp(-1e30 - m) = 0); dead tiles are skipped with
//     the Pallas predicate; P is rounded to bf16 before PV while l sums the
//     unrounded f32 p; out = acc / max(l, 1e-30) in bf16. One departure,
//     allowed for bf16: 2^x (ex2.approx.ftz, about 2 ulp) with log2(e)
//     folded into the scale; the row max is kept in the log2 domain.
//   - The wgmma groups of the main loop are straight-line code: a group
//     waited for on one path and not on another makes ptxas serialize every
//     wgmma (each followed by its own wait).
//
// Both bodies optionally write each row's log-sum-exp of the masked, scaled
// scores, lse (B, H, Sq) f32 in natural-log units, for the backward (K13 and
// K12 in flash_attention_bwd.cu recompute P = exp(S D^-1/2 - lse) from it):
// m + log(max(l, 1e-30)) from the final row max m and the row sum l after
// its quad (bf16) or half-warp (f32) reduction. The bf16 body keeps m in the
// log2 domain (log2(e) folded into the scale) and converts once, at the
// write: lse = m ln 2 + log(max(l, 1e-30)). A null lse pointer writes
// nothing (serving passes null); one instance serves both.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 body: TMA, mbarriers and wgmma (sm_90a; the building blocks, shared
// with K13 / K12's bf16 bodies, are in hopper.cuh)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;      // q rows per CTA (two consumer warpgroups)
constexpr int kBN = 128;      // keys per K / V tile
constexpr int kWgmmaThreads = 3 * kWgThreads;  // 2 consumers + 1 producer
constexpr int kConsumerWarps = 8;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory of one (D, Dv) instance: Q, then per stage K and V, then
// the barriers (Q full, Q empty, then per stage K full, V full, empty);
// 1024 B of slack to align. The ring is 3 deep where that fits, else 2
// ((192, 128): 3 stages would need 296,024 B, 2 take 214,080)
template <int D, int Dv>
struct Tile {
  using QK = Layout<D>;
  using V = Layout<Dv>;
  static constexpr int kQBytes = kBM * QK::kDP * 2;
  static constexpr int kKBytes = kBN * QK::kDP * 2;
  static constexpr int kVBytes = kBN * V::kDP * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages =
      kQBytes + 3 * kStageBytes + (2 + 3 * 3) * 8 + 1024 <= kSmemMax ? 3 : 2;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOffset + (2 + 3 * kStages) * 8 + 1024;
  static_assert(kSmemBytes <= kSmemMax, "K11's tiles exceed shared memory");
};

// named barriers 1 and 2: the consumer warpgroups take turns issuing
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// one work item: a (b, h, 128-row q tile), numbered longest first ((b, h)
// fastest, q tiles from the last one down), and its live k tiles [t0, t1):
// the Pallas kernel's block_live over rows q0 .. q0 + kBM - 1 (dead tiles
// form a prefix and a suffix)
struct Work {
  int q0, b, h, t0, t1;
};

__device__ __forceinline__ Work work_item(int item, int Sq, int Sk, int H,
                                          int BH, int causal, int window) {
  Work w;
  w.q0 = ((Sq + kBM - 1) / kBM - 1 - item / BH) * kBM;
  w.b = item % BH / H;
  w.h = item % BH % H;
  w.t1 = (Sk + kBN - 1) / kBN;
  if (causal) w.t1 = min(w.t1, (w.q0 + kBM - 1) / kBN + 1);  // k0 <= q_last
  // live: k0 + kBN - 1 > q0 - window
  const int first = w.q0 - window - kBN + 1;
  w.t0 = (window > 0 && first >= 0) ? first / kBN + 1 : 0;
  return w;
}

// S = Q K^T over one warpgroup's 64 q rows, as one wgmma group (both
// operands K-major: a k16 step is 32 B along a row, within its box; D / 16
// steps, so the zero-filled columns of D = 48 and 112 are never read)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / L::kBox, off = (kk * 16 % L::kBox) * 2;
    Wgmma<kBN>::ss(s,
                   gmma_desc(q_rows + c * kBM * L::kRowBytes + off, 16,
                             L::kSbo, L::kLayout),
                   gmma_desc(k_tile + c * kBN * L::kRowBytes + off, 16,
                             L::kSbo, L::kLayout),
                   kk > 0);
  }
  wgmma_commit();
}

// O += P V as one wgmma group: P from registers, V MN-major (a k16 step is
// 16 keys down; the boxes of Dv = 112 and 128 lie kBN rows apart). The
// product is V's kDP wide: Dv = 112 runs n128 over V's zero-filled columns
template <int Dv>
__device__ __forceinline__ void issue_pv(float (&o)[Layout<Dv>::kDP / 2],
                                         const uint32_t (&p)[kBN / 4],
                                         uint32_t v_tile) {
  using L = Layout<Dv>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    Wgmma<L::kDP>::rs(o, &p[4 * kk],
                 gmma_desc(v_tile + kk * 16 * L::kRowBytes, kBN * L::kRowBytes,
                           L::kSbo, L::kLayout));
  wgmma_commit();
}

// one S tile through the online softmax on the accumulator fragment (a row
// lives in the 4 threads of a quad; a thread holds rows row0 and row0 + 8):
// scale into the log2 domain and mask (only where `masked`), update the row
// max m and the per-thread partial sums l, leave the unrounded p in s and
// the factor for O in corr
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool masked, int row0, int col0,
                                             int Sk, int causal, int window,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int row = row0 + 8 * ((j >> 1) & 1);
      const int col = col0 + 8 * (j >> 2) + (j & 1);
      const bool live = col < Sk && (!causal || col <= row) &&
                        (window <= 0 || col > row - window);
      s[j] = live ? s[j] * scale_log2 : kNegInf;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) s[j] *= scale_log2;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j)
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    s[j] = ex2(s[j] - m[(j >> 1) & 1]);
    sum[(j >> 1) & 1] += s[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int D, int Dv>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Sk, int B,
                             int H, int Kv, int causal, int window,
                             float scale_log2) {
  using T = Tile<D, Dv>;
  using QK = typename T::QK;
  using V = typename T::V;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem_q = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_q + T::kBarOffset, bar_q_empty = bar_q + 8;
  auto smem_k = [&](int s) {
    return smem_q + T::kQBytes + s * T::kStageBytes;
  };
  auto smem_v = [&](int s) { return smem_k(s) + T::kKBytes; };
  auto bar_k = [&](int s) { return bar_q + 8 * (2 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (2 + kStages + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (2 + 2 * kStages + s); };
  const int n_items = (Sq + kBM - 1) / kBM * B * H;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every CTA walks the items blockIdx.x, + gridDim.x, ...; `tile` counts
  // the K / V tiles through the ring so far, on both sides
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWgThreads) {
      int tile = 0;
      for (int item = static_cast<int>(blockIdx.x), n = 0; item < n_items;
           item += static_cast<int>(gridDim.x), ++n) {
        const Work w = work_item(item, Sq, Sk, H, B * H, causal, window);
        const int kvh = w.h / (H / Kv);
        mbar_wait(bar_q_empty, (n & 1) ^ 1);  // the last item's QKs are done
        mbar_expect_tx(bar_q, T::kQBytes);
        for (int c = 0; c < QK::kBoxes; ++c)
          tma_load(smem_q + c * kBM * QK::kRowBytes, &map_q, bar_q,
                   c * QK::kBox, w.h, w.q0, w.b);
        for (int t = w.t0; t < w.t1; ++t, ++tile) {
          const int s = tile % kStages;
          mbar_wait(bar_empty(s), ((tile / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_k(s), T::kKBytes);
          for (int c = 0; c < QK::kBoxes; ++c)
            tma_load(smem_k(s) + c * kBN * QK::kRowBytes, &map_k, bar_k(s),
                     c * QK::kBox, kvh, t * kBN, w.b);
          mbar_expect_tx(bar_v(s), T::kVBytes);
          for (int c = 0; c < V::kBoxes; ++c)
            tma_load(smem_v(s) + c * kBN * V::kRowBytes, &map_v, bar_v(s),
                     c * V::kBox, kvh, t * kBN, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 of each item.
  // Step i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} back to back, runs
  // the softmax of S_i while PV is in flight, then waits for PV, releases
  // tile i - 1's stage, rounds P_i to bf16 and rescales O
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x % kWgThreads) / 32, lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);  // column of register 0 in an n8 block
  const uint32_t q_rows = smem_q + wg * 64 * QK::kRowBytes;
  float s[kBN / 2], o[V::kDP / 2], m[2], l[2], corr[2];
  uint32_t p[kBN / 4];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) s[j] = 0.0f;
  // P in bf16, in place: registers 8kk .. 8kk + 7 of S are the A fragment of
  // the k16 step over keys 16kk .. 16kk + 15
  auto round_p = [&]() {
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };
  auto release = [&](uint32_t bar) {  // one arrival per consumer warp
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int tile = 0;
  if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  for (int item = static_cast<int>(blockIdx.x), n = 0; item < n_items;
       item += static_cast<int>(gridDim.x), ++n) {
    const Work w = work_item(item, Sq, Sk, H, B * H, causal, window);
    const int n_tiles = max(w.t1 - w.t0, 0);
    const int row0 = w.q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
    const int rmin = w.q0 + wg * 64, rmax = rmin + 63;
    // a tile inside every bound of the warpgroup's rows skips the mask
    auto masked = [&](int k0) {
      return k0 + kBN > Sk || (causal && k0 + kBN - 1 > rmin) ||
             (window > 0 && k0 <= rmax - window);
    };
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.0f;
#pragma unroll
    for (int j = 0; j < V::kDP / 2; ++j) o[j] = 0.0f;

    // straight-line wgmma groups (no group waited for on one path and not on
    // another), or ptxas serializes every wgmma
    mbar_wait(bar_q, n & 1);
    if (n_tiles > 0) {  // tile 0: S_0, its softmax and P_0 (O is still 0)
      const int k0 = w.t0 * kBN;
      mbar_wait(bar_k(tile % kStages), (tile / kStages) & 1);
      fence_regs(s);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(s, q_rows, smem_k(tile % kStages));
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, corr, masked(k0), row0, k0 + col0, Sk, causal,
                   window, scale_log2);
      round_p();
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int cur = tile + i, st = cur % kStages, prev = (cur - 1) % kStages;
      const int k0 = (w.t0 + i) * kBN;
      mbar_wait(bar_k(st), (cur / kStages) & 1);
      mbar_wait(bar_v(prev), ((cur - 1) / kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(s, q_rows, smem_k(st));  // S_i
      issue_pv<Dv>(o, p, smem_v(prev));    // O += P_{i-1} V_{i-1}
      turn_pass(wg);
      wgmma_wait<1>();                     // S_i done, PV may still run
      fence_regs(s);
      softmax_tile(s, m, l, corr, masked(k0), row0, k0 + col0, Sk, causal,
                   window, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      release(bar_empty(prev));
      round_p();
#pragma unroll
      for (int j = 0; j < V::kDP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    }
    release(bar_q_empty);  // every QK of the item is done: the next Q may load
    if (n_tiles > 0) {     // the last tile's PV
      const int last = tile + n_tiles - 1;
      mbar_wait(bar_v(last % kStages), (last / kStages) & 1);
      fence_regs(o);
      turn_wait(wg);
      wgmma_fence();
      issue_pv<Dv>(o, p, smem_v(last % kStages));
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      release(bar_empty(last % kStages));
    }
    tile += n_tiles;

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
    if (lse != nullptr && lane % 4 == 0) {  // one thread of the quad per row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < Sq)
          lse[(static_cast<int64_t>(w.b) * H + w.h) * Sq + row] =
              m[half] * kLn2 + logf(den[half]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= Sq) continue;
      __nv_bfloat16* dst =
          out + ((static_cast<int64_t>(w.b) * Sq + row) * H + w.h) * Dv + col0;
#pragma unroll
      for (int jb = 0; jb < Dv / 8; ++jb)  // the Dv real columns only
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
            __floats2bfloat162_rn(o[4 * jb + 2 * half] / den[half],
                                  o[4 * jb + 2 * half + 1] / den[half]);
    }
  }
}

template <int D, int Dv>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         void* lse, int64_t B, int64_t Sq, int64_t Sk,
                         int64_t H, int64_t Kv, int64_t causal, int64_t window,
                         float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!encode_map<D>(&map_q, q, B, Sq, H, kBM) ||
      !encode_map<D>(&map_k, k, B, Sk, Kv, kBN) ||
      !encode_map<Dv>(&map_v, v, B, Sk, Kv, kBN))
    return cudaErrorInvalidValue;
  auto* kernel = flash_attention_kernel_wgmma<D, Dv>;
  const int smem = Tile<D, Dv>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one CTA per SM (or per item, if fewer)
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  const int64_t items = (Sq + kBM - 1) / kBM * B * H;
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  kernel<<<blocks, kWgmmaThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<int>(Sq), static_cast<int>(Sk),
      static_cast<int>(B), static_cast<int>(H), static_cast<int>(Kv),
      causal != 0,
      static_cast<int>(window), scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 body: CUDA-core FMAs (the f32 oracle and sweeps)
// ---------------------------------------------------------------------------
//   - One CTA of 256 threads owns a (b, h, 64-row q tile) and loops over
//     64-column k tiles, skipping dead ones with the Pallas predicate.
//   - Tiles are staged in shared memory; rows past Sq or Sk are zero-filled
//     and masked (cols < Sk), never padded in device memory.
//   - Thread (ty, tx) = (tid / 16, tid % 16) owns the scores of rows
//     ty + 16 i and columns tx + 16 j (i, j < 4) and the outputs of the same
//     rows, columns tx * Dv/16 .. + Dv/16. A row's 64 scores sit in the 16
//     lanes of one half-warp, so the row max and sum are xor-shuffle trees
//     and m, l and the rescale factor stay in registers; only P goes through
//     shared memory.
//   - The dot is scaled after it is taken; expf and IEEE division (no fast
//     math): the f32 case is held to 2e-5.

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // k columns per tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kPS = kBK + 4;    // row stride of P in shared memory (floats)

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// shared memory of one CTA (floats): Q and K tiles with rows of D + 4 (16-byte
// rows whose starts fall on different banks), the V tile (Dv wide), the P
// tile; 150,528 B at (192, 128)
template <int D, int Dv>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * Dv + kBQ * kPS;
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int64_t Sq, int64_t Sk, int H,
                       int Kv, int causal,
                       int64_t window, float scale) {
  constexpr int QS = D + 4;
  constexpr int DC = Dv / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * Dv;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int kvh = h / (H / Kv);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t row = q0 + r;
    Qs[r * QS + d] = row < Sq ? q[((b * Sq + row) * H + h) * D + d] : 0.0f;
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
      Ks[r * QS + d] =
          col < Sk ? k[((b * Sk + col) * Kv + kvh) * D + d] : 0.0f;
    }
    for (int idx = tid; idx < kBK * Dv; idx += kThreads) {
      const int r = idx / Dv, d = idx % Dv;
      const int64_t col = k0 + r;
      Vs[r * Dv + d] =
          col < Sk ? v[((b * Sk + col) * Kv + kvh) * Dv + d] : 0.0f;
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
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
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
        for (int c = 0; c < DC; ++c) vr[c] = Vs[(j + jj) * Dv + tx * DC + c];
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
    // every lane of the half-warp holds the row's m and l: one writes lse
    if (lse != nullptr && tx == 0)
      lse[(b * H + h) * Sq + row] = m[i] + logf(denom);
    float* o = out + ((b * Sq + row) * H + h) * Dv + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = acc[i][c] / denom;
  }
}

template <int D, int Dv>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                       int64_t Kv, int64_t causal, int64_t window, float scale,
                       cudaStream_t stream) {
  const int smem = smem_floats<D, Dv>() * static_cast<int>(sizeof(float));
  auto* kernel = flash_attention_kernel<D, Dv>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, static_cast<int>(H),
      static_cast<int>(Kv), causal != 0, window, scale);
  return cudaGetLastError();
}

// (D, Dv) as one case label of the C entry's switch
constexpr int64_t pair(int64_t d, int64_t dv) { return d << 16 | dv; }

}  // namespace

// q: (B, Sq, H, D), k: (B, Sk, Kv, D), v: (B, Sk, Kv, Dv), out: (B, Sq, H,
// Dv), all contiguous and of one dtype (f32, or bf16 when bf16 != 0); lse:
// (B, H, Sq) f32 or null (not written); (D, Dv) one of the pairs below;
// window 0 = no window; scale = D^-1/2 rounded to f32. bf16 takes the wgmma
// body and needs q, k and v on 16-byte boundaries (TMA); f32 the CUDA-core
// body.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int64_t B, int64_t Sq,
                               int64_t Sk,
                               int64_t H, int64_t Kv, int64_t D, int64_t Dv,
                               int64_t causal, int64_t window, int64_t bf16,
                               float scale, void* stream) {
  constexpr int64_t kMax = 0x7fffffff;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 ||
      window < 0 || window > kMax || Sq > kMax || Sk > kMax || B > 65535 ||
      H > 65535 || (Sq + kBM - 1) / kBM * B * H > kMax || D <= 0 || Dv <= 0 ||
      D > 0xffff || Dv > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (pair(D, Dv)) {
      case pair(16, 16): return launch_wgmma<16, 16>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(32, 32): return launch_wgmma<32, 32>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(64, 64): return launch_wgmma<64, 64>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(112, 112): return launch_wgmma<112, 112>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(128, 128): return launch_wgmma<128, 128>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(48, 32): return launch_wgmma<48, 32>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      case pair(192, 128): return launch_wgmma<192, 128>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (pair(D, Dv)) {
    case pair(16, 16): return launch_f32<16, 16>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(32, 32): return launch_f32<32, 32>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(64, 64): return launch_f32<64, 64>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(112, 112): return launch_f32<112, 112>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(128, 128): return launch_f32<128, 128>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(48, 32): return launch_f32<48, 32>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    case pair(192, 128): return launch_f32<192, 128>(q, k, v, out, lse, B, Sq, Sk, H, Kv, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
