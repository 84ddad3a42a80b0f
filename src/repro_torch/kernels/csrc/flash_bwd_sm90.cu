// flash_bwd_sm90: the bf16 flash-attention backward on Hopper's tensor
// cores (wgmma, TMA and mbarriers; sm_90a), in two kernels:
//
//   repro_flash_dq_sm90    dq = dS k, with P = exp(s - lse) and
//                          dS = P (dO v^T - delta) scale
//   repro_flash_dkv_sm90   dk = dS^T q, dv = P^T dO, summed over the R q
//                          heads that share a kv head
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention_bwd.py:_dq_kernel (its pallas_call
//     in _bwd_rule at :209) and
//   src/repro/kernels/flash_attention_bwd.py:_dkv_kernel (:226),
// for bf16 operands. fp32 operands keep the FMA kernels of
// flash_attention.cu: TF32 products keep ~3 digits, short of the fp32
// bars. delta = rowsum(O dO) (fp32) is computed outside, as at
// flash_attention_bwd.py:204.
//
// Layout and masks as in flash_attention.cu: q and dO (B, Hq, Sq, hd), k
// and v (B, Hkv, Sk, hd), contiguous bf16, q head h reads kv head h / R;
// lse and delta fp32 (B, Hq, Sq); hd 64 or 128, any S. Key kpos is
// visible from query qpos when kpos < Sk, causal -> kpos <= qpos (aligned
// top-left), window > 0 -> kpos > qpos - window. Outputs bf16.
//
// What bounds it on an H100: operations. At the train step's shape (B 2,
// 16 q / 8 kv heads, S 4096, hd 128, causal) dQ does 6 flops per visible
// (q, k) pair and head dim and dK/dV 8, against ~0.1 GB of operands.
//
// Why P and dS are split: each goes into its products as two bf16 terms,
// x_hi = bf16(x) and x_lo = bf16(x - x_hi), so it keeps ~16 bits: dV +=
// P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q, dQ += dS_hi K +
// dS_lo K. Rounded once to bf16 (as FA2, FA3 and SDPA do) they miss the
// bf16 bars the port holds its kernels to (each element within one bf16
// rounding of the fp32 plain version's, 2^-7 |b| + 1e-3 rms(b); relative
// L2 <= 1e-3): emulated on the CPU against the plain version (bf16 q, k,
// v, dO, B 1, 4 q / 2 kv heads, S 1024, hd 128, causal) single-rounded P
// and dS use 9-15 of the element bar with relative L2 2.5e-3; the split
// uses < 1 and ~8e-5. Only P feeds dV and only dS feeds dQ and dK, so
// both are split. The design's floor at the train step's shape: dQ 4
// products against the bound's 3 (S, dP, dS_hi K, dS_lo K), dK/dV 6
// against 4. Q and dO stay exact in bf16: the scale is applied to S in
// fp32 after the product, folded with log2(e) into the FMA ahead of
// exp2f, P = exp2(S scale log2 e - lse log2 e).
//
// Design: two kernels, no atomics, so the sums are deterministic; each
// recomputes S and dP. Both have two consumer warpgroups of 64 rows and a
// producer warpgroup, one thread of which streams tiles by TMA (3-D maps
// (hd, S, B H): a tile past S reads zeros, not the next head; 128-byte
// swizzle, hd 128 as two 64-column boxes) through a ring of kStages
// stages, each with one full barrier and one empty barrier the eight
// consumer warps arrive on.
//   dQ: a block takes 128 q rows of one head (the heaviest causal q tiles
//   first); the producer loads Q and dO once and streams the visible K
//   and V tiles of 64 rows. A consumer warpgroup takes S = Q K^T and dP =
//   dO V^T with wgmma m64n64k16 (both operands from shared memory,
//   K-major), P and dS in registers (lse and delta of its two rows held
//   by the thread), and dQ += dS_hi K + dS_lo K with wgmma m64n{hd}k16, A
//   from registers (the dS accumulator's fragment packed in bf16 pairs)
//   and K from shared memory in MN-major order (the transpose bit).
//   dK/dV: a block takes 128 kv rows of one kv head (the early causal kv
//   tiles first), loaded once; the producer streams, for each of the R q
//   heads and each visible q tile of 64 rows, Q, dO and the tile's lse
//   and delta (1-D maps; a 1-D box must start on a 16-byte boundary, so
//   it starts at the one at or before the tile's first row). A consumer
//   warpgroup owns 64 kv rows and keeps dK and dV in registers across all
//   of them. S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared
//   memory): the accumulator's rows are kv rows, so P^T and dS^T are
//   directly the register A fragments of dV += P^T_hi dO + P^T_lo dO and
//   dK += dS^T_hi Q + dS^T_lo Q, dO and Q read MN-major (the transpose
//   bit).
// Causal tiles past the diagonal and window tiles before it are never
// loaded; the per-score mask runs on boundary tiles only, and it is a
// select: a q row that sees no key arrives with lse -1e30 (exp2 gives
// +inf there), and q rows past Sq in a tile read zero Q and dO but
// another head's lse and delta; both get P = dS = 0. So dQ of a row that
// sees no key is 0, and dK and dV of a kv row no query sees are 0.
// Registers: dK and dV (64 rows x hd 128) take 128 a consumer thread, S^T
// and dP^T 64 more, past the 168 ptxas allots a thread of a 288- or
// 384-thread block (there it spills, and dK/dV runs several times
// slower); so the producer group gives registers up (setmaxnreg to 24)
// and the consumers take them (240, where nothing spills). In dQ, S and
// dP are committed as two wgmma groups and P is taken while dP runs;
// dK/dV cannot afford that overlap (ptxas then serializes its wgmmas for
// want of registers). No --use_fast_math: exp2f is the accurate one.
#include "sm90_common.cuh"

namespace {

constexpr int kStages = 3;                  // ring depth
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 4);   // + a producer group
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kDqRows = 128;                // dQ: q rows a block
constexpr int kDqTile = 64;                 // dQ: kv rows a streamed tile
constexpr int kKvRows = 128;                // dK/dV: kv rows a block
constexpr int kKvTile = 64;                 // dK/dV: q rows a streamed tile
constexpr int kStatBox = kKvTile + 4;       // lse / delta values a tile box

__device__ __forceinline__ bool visible(int qpos, int kpos, const Dims& d) {
  return qpos < d.Sq && kpos < d.Sk && (!d.causal || kpos <= qpos) &&
         (d.window <= 0 || kpos > qpos - d.window);
}

// shared memory from a 1024-byte aligned base: Q, dO, the K ring, the V
// ring (each tile hd / 64 chunks of rows x 128 bytes, swizzled), then the
// barriers q_full, full[kStages], empty[kStages]
template <int HD>
struct DqSmem {
  static constexpr uint32_t kQBytes = kDqRows * HD * 2;
  static constexpr uint32_t kTileBytes = kDqTile * HD * 2;
  static constexpr uint32_t kDo = kQBytes;
  static constexpr uint32_t kK = 2 * kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// One block: q rows [q0, q0 + 128) of head blockIdx.x (blockIdx.y counts
// down from the last q tile). The fragment layout is sm90_common.cuh's.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, Dims d) {
  using L = DqSmem<HD>;
  constexpr int kChunks = HD / 64;          // 64-column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full = q_full + 8;                   // + 8 s
  const uint32_t empty = full + 8 * kStages;
  const int bh = blockIdx.x, b = bh / d.Hq, h = bh % d.Hq;
  const int bkv = b * d.Hkv + h / (d.Hq / d.Hkv);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kDqRows;
  // the kv tiles [t_lo, t_hi) that the block's q rows can see
  const int k_hi = d.causal ? min(d.Sk, min(q0 + kDqRows, d.Sq)) : d.Sk;
  const int k_lo = d.window > 0 ? max(0, q0 - d.window + 1) : 0;
  const int t_lo = k_lo / kDqTile;
  const int t_hi = k_hi > k_lo ? (k_hi + kDqTile - 1) / kDqTile : t_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {             // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + c * kDqRows * 128, &tq, q_full, c * 64, q0, bh);
        tma_load(base + L::kDo + c * kDqRows * 128, &tdo, q_full, c * 64, q0,
                 bh);
      }
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t ks = base + L::kK + s * L::kTileBytes;
        const uint32_t vs = base + L::kV + s * L::kTileBytes;
        mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(ks + c * kDqTile * 128, &tk, full + 8 * s, c * 64,
                   t * kDqTile, bkv);
          tma_load(vs + c * kDqTile * 128, &tv, full + 8 * s, c * 64,
                   t * kDqTile, bkv);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [row_lo, row_lo + 64) of the block
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int row_lo = q0 + 64 * wg;
  const int row_hi = min(row_lo + 63, d.Sq - 1);      // < row_lo: no rows
  const int ra = row_lo + 16 * wl + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const float c2 = d.scale * kLog2e;
  // lse log2 e and delta of rows ra and rb (0 past Sq: never stored)
  const float l2a = ra < d.Sq ? lse[(size_t)bh * d.Sq + ra] * kLog2e : 0.f;
  const float l2b = rb < d.Sq ? lse[(size_t)bh * d.Sq + rb] * kLog2e : 0.f;
  const float dla = ra < d.Sq ? delta[(size_t)bh * d.Sq + ra] : 0.f;
  const float dlb = rb < d.Sq ? delta[(size_t)bh * d.Sq + rb] : 0.f;
  const uint32_t qs = base + wg * 64 * 128;
  const uint32_t dos = base + L::kDo + wg * 64 * 128;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % kStages;
    const int k0 = t * kDqTile, k_last = min(k0 + kDqTile, d.Sk) - 1;
    const bool none = row_hi < row_lo || k0 >= d.Sk ||
                      (d.causal && k0 > row_hi) ||
                      (d.window > 0 && k_last <= row_lo - d.window);
    const bool whole = k0 + kDqTile <= d.Sk && row_lo + 64 <= d.Sq &&
                       (!d.causal || k0 + kDqTile - 1 <= row_lo) &&
                       (d.window <= 0 || k0 > row_hi - d.window);
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (!none) {
      const uint32_t ks = base + L::kK + s * L::kTileBytes;
      const uint32_t vs = base + L::kV + s * L::kTileBytes;
      float sc[kDqTile / 2], dp[kDqTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc,
                 smem_desc(qs + (kk / 4) * kDqRows * 128 + (kk % 4) * 32, 16,
                           1024),
                 smem_desc(ks + (kk / 4) * kDqTile * 128 + (kk % 4) * 32, 16,
                           1024),
                 kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dp,
                 smem_desc(dos + (kk / 4) * kDqRows * 128 + (kk % 4) * 32,
                           16, 1024),
                 smem_desc(vs + (kk / 4) * kDqTile * 128 + (kk % 4) * 32, 16,
                           1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                      // S is in, dP still running:
      fence_regs(sc);                       // P in place of S meanwhile
#pragma unroll
      for (int i = 0; i < kDqTile / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], c2, (i & 2) ? -l2b : -l2a));
      wgmma_wait<0>();
      fence_regs(dp);

      // dS pairs (elements 2 j, 2 j + 1: row rb where j is odd)
      uint32_t dh[kDqTile / 4], dl[kDqTile / 4];
#pragma unroll
      for (int j = 0; j < kDqTile / 4; ++j) {
        const bool hb = j & 1;
        const float dl_row = hb ? dlb : dla;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          ds[e] = sc[i] * (dp[i] - dl_row) * d.scale;
          if (!whole)
            ds[e] = visible(hb ? rb : ra, k0 + 8 * (i / 4) + cq + e, d)
                        ? ds[e] : 0.f;
        }
        split_pair(ds[0], ds[1], dh[j], dl[j]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqTile / 16; ++kk) {
        const uint64_t dk = smem_desc(ks + kk * 16 * 128, kDqTile * 128, 1024);
        wgmma_rs(acc, dh + 4 * kk, dk);
        wgmma_rs(acc, dl + 4 * kk, dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dh);                       // read by the wgmmas until here
      fence_regs(dl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= d.Sq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * d.Sq + row) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
}

// shared memory from a 1024-byte aligned base: K, V, the Q ring, the dO
// ring (each tile hd / 64 chunks of rows x 128 bytes, swizzled), the lse
// ring and the delta ring (kStatBox fp32 each, from the 16-byte boundary
// at or before the tile's first row: a 1-D box must start on one), then
// the barriers kv_full, full[kStages], empty[kStages]
template <int HD>
struct DkvSmem {
  static constexpr uint32_t kKBytes = kKvRows * HD * 2;
  static constexpr uint32_t kTileBytes = kKvTile * HD * 2;
  static constexpr uint32_t kStatBytes = 384;       // >= kStatBox * 4
  static constexpr uint32_t kV = kKBytes;
  static constexpr uint32_t kQ = 2 * kKBytes;
  static constexpr uint32_t kDo = kQ + kStages * kTileBytes;
  static constexpr uint32_t kLse = kDo + kStages * kTileBytes;
  static constexpr uint32_t kDelta = kLse + kStages * kStatBytes;
  static constexpr uint32_t kBar = kDelta + kStages * kStatBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// One block: kv rows [k0, k0 + 128) of kv head blockIdx.x (k0 =
// blockIdx.y * 128: the early causal kv tiles, which most q tiles see,
// launch first). Its steps walk the R q heads of the kv head and, for
// each, the visible q tiles.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tlse,
                const __grid_constant__ CUtensorMap tdelta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, Dims d) {
  using L = DkvSmem<HD>;
  constexpr int kChunks = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;                  // + 8 s
  const uint32_t empty = full + 8 * kStages;
  const int bg = blockIdx.x, b = bg / d.Hkv, g = bg % d.Hkv;
  const int R = d.Hq / d.Hkv;
  const int k0 = blockIdx.y * kKvRows;
  // the q tiles [t_lo, t_hi) that see any key of the block: causal ->
  // qpos >= k0; window -> qpos < kpos + window <= k_end - 1 + window
  const int k_end = min(k0 + kKvRows, d.Sk);
  const int q_lo = d.causal ? k0 : 0;
  const int q_hi = d.window > 0 ? min(d.Sq, k_end - 1 + d.window) : d.Sq;
  const int t_lo = q_lo / kKvTile;
  const int n_t = q_hi > q_lo ? (q_hi + kKvTile - 1) / kKvTile - t_lo : 0;
  const int steps = R * n_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {             // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + c * kKvRows * 128, &tk, kv_full, c * 64, k0, bg);
        tma_load(base + L::kV + c * kKvRows * 128, &tv, kv_full, c * 64, k0,
                 bg);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages;
        const int bh = b * d.Hq + g * R + it / n_t;
        const int q0 = (t_lo + it % n_t) * kKvTile;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t qs = base + L::kQ + s * L::kTileBytes;
        const uint32_t dos = base + L::kDo + s * L::kTileBytes;
        mbar_expect_tx(bar, 2 * L::kTileBytes + 2 * kStatBox * 4);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(qs + c * kKvTile * 128, &tq, bar, c * 64, q0, bh);
          tma_load(dos + c * kKvTile * 128, &tdo, bar, c * 64, q0, bh);
        }
        const int x = (bh * d.Sq + q0) & ~3;
        tma_load_1d(base + L::kLse + s * L::kStatBytes, &tlse, bar, x);
        tma_load_1d(base + L::kDelta + s * L::kStatBytes, &tdelta, bar, x);
      }
    }
    return;
  }

  // a consumer warpgroup: kv rows [kv_lo, kv_lo + 64) of the block
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int kv_lo = k0 + 64 * wg;
  const int kv_last = min(kv_lo + 63, d.Sk - 1);      // < kv_lo: no rows
  const int ka = kv_lo + 16 * wl + lane / 4, kb = ka + 8;
  const int cq = 2 * (lane % 4);
  const float c2 = d.scale * kLog2e;
  const uint32_t ks = base + wg * 64 * 128;
  const uint32_t vs = base + L::kV + wg * 64 * 128;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    const int bh = b * d.Hq + g * R + it / n_t;
    const int q0 = (t_lo + it % n_t) * kKvTile;
    const int q_last = min(q0 + kKvTile, d.Sq) - 1;
    const bool none = kv_last < kv_lo || (d.causal && q_last < kv_lo) ||
                      (d.window > 0 && kv_last <= q0 - d.window);
    const bool whole = kv_lo + 64 <= d.Sk && q0 + kKvTile <= d.Sq &&
                       (!d.causal || kv_lo + 63 <= q0) &&
                       (d.window <= 0 || kv_lo > q0 + kKvTile - 1 - d.window);
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (!none) {
      const uint32_t qs = base + L::kQ + s * L::kTileBytes;
      const uint32_t dos = base + L::kDo + s * L::kTileBytes;
      const int off = (bh * d.Sq + q0) & 3;     // the tile's first row
      const float* lse_s = reinterpret_cast<const float*>(
                               gbase + L::kLse + s * L::kStatBytes) + off;
      const float* delta_s = reinterpret_cast<const float*>(
                                 gbase + L::kDelta + s * L::kStatBytes) + off;
      float st[kKvTile / 2], dpt[kKvTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(st,
                 smem_desc(ks + (kk / 4) * kKvRows * 128 + (kk % 4) * 32, 16,
                           1024),
                 smem_desc(qs + (kk / 4) * kKvTile * 128 + (kk % 4) * 32, 16,
                           1024),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dpt,
                 smem_desc(vs + (kk / 4) * kKvRows * 128 + (kk % 4) * 32, 16,
                           1024),
                 smem_desc(dos + (kk / 4) * kKvTile * 128 + (kk % 4) * 32,
                           16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T pairs (elements 2 j, 2 j + 1: kv row kb where j is
      // odd, q columns 8 (j / 2) + cq and the next)
      uint32_t ph[kKvTile / 4], pl[kKvTile / 4], dh[kKvTile / 4],
          dl[kKvTile / 4];
#pragma unroll
      for (int j = 0; j < kKvTile / 4; ++j) {
        const int kpos = (j & 1) ? kb : ka;
        const int qi = 8 * (j / 2) + cq;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          p[e] = exp2f(fmaf(st[i], c2, -lse_s[qi + e] * kLog2e));
          ds[e] = p[e] * (dpt[i] - delta_s[qi + e]) * d.scale;
          if (!whole) {
            const bool vis = visible(q0 + qi + e, kpos, d);
            p[e] = vis ? p[e] : 0.f;
            ds[e] = vis ? ds[e] : 0.f;
          }
        }
        split_pair(p[0], p[1], ph[j], pl[j]);
        split_pair(ds[0], ds[1], dh[j], dl[j]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk) {
        const uint64_t dd = smem_desc(dos + kk * 16 * 128, kKvTile * 128,
                                      1024);
        wgmma_rs(dva, ph + 4 * kk, dd);
        wgmma_rs(dva, pl + 4 * kk, dd);
      }
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk) {
        const uint64_t dqs = smem_desc(qs + kk * 16 * 128, kKvTile * 128,
                                       1024);
        wgmma_rs(dka, dh + 4 * kk, dqs);
        wgmma_rs(dka, dl + 4 * kk, dqs);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(ph);                       // read by the wgmmas until here
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? kb : ka;
    if (row >= d.Sk) continue;
    const size_t off = ((size_t)bg * d.Sk + row) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * half],
                                dka[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * half],
                                dva[4 * j + 2 * half + 1]);
    }
  }
}

int check_dims(const Dims& d, int hd) {
  if ((hd != 64 && hd != 128) || d.B < 1 || d.Hkv < 1 || d.Hq < d.Hkv ||
      d.Hq % d.Hkv != 0 || d.Sq < 1 || d.Sk < 1 ||
      (long long)d.B * d.Hq > 65535 || (d.Sq + kDqRows - 1) / kDqRows > 65535 ||
      (d.Sk + kKvRows - 1) / kKvRows > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int allow_smem(K kern, uint32_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, const Dims& d,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (int rc = make_map(&tq, q, HD, d.Sq, d.B * d.Hq, kDqRows)) return rc;
  if (int rc = make_map(&tdo, dout, HD, d.Sq, d.B * d.Hq, kDqRows)) return rc;
  if (int rc = make_map(&tk, k, HD, d.Sk, d.B * d.Hkv, kDqTile)) return rc;
  if (int rc = make_map(&tv, v, HD, d.Sk, d.B * d.Hkv, kDqTile)) return rc;
  auto kern = dq_kernel_sm90<HD>;
  const uint32_t smem = DqSmem<HD>::kBytes;
  if (int rc = allow_smem(kern, smem)) return rc;
  const dim3 grid(d.B * d.Hq, (d.Sq + kDqRows - 1) / kDqRows);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                         (__nv_bfloat16*)dq, d);
  return (int)cudaGetLastError();
}

template <int HD>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            const Dims& d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const long long rows = (long long)d.B * d.Hq * d.Sq;
  if (int rc = make_map(&tq, q, HD, d.Sq, d.B * d.Hq, kKvTile)) return rc;
  if (int rc = make_map(&tdo, dout, HD, d.Sq, d.B * d.Hq, kKvTile)) return rc;
  if (int rc = make_map(&tk, k, HD, d.Sk, d.B * d.Hkv, kKvRows)) return rc;
  if (int rc = make_map(&tv, v, HD, d.Sk, d.B * d.Hkv, kKvRows)) return rc;
  if (int rc = make_map_1d(&tlse, lse, rows, kStatBox)) return rc;
  if (int rc = make_map_1d(&tdelta, delta, rows, kStatBox)) return rc;
  auto kern = dkv_kernel_sm90<HD>;
  const uint32_t smem = DkvSmem<HD>::kBytes;
  if (int rc = allow_smem(kern, smem)) return rc;
  const dim3 grid(d.B * d.Hkv, (d.Sk + kKvRows - 1) / kKvRows);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, tlse, tdelta,
                                         (__nv_bfloat16*)dk,
                                         (__nv_bfloat16*)dv, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points: q, k, v, dout and the outputs contiguous bf16
// tensors on the current device as laid out above, lse and delta fp32
// (B, Hq, Sq), every pointer 16-byte aligned; scale the softmax scale
// (1/sqrt(hd), rounded to fp32 by the caller), causal 0/1, window 0 for
// none. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape or pointer the kernels do not take, cudaErrorNotSupported
// without the driver's tensor-map encoder).
extern "C" int repro_flash_dq_sm90(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int Hq, int Hkv, int Sq,
                                   int Sk, int hd, int causal, int window,
                                   float scale, void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  return hd == 64 ? run_dq<64>(q, k, v, dout, l, dl, dq, d, st)
                  : run_dq<128>(q, k, v, dout, l, dl, dq, d, st);
}

extern "C" int repro_flash_dkv_sm90(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  return hd == 64 ? run_dkv<64>(q, k, v, dout, l, dl, dk, dv, d, st)
                  : run_dkv<128>(q, k, v, dout, l, dl, dk, dv, d, st);
}
