// flash_fwd_sm90: the bf16 flash-attention forward, alone or with its
// logsumexp, on Hopper's tensor cores (wgmma, TMA and mbarriers; sm_90a):
//
//   repro_flash_fwd_sm90   o = softmax(q k^T * scale) v, and where lse is
//                          not null, lse = m + log l (fp32) per q row
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py:flash_attention (_attn_kernel,
//     its pallas_call at :86) and
//   src/repro/kernels/flash_attention_bwd.py:_fwd (_fwd_kernel, :171),
// for bf16 operands. fp32 operands keep the FMA kernel of
// flash_attention.cu: TF32 products keep ~3 digits, short of the fp32 bars.
//
// Layout and masks as in flash_attention.cu: q (B, Hq, Sq, hd), k and v
// (B, Hkv, Sk, hd), contiguous bf16, q head h reads kv head h / R; hd 64
// or 128, any S. Key kpos is visible from query qpos when kpos < Sk,
// causal -> kpos <= qpos (aligned top-left), window > 0 -> kpos > qpos -
// window. Masked entries get probability 0 (a select); a q row that sees
// no key comes out 0 with lse -1e30. Output bf16, lse fp32.
//
// What bounds it on an H100: operations. At the train step's shape (B 2,
// 16 q / 8 kv heads, S 4096, hd 128, causal) it does 4 flops per visible
// (q, k) pair and head dim, 137 GFLOP against 0.1 GB of operands.
//
// Why P is split: the probabilities P go into P V as two bf16 terms, P_hi
// = bf16(P) and P_lo = bf16(P - P_hi), O += P_hi V + P_lo V, so P keeps
// ~16 bits. P rounded once to bf16 (as FA2, FA3 and SDPA do) misses the
// bf16 bars the port holds its kernels to (each element within one bf16
// rounding of the fp32 plain version's, 2^-7 |b| + 1e-3 rms(b); relative
// L2 <= 1e-3): emulated on the CPU against the plain version (bf16 q, k,
// v, B 1, H 4, S 1024, hd 128, causal) single-rounded P uses 12.6 of the
// element bar and has relative L2 2.1e-3; the split uses 0.86 and 6.8e-5.
// It costs 1.5x the products: the design's floor at the train step's
// shape is 0.2085 ms against the 0.1390 ms of the single product.
// Q stays exact in bf16: the scale is applied to S in fp32 after the
// product, folded with log2(e) into the FMA ahead of exp2f; m and l stay
// fp32 and l sums the unrounded P.
//
// Design: a block takes 128 q rows of one head: two consumer warpgroups
// of 64 rows and one producer warp. The producer loads the q tile once
// and streams the block's visible kv tiles (128 rows) through a ring of
// two K and two V stages with TMA (3-D maps (hd, S, B H): a tile past S
// reads zeros, not the next head; 128-byte swizzle, hd 128 as two
// 64-column boxes), each stage with its own full barrier and one empty
// barrier the eight consumer warps arrive on. A consumer warpgroup takes
// S = Q K^T with wgmma m64n128k16 (Q and K from shared memory, K-major),
// the online softmax in registers (a row lives in the four lanes of a
// quad), and O += P_hi V + P_lo V with wgmma m64n{hd}k16, A from
// registers (the S accumulator's fragment packed in bf16 pairs is the A
// fragment of a k16 step) and V from shared memory in MN-major order (the
// transpose bit): no transpose pass. Causal tiles past the diagonal and
// window tiles before it are never loaded; the per-score mask runs on the
// boundary tiles only; the heaviest causal q tiles launch first. The
// Hopper pieces it shares with flash_bwd_sm90.cu are in sm90_common.cuh.
// No --use_fast_math: exp2f and logf are the accurate ones.
#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;                    // q rows a block
constexpr int kBK = 128;                    // kv rows a tile
constexpr int kStages = 2;                  // K and V ring depth
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory from a 1024-byte aligned base: q, the K ring, the V ring
// (each tile hd / 64 chunks of rows x 128 bytes, swizzled), then the
// barriers q_full, k_full[kStages], v_full[kStages], empty[kStages]
template <int HD>
struct Smem {
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kTileBytes = kBK * HD * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const Dims& d) {
  return kpos < d.Sk && (!d.causal || kpos <= qpos) &&
         (d.window <= 0 || kpos > qpos - d.window);
}

// the kv tiles [t_lo, t_hi) that q rows [q0, q0 + kBQ) can see
__device__ __forceinline__ void kv_tiles(int q0, const Dims& d, int& t_lo,
                                         int& t_hi) {
  int hi = d.Sk;
  if (d.causal) hi = min(hi, min(q0 + kBQ, d.Sq));
  const int lo = d.window > 0 ? max(0, q0 - d.window + 1) : 0;
  t_lo = lo / kBK;
  t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block: q rows [q0, q0 + 128) of head blockIdx.x (heaviest causal q
// tiles first: blockIdx.y counts down from the last q tile). Accumulator
// fragment of a warpgroup's m64nN product, per thread: element 4 j + e
// sits at row 16 w + lane / 4 + 8 (e >> 1) of the warpgroup's 64 (w its
// warp), column 8 j + 2 (lane % 4) + (e & 1).
template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Dims d) {
  using L = Smem<HD>;
  constexpr int kChunks = HD / 64;          // 64-column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                 // + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const int bh = blockIdx.x, b = bh / d.Hq, h = bh % d.Hq;
  const int bkv = b * d.Hkv + h / (d.Hq / d.Hkv);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  int t_lo, t_hi;
  kv_tiles(q0, d, t_lo, t_hi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {             // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(base + c * kBQ * 128, &tq, q_full, c * 64, q0, bh);
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t ks = base + L::kK + s * L::kTileBytes;
        const uint32_t vs = base + L::kV + s * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(ks + c * kBK * 128, &tk, k_full + 8 * s, c * 64, t * kBK,
                   bkv);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(vs + c * kBK * 128, &tv, v_full + 8 * s, c * 64, t * kBK,
                   bkv);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [row_lo, row_lo + 64) of the block
  const int wg = warp / 4, wl = warp % 4;
  const int row_lo = q0 + 64 * wg;
  const int row_hi = min(row_lo + 63, d.Sq - 1);      // < row_lo: no rows
  const int ra = row_lo + 16 * wl + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const float c2 = d.scale * kLog2e;
  const uint32_t qs = base + wg * 64 * 128;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;   // log2 units
  mbar_wait(q_full, 0);

  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = t * kBK, k_last = min(k0 + kBK, d.Sk) - 1;
    const bool none = row_hi < row_lo || k0 >= d.Sk ||
                      (d.causal && k0 > row_hi) ||
                      (d.window > 0 && k_last <= row_lo - d.window);
    const bool full = k0 + kBK <= d.Sk &&
                      (!d.causal || k0 + kBK - 1 <= row_lo) &&
                      (d.window <= 0 || k0 > row_hi - d.window);
    mbar_wait(k_full + 8 * s, par);
    if (!none) {
      const uint32_t ks = base + L::kK + s * L::kTileBytes;
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss(sc, smem_desc(qs + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16,
                               1024),
                 smem_desc(ks + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16,
                           1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (!full) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int qpos = (i & 2) ? rb : ra;
          const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
          if (!visible(qpos, kpos, d)) sc[i] = -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if (i & 2) mx_b = fmaxf(mx_b, sc[i]);
        else mx_a = fmaxf(mx_a, sc[i]);
      }
      mx_a = fmaxf(m_a, quad_max(mx_a) * c2);
      mx_b = fmaxf(m_b, quad_max(mx_b) * c2);
      const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      uint32_t ph[kBK / 4], pl[kBK / 4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const float mm = (j & 1) ? mx_b : mx_a;
        float p0 = exp2f(fmaf(sc[2 * j], c2, -mm));
        float p1 = exp2f(fmaf(sc[2 * j + 1], c2, -mm));
        if (!full) {
          p0 = sc[2 * j] == -INFINITY ? 0.f : p0;
          p1 = sc[2 * j + 1] == -INFINITY ? 0.f : p1;
        }
        if (j & 1) sum_b += p0 + p1;
        else sum_a += p0 + p1;
        split_pair(p0, p1, ph[j], pl[j]);
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? corr_b : corr_a;

      mbar_wait(v_full + 8 * s, par);
      const uint32_t vs = base + L::kV + s * L::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(vs + kk * 16 * 128, kBK * 128, 1024);
        wgmma_rs(acc, ph + 4 * kk, dv);
        wgmma_rs(acc, pl + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);                       // read by the wgmmas until here
      fence_regs(pl);
    } else {
      mbar_wait(v_full + 8 * s, par);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= d.Sq) continue;
    const float l = half ? lb : la;
    __nv_bfloat16* orow = o + ((size_t)bh * d.Sq + row) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] / l,
                                acc[4 * j + 2 * half + 1] / l);
    if (kLse && lane % 4 == 0) {
      const float lr = half ? l_b : l_a, m = half ? m_b : m_a;
      lse[(size_t)bh * d.Sq + row] = lr > 0.f ? m * kLn2 + logf(l) : kNegInf;
    }
  }
}

template <int HD, bool kLse>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        const Dims& d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int rc = make_map(&tq, q, HD, d.Sq, d.B * d.Hq, kBQ)) return rc;
  if (int rc = make_map(&tk, k, HD, d.Sk, d.B * d.Hkv, kBK)) return rc;
  if (int rc = make_map(&tv, v, HD, d.Sk, d.B * d.Hkv, kBK)) return rc;
  auto kern = fwd_kernel_sm90<HD, kLse>;
  const int smem = (int)Smem<HD>::kBytes;
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)rc;
  const dim3 grid(d.B * d.Hq, (d.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, (__nv_bfloat16*)o, lse,
                                         d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 tensors on the current device as laid out
// above, 16-byte aligned; lse: fp32 (B, Hq, Sq), or null for the forward
// alone; scale the softmax scale (1/sqrt(hd), rounded to fp32 by the
// caller), causal 0/1, window 0 for none. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape or pointer the
// kernel does not take, cudaErrorNotSupported without the driver's
// tensor-map encoder).
extern "C" int repro_flash_fwd_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int Hq, int Hkv, int Sq, int Sk, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if ((hd != 64 && hd != 128) || B < 1 || Hkv < 1 || Hq < Hkv ||
      Hq % Hkv != 0 || Sq < 1 || Sk < 1 || (long long)B * Hq > 65535 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (hd == 64)
    return l ? run<64, true>(q, k, v, o, l, d, st)
             : run<64, false>(q, k, v, o, nullptr, d, st);
  return l ? run<128, true>(q, k, v, o, l, d, st)
           : run<128, false>(q, k, v, o, nullptr, d, st);
}
