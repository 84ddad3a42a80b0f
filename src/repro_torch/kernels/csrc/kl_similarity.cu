// kl_similarity: pairwise KL task similarity (paper Eq. 4).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kl_similarity.py:kl_similarity (_kl_kernel):
//
//   S[i, j] = exp(-(h_i - p_i . logq_j)),   p_i = softmax(a_i),
//   h_i = sum_d p_i[d] logp_i[d],           logq_j = log_softmax(b_j)
//
// (exp(-KL(p_i || q_j))).
//
// with a (N, D) and b (M, D) fp32, S (N, M) fp32. On the server's main path
// N = C (each client's newest task feature), M = C k (every client's ring
// of k task features) and D = 128.
//
// What bounds it on an H100: at C = 1000, k = 6 the product is 2 N M D =
// 1.5 GFLOP of fp32 FMA (23 us at 67 TFLOP/s) against 28 MB moved (8 us
// at 3.35 TB/s), so operations; at C = 5 it is a few microseconds of
// launch.
//
// Conditioning: h and p . logq are each about -log D for near-uniform rows,
// and S depends on their difference. Both are taken over logp + log D and
// logq + log D instead (the shift cancels exactly: both weigh it by the
// same p), which centres the summands near 0 and cuts the fp32 rounding
// of the difference from a few ulps of log D (~2e-6 in S at D = 128) to
// ~2e-7. The wrapper passes the fp32 log D that the plain version uses.
//
// Design: two variants (Variant, chosen by _plan in kl_similarity.py from
// the grid).
//   small  one launch, no scratch in device memory: 64 x 64 outputs a
//          block, 4 x 4 a thread, each block working out the statistics of
//          its own 64 rows of a and of b:
//          - a's raw rows go k-major into shared memory by 4-byte cp.async
//            (a warp copies 8 columns of 4 rows an instruction: 4 sectors
//            read, every bank written once), where they stay as p;
//          - meanwhile b's rows, one warp a row and 4 rows a warp at once
//            (the next 4 rows' loads in flight), reduce their max and
//            log-sum with xor shuffles, the lanes striding over D;
//          - then 4 threads an a row split the 32 lane partials of the
//            one-warp-a-row loop between them (max, sum of exp(x - max),
//            h), each lane's columns l, l + 32, .. in order, and add the
//            partials in warp_sum's xor-tree order (lane_tree), writing p
//            over the raw values.
//          The product runs 32 columns a step: each thread loads its share
//          of the next step's b tile (row-major, float4 where D % 4 == 0
//          and the base is 16-byte aligned) into registers before the
//          current step's FMAs, then turns it into logq + log D = x - max -
//          log(sum) + log D on its way into the other of two k-major
//          shared buffers (every element passes through registers for that
//          transform, so the loads go there directly). p holds the first
//          128 columns; a larger D refills it a chunk at a time. Warps whose
//          outputs all lie past N or M skip the FMAs. At C <= 100 this is
//          the whole call; the round's C = 5 is one launch of one block.
//   split  at the fleet's C = 1000 every tile recomputing its rows'
//          statistics, and the 4 x 4 FMAs, cost more than a separate pass:
//          1. a row pass, one warp a row of a and of b, its first 128
//             columns in registers, writes h, and p or logq + log D
//             transposed through shared memory into the caller's k-major
//             scratch (D, N) and (D, M), 32 bytes a column segment;
//          2. 128 x 128 outputs a block, 8 x 8 a thread (two float4 halves
//             64 apart in rows and in columns, so a warp's loads hit no
//             bank twice: per k a thread issues 4 LDS.128 for 64 FFMAs),
//             p and logq arriving by TMA (zeros past N, M and D) in a ring
//             of 3 stages of 32 columns on mbarriers, as in
//             relevance_aggregate.cu's tile. ~96 KB of shared memory, two
//             blocks an SM (three 128 x 64 blocks of 128 threads ran
//             slower on the card).
// The product is IEEE fp32 FMAs in ascending d (no TF32, no tensor cores:
// near-ties in the relevance feed the ranking of neighbours); the epilogue
// exp(cross - h_i), float4 stores where M % 4 == 0.
//
// Both variants do the arithmetic of the two-launch kernel before them,
// operation for operation (every sum in the lane order and xor tree of the
// one-warp-a-row loop, __fdiv_rn, the fmaf chains, zero products past D),
// so S is bit-identical to it.
#include <math.h>

#include "sm90_common.cuh"

namespace {

enum Variant { kSmall = 0, kSplit = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;              // feature columns a k step
constexpr int kDA = 128;             // feature columns of p a block holds
constexpr int kSteps = kDA / kTK;    // k steps a chunk of p feeds
constexpr int kCache = kDA / 32;     // values a lane keeps of a row
constexpr int kRowsB = 4;            // rows of b a warp reduces at once
constexpr int kPadA = 4;             // keeps p's float4 reads aligned

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the small variant's tile: 64 x 64 outputs, 4 x 4 a thread
constexpr int kTN = 64;                  // rows of a a block
constexpr int kTM = 64;                  // rows of b a block
constexpr int kLdA = kTN + kPadA;        // p's k stride
constexpr int kUnits = kTM / 32;         // float4 of b a thread stages
constexpr int kSmallSmem =               // p, 2 b buffers, row statistics
    4 * (kDA * kLdA + 2 * kTK * kTM + 3 * kTN + 2 * kTM);

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// columns [c kDA, c kDA + kDA) of a's rows [i0, i0 + kTN) into ps (k-major)
// by 4-byte cp.async, zeros past N and D; the caller waits. A warp copies 8
// columns of 4 rows an instruction: 4 sectors read, 32 banks written (ps's
// stride is 4 mod 32 banks).
__device__ __forceinline__ void stage_a(const float* __restrict__ a, int i0,
                                        int N, int D, int c, float* ps) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(ps);
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int u = threadIdx.x / 32; u < kDA / 8 * (kTN / 4); u += kWarps) {
    const int d = 8 * (u % (kDA / 8)) + lane % 8;
    const int r = 4 * (u / (kDA / 8)) + lane / 8;
    const int gd = c * kDA + d, row = i0 + r;
    const bool ok = row < N && gd < D;
    cp_async4(base + 4 * (d * kLdA + r),
              ok ? a + (size_t)row * D + gd : a, ok);
  }
}

// the sum of the 32 lane partials part[l * ld] (l = 0 .. 31) in the order
// of warp_sum's xor tree, whose every lane ends with lane 0's sum: own
// value plus partner's, partners 16, 8, 4, 2, 1 apart
template <int kLd>
__device__ __forceinline__ float lane_tree(const float* part) {
  float v[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) v[l] = part[l * kLd];
#pragma unroll
  for (int l = 0; l < 16; ++l) v[l] += v[l + 16];
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] += v[l + 8];
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] += v[l + 4];
  v[0] += v[2];
  v[1] += v[3];
  return v[0] + v[1];
}

// phase 1 for a's rows [i0, i0 + kTN), raw in ps (columns < kDA; beyond,
// from a): kT = 256 / kTN = 4 threads a row, the neighbouring lanes on
// neighbouring rows. The threads of a row split the 32 lane partials of
// the plain one-warp-a-row loop (a thread takes lanes kB j .., in blocks
// of kB = 8 / kT, 8 apart: conflict-free reads of ps) and sum each lane's
// columns l, l + 32, .. in that order; lane_tree then adds the partials
// as warp_sum does. So max, sum, h and p are the one-warp-a-row loop's
// bit for bit. Writes p over the raw columns < kDA (zeros past D) and
// max, sum, h into am, as, ah. scratch: 32 x (kTN + 4) floats.
__device__ __forceinline__ void a_stats(const float* __restrict__ a, int i0,
                                        int N, int D, float shift, float* ps,
                                        float* scratch, float* am, float* as,
                                        float* ah) {
  constexpr int kT = kThreads / kTN;   // threads a row
  constexpr int kR = 32 / kT;             // rows a warp; partials a thread
  constexpr int kB = 8 / kT;
  constexpr int kLdS = kTN + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * kR + lane % kR, j = lane / kR;
  const float* row = a + (size_t)min(i0 + r, N - 1) * D;  // rows past N:
  float* x = ps + r;                                         // staged zeros
  float* part = scratch + r;
  auto lane_of = [&](int i) { return kB * j + 8 * (i / kB) + i % kB; };
  // columns below kDA come from ps, every load unconditional (zeros staged
  // past D) and masked by selects, so the kR chains interleave; columns
  // from kDA on (D > kDA only) from a

  float m = -INFINITY;
#pragma unroll 1
  for (int t0 = 0; t0 < kDA; t0 += 32) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int d = lane_of(i) + t0;
      const float v = x[d * kLdA];
      m = fmaxf(m, d < D ? v : -INFINITY);
    }
  }
  for (int t0 = kDA; t0 < D; t0 += 32)
    for (int i = 0; i < kR; ++i)
      if (lane_of(i) + t0 < D) m = fmaxf(m, row[lane_of(i) + t0]);
#pragma unroll
  for (int off = kR; off < 32; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int t0 = 0; t0 < kDA; t0 += 32) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int d = lane_of(i) + t0;
      const float e = expf(x[d * kLdA] - m);
      if (d < D) acc[i] += e;
    }
  }
  for (int t0 = kDA; t0 < D; t0 += 32)
    for (int i = 0; i < kR; ++i)
      if (lane_of(i) + t0 < D) acc[i] += expf(row[lane_of(i) + t0] - m);
#pragma unroll
  for (int i = 0; i < kR; ++i) part[lane_of(i) * kLdS] = acc[i];
  __syncwarp();
  const float s = lane_tree<kLdS>(part);
  __syncwarp();
  const float lse = logf(s);

#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int t0 = 0; t0 < kDA; t0 += 32) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int d = lane_of(i) + t0;
      const float sh = x[d * kLdA] - m;
      const float pd = __fdiv_rn(expf(sh), s);
      const float hh = fmaf(pd, (sh - lse) + shift, acc[i]);
      acc[i] = d < D ? hh : acc[i];
      x[d * kLdA] = d < D ? pd : 0.f;
    }
  }
  for (int t0 = kDA; t0 < D; t0 += 32)
    for (int i = 0; i < kR; ++i) {
      const int d = lane_of(i) + t0;
      if (d < D) {
        const float sh = row[d] - m;
        const float pd = __fdiv_rn(expf(sh), s);
        acc[i] = fmaf(pd, (sh - lse) + shift, acc[i]);
      }
    }
#pragma unroll
  for (int i = 0; i < kR; ++i) part[lane_of(i) * kLdS] = acc[i];
  __syncwarp();
  const float h = lane_tree<kLdS>(part);
  if (j == 0) {
    am[r] = m;
    as[r] = s;
    ah[r] = h;
  }
}

// p of columns [c kDA, c kDA + kDA), raw in ps, for chunk c >= 1 (D > kDA
// only), from each row's max and sum
__device__ __forceinline__ void a_chunk(int D, int c, float* ps,
                                        const float* am, const float* as) {
  for (int e = threadIdx.x; e < kDA * kTN; e += kThreads) {
    const int d = e / kTN, r = e % kTN;
    float* x = ps + d * kLdA + r;
    *x = c * kDA + d < D ? __fdiv_rn(expf(*x - am[r]), as[r]) : 0.f;
  }
}

// phase 1 for b's rows [j0, j0 + kTM), one warp a row, kRowsB rows a warp
// at once, the lanes striding over D: max and log-sum into bm, bl
__device__ __forceinline__ void b_rows(const float* __restrict__ b, int j0,
                                       int M, int D, float* bm, float* bl) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kStride = kWarps * kRowsB;
  float xn[kRowsB][kCache];              // the next group's first columns
  auto load = [&](int r0) {
#pragma unroll
    for (int g = 0; g < kRowsB; ++g) {
      const float* row = b + (size_t)min(j0 + r0 + g, M - 1) * D;
#pragma unroll
      for (int t = 0; t < kCache; ++t)
        xn[g][t] = lane + 32 * t < D ? row[lane + 32 * t] : -INFINITY;
    }
  };
  load(warp * kRowsB);
  for (int r0 = warp * kRowsB; r0 < kTM; r0 += kStride) {
    if (j0 + r0 >= M) break;             // uniform; later groups lie further
    float x[kRowsB][kCache], m[kRowsB], s[kRowsB];
#pragma unroll
    for (int g = 0; g < kRowsB; ++g)
#pragma unroll
      for (int t = 0; t < kCache; ++t) x[g][t] = xn[g][t];
    if (r0 + kStride < kTM) load(r0 + kStride);
#pragma unroll
    for (int g = 0; g < kRowsB; ++g) {   // rows past M repeat row M - 1
      const float* row = b + (size_t)min(j0 + r0 + g, M - 1) * D;
      m[g] = -INFINITY;
#pragma unroll
      for (int t = 0; t < kCache; ++t) m[g] = fmaxf(m[g], x[g][t]);
      for (int d = lane + kDA; d < D; d += 32) m[g] = fmaxf(m[g], row[d]);
      m[g] = warp_max(m[g]);
      s[g] = 0.f;
#pragma unroll
      for (int t = 0; t < kCache; ++t)
        if (lane + 32 * t < D) s[g] += expf(x[g][t] - m[g]);
      for (int d = lane + kDA; d < D; d += 32) s[g] += expf(row[d] - m[g]);
      s[g] = warp_sum(s[g]);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kRowsB; ++g) {
        bm[r0 + g] = m[g];
        bl[r0 + g] = logf(s[g]);
      }
    }
  }
}

// a thread's share of b's tile at k step kt: kUnits float4 of its row,
// columns 4 (u0 + u) of the step; zeros past M and D
template <bool kVec>
__device__ __forceinline__ void load_b(const float* __restrict__ b, int j,
                                       int M, int D, int k0,
                                       float4 (&v)[kUnits]) {
  const float* src = b + (size_t)min(j, M - 1) * D + k0;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int d = k0 + 4 * u;
    if (kVec) {
      v[u] = (j < M && d < D) ? __ldg(reinterpret_cast<const float4*>(src) + u)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ok = j < M;
      v[u].x = ok && d < D ? __ldg(src + 4 * u) : 0.f;
      v[u].y = ok && d + 1 < D ? __ldg(src + 4 * u + 1) : 0.f;
      v[u].z = ok && d + 2 < D ? __ldg(src + 4 * u + 2) : 0.f;
      v[u].w = ok && d + 3 < D ? __ldg(src + 4 * u + 3) : 0.f;
    }
  }
}

// logq + log D of the loaded values into the k-major buffer qs (kTK x
// kTM) at row r, columns 4 u0 ..; zeros past M and D
__device__ __forceinline__ void store_b(const float4 (&v)[kUnits], float* qs,
                                        int r, int u0, bool row_ok, int k0,
                                        int D, float m, float lse,
                                        float shift) {
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * (u0 + u) + e;
      qs[k * kTM + r] =
          row_ok && k0 + k < D ? ((x[e] - m) - lse) + shift : 0.f;
    }
  }
}

// one k step of kTK: the thread's 4 kG x 4 kG outputs, rows {64 g + 4 ty +
// i} and columns {64 g + 4 tx + j}; ps and qs k-major, kLdP and kLdQ apart
template <int kG, int kLdP, int kLdQ>
__device__ __forceinline__ void mma_step(const float* ps, const float* qs,
                                         int ty, int tx,
                                         float (&acc)[4 * kG][4 * kG]) {
#pragma unroll
  for (int k = 0; k < kTK; ++k) {
    float av[4 * kG], bv[4 * kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(ps + k * kLdP + 64 * g + 4 * ty);
      const float4 y =
          *reinterpret_cast<const float4*>(qs + k * kLdQ + 64 * g + 4 * tx);
      av[4 * g] = x.x, av[4 * g + 1] = x.y, av[4 * g + 2] = x.z,
      av[4 * g + 3] = x.w;
      bv[4 * g] = y.x, bv[4 * g + 1] = y.y, bv[4 * g + 2] = y.z,
      bv[4 * g + 3] = y.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * kG; ++i)
#pragma unroll
      for (int j = 0; j < 4 * kG; ++j)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the epilogue: S = exp(acc - h_i) for the thread's 4 kG x 4 kG outputs
// (mma_step's), h of the tile's rows at hs[0 ..]; float4 stores where M %
// 4 == 0
template <int kG>
__device__ __forceinline__ void store_s(const float (&acc)[4 * kG][4 * kG],
                                        const float* hs,
                                        float* __restrict__ out, int i0,
                                        int j0, int ty, int tx, int N,
                                        int M) {
  const bool vec_out =
      M % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 4 * kG; ++i) {
    const int rr = 64 * (i / 4) + 4 * ty + i % 4;
    const int row = i0 + rr;
    if (row >= N) continue;
    const float hi = hs[rr];
    float* o = out + (size_t)row * M;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int col = j0 + 64 * g + 4 * tx;
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = expf(acc[i][4 * g + j] - hi);
      if (vec_out && col + 3 < M) {
        *reinterpret_cast<float4*>(o + col) = make_float4(s[0], s[1], s[2],
                                                          s[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < M) o[col + j] = s[j];
      }
    }
  }
}

// the small variant: the whole call in one launch
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
kl_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int N, int M, int D, float shift) {
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                    // kDA x kLdA
  float* qs = ps + kDA * kLdA;         // 2 x kTK x kTM
  float* am = qs + 2 * kTK * kTM;
  float* as = am + kTN;
  float* ah = as + kTN;
  float* bm = ah + kTN;
  float* bl = bm + kTM;

  const int i0 = blockIdx.y * kTN, j0 = blockIdx.x * kTM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8;    // a warp: 4 thread rows x 8
  const int tx = (warp % 2) * 8 + lane % 8;    // thread columns
  // b staging: row r of the tile, float4 columns u0 .. u0 + kUnits - 1
  const int r = threadIdx.x % kTM;
  const int u0 = kUnits * (threadIdx.x / kTM);
  const int nk = (D + kTK - 1) / kTK;

  float4 v[kUnits];
  load_b<kVec>(b, j0 + r, M, D, 4 * u0, v);   // step 0, in flight
  stage_a(a, i0, N, D, 0, ps);                 // in flight
  b_rows(b, j0, M, D, bm, bl);
  cp_async_wait_all();
  __syncthreads();
  a_stats(a, i0, N, D, shift, ps, qs, am, as, ah);   // qs: scratch
  __syncthreads();
  const bool row_ok = j0 + r < M;
  const float rm = row_ok ? bm[r] : 0.f, rl = row_ok ? bl[r] : 0.f;
  store_b(v, qs, r, u0, row_ok, 0, D, rm, rl, shift);
  __syncthreads();

  // warps whose outputs all lie past N or M skip the product
  const bool active = i0 + 16 * (warp / 2) < N && j0 + 32 * (warp % 2) < M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt && kt % kSteps == 0) {        // D > kDA: the next chunk of p
      stage_a(a, i0, N, D, kt / kSteps, ps);
      cp_async_wait_all();
      __syncthreads();
      a_chunk(D, kt / kSteps, ps, am, as);
      __syncthreads();
    }
    const int k1 = (kt + 1) * kTK;
    if (kt + 1 < nk) load_b<kVec>(b, j0 + r, M, D, k1 + 4 * u0, v);
    if (active)
      mma_step<1, kLdA, kTM>(ps + (kt % kSteps) * kTK * kLdA,
                                    qs + (kt % 2) * kTK * kTM, ty, tx,
                                    acc);
    if (kt + 1 < nk)
      store_b(v, qs + ((kt + 1) % 2) * kTK * kTM, r, u0, row_ok, k1,
                  D, rm, rl, shift);
    __syncthreads();
  }

  store_s<1>(acc, ah, out, i0, j0, ty, tx, N, M);
}

// ---------------------------------------------------------------------------
// the split variant
// ---------------------------------------------------------------------------

constexpr int kSplitA = 128;         // the tile's rows of a
constexpr int kSplitB = 128;         // and of b
constexpr int kSplitThreads = 256;   // 8 x 8 outputs each
constexpr int kStages = 3;
constexpr int kBoxA = kTK * kSplitA, kBoxB = kTK * kSplitB;   // floats
constexpr int kStageBytes = 4 * (kBoxA + kBoxB);        // p's and logq's
constexpr int kSplitSmem = kStages * kStageBytes + 16 * kStages + 128;

// the first launch: one warp a row of a and of b (rows [0, N) are a's,
// [N, N + M) b's), the lanes striding over D and keeping their first
// kCache values in registers: max, sum and h as in the fused tile (a's h
// into h), p = exp(x - max) / sum or logq + log D = x - max - log(sum) +
// log D into a shared tile, which the block's 8 rows then leave k-major,
// 32 bytes a column: p into pt (D, ldn), logq into lqt (D, ldm). Columns
// from kDA on (D > kDA only) are recomputed from the row, kDA at a time.
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ pt, float* __restrict__ h,
                float* __restrict__ lqt, int N, int M, int D, int ldn,
                int ldm, float shift) {
  __shared__ float tile[kDA][kWarps + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kWarps, row = r0 + warp;
  const bool live = row < N + M, is_a = row < N;
  const float* x = is_a ? a + (size_t)row * D
                        : b + (size_t)min(row - N, M - 1) * D;
  float v[kCache], m = -INFINITY, s = 0.f, lse = 0.f;
  if (live) {                                  // uniform across the warp
#pragma unroll
    for (int t = 0; t < kCache; ++t) {
      v[t] = lane + 32 * t < D ? x[lane + 32 * t] : -INFINITY;
      m = fmaxf(m, v[t]);
    }
    for (int d = lane + kDA; d < D; d += 32) m = fmaxf(m, x[d]);
    m = warp_max(m);
    float e[kCache];
#pragma unroll
    for (int t = 0; t < kCache; ++t) {
      v[t] -= m;
      e[t] = expf(v[t]);
      if (lane + 32 * t < D) s += e[t];
    }
    for (int d = lane + kDA; d < D; d += 32) s += expf(x[d] - m);
    s = warp_sum(s);
    lse = logf(s);
    if (is_a) {
      float hh = 0.f;
#pragma unroll
      for (int t = 0; t < kCache; ++t) {
        const float pd = __fdiv_rn(e[t], s);
        if (lane + 32 * t < D) hh = fmaf(pd, (v[t] - lse) + shift, hh);
        tile[lane + 32 * t][warp] = pd;
      }
      for (int d = lane + kDA; d < D; d += 32) {
        const float sh = x[d] - m;
        hh = fmaf(__fdiv_rn(expf(sh), s), (sh - lse) + shift, hh);
      }
      hh = warp_sum(hh);
      if (lane == 0) h[row] = hh;
    } else {
#pragma unroll
      for (int t = 0; t < kCache; ++t)
        tile[lane + 32 * t][warp] = (v[t] - lse) + shift;
    }
  }
  for (int c0 = 0; c0 < D; c0 += kDA) {
    if (c0 && live) {                          // D > kDA: the next columns
#pragma unroll
      for (int t = 0; t < kCache; ++t) {
        const int d = c0 + lane + 32 * t;
        if (d < D) {
          const float sh = x[d] - m;
          tile[lane + 32 * t][warp] =
              is_a ? __fdiv_rn(expf(sh), s) : (sh - lse) + shift;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kWarps * kDA; e += kThreads) {
      const int d = e / kWarps, rr = e % kWarps, rw = r0 + rr;
      if (rw < N + M && c0 + d < D) {
        if (rw < N)
          pt[(size_t)(c0 + d) * ldn + rw] = tile[d][rr];
        else
          lqt[(size_t)(c0 + d) * ldm + rw - N] = tile[d][rr];
      }
    }
    __syncthreads();
  }
}

// stage kt of the k loop: p's box, then logq's, completing on bar
__device__ __forceinline__ void issue_stage(const CUtensorMap* ta,
                                            const CUtensorMap* tb,
                                            uint32_t dst, uint32_t bar, int i0,
                                            int j0, int kt) {
  mbar_expect_tx(bar, kStageBytes);
  tma_load(dst, ta, bar, i0, kt * kTK, 0);
  tma_load(dst + kBoxA * 4, tb, bar, j0, kt * kTK, 0);
}

// the second launch: 128 x 128 outputs a block, 8 x 8 a thread (two
// float4 halves 64 apart in rows and in columns: a warp's loads hit no
// bank twice), two blocks an SM (three of 128 x 64 ran slower); ta the map
// of pt (N columns, D rows), tb of lqt (M columns, D rows), boxes 128 x
// kTK, zeros past N, M and D; a ring of kStages stages completing on
// mbarriers, the warps releasing a stage on an "empty" mbarrier, thread 0
// refilling the stage of the step before the one it just left
__global__ void __launch_bounds__(kSplitThreads, 2)
split_tile_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const float* __restrict__ h, float* __restrict__ out,
                  int N, int M, int D) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float hs[kSplitA];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (128u - (raw & 127u)) & 127u;  // TMA: 128-byte dst
  const float* ring = reinterpret_cast<const float*>(smem_raw + pad);
  const uint32_t base = raw + pad;
  const uint32_t full = base + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const int row_tiles = (N + kSplitA - 1) / kSplitA;  // the row tiles of one
  const int i0 = (int)(blockIdx.x % row_tiles) * kSplitA;   // column slab
  const int j0 = (int)(blockIdx.x / row_tiles) * kSplitB;   // side by side
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8;    // a warp: 4 thread rows x 8
  const int tx = (warp % 2) * 8 + lane % 8;    // thread columns
  const int nk = (D + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kSplitThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kStages && st < nk; ++st)
      issue_stage(&ta, &tb, base + st * kStageBytes, full + 8 * st, i0, j0,
                  st);
  }
  for (int i = threadIdx.x; i < kSplitA; i += kSplitThreads)
    hs[i] = i0 + i < N ? h[i0 + i] : 0.f;
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full + 8 * st, (kt / kStages) & 1);
    const float* stage = ring + st * (kStageBytes / 4);
    mma_step<2, kSplitA, kSplitB>(stage, stage + kBoxA, ty, tx, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    const int old = kt - 1, next = old + kStages;
    if (threadIdx.x == 0 && old >= 0 && next < nk) {
      const int so = old % kStages;
      mbar_wait(empty + 8 * so, (old / kStages) & 1);
      issue_stage(&ta, &tb, base + so * kStageBytes, full + 8 * so, i0, j0,
                  next);
    }
  }
  store_s<2>(acc, hs, out, i0, j0, ty, tx, N, M);
}

template <bool kVec>
int launch_small(const float* a, const float* b, float* out, int N, int M,
                 int D, float shift, cudaStream_t s) {
  auto* kern = kl_kernel<kVec>;
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmallSmem))
    return (int)rc;
  const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN);
  kern<<<grid, kThreads, kSmallSmem, s>>>(a, b, out, N, M, D, shift);
  return (int)cudaGetLastError();
}

int launch_split(const float* a, const float* b, float* out, float* pt,
                 float* h, float* lqt, int N, int M, int D, int ldn, int ldm,
                 float shift, cudaStream_t s) {
  const int rows = N + M;
  row_pass_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      a, b, pt, h, lqt, N, M, D, ldn, ldm, shift);
  if (int err = (int)cudaGetLastError()) return err;
  CUtensorMap ta, tb;
  if (int rc = make_map_2d(&ta, pt, N, D, ldn, kSplitA, kTK)) return rc;
  if (int rc = make_map_2d(&tb, lqt, M, D, ldm, kSplitB, kTK)) return rc;
  if (cudaError_t rc = cudaFuncSetAttribute(
          split_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSplitSmem))
    return (int)rc;
  const long long tiles = (long long)((N + kSplitA - 1) / kSplitA) *
                          ((M + kSplitB - 1) / kSplitB);
  split_tile_kernel<<<(unsigned)tiles, kSplitThreads, kSplitSmem, s>>>(
      ta, tb, h, out, N, M, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (N, D), b: (M, D), out: (N, M), all fp32, contiguous, on the current
// device; shift is the fp32 log(D); variant (0 small, 1 split) and vec
// (the small tile loads b by float4: D % 4 == 0 and b 16-byte aligned) as
// _plan gives them; the split variant's scratch: pt (D, ldn) and lqt (D,
// ldm) k-major, ldn and ldm N and M rounded up to 4 (TMA strides are
// multiples of 16 bytes), h (N) (null and 0 for the small one). Returns
// cudaGetLastError() after the last launch (cudaErrorInvalidValue for a
// plan the operands do not allow).
extern "C" int repro_kl_similarity(const void* a, const void* b, void* out,
                                   void* pt, void* h, void* lqt, int N, int M,
                                   int D, int ldn, int ldm, float shift,
                                   int variant, int vec, void* stream) {
  if ((long long)N * M == 0) return 0;
  if (D < 1 || (N + 63) / 64 >= 65536 ||
      (variant == kSmall &&
       vec && (D % 4 || reinterpret_cast<uintptr_t>(b) % 16)) ||
      (variant == kSplit &&
       (!(pt && h && lqt) || ldn < N || ldm < M || ldn % 4 || ldm % 4)) ||
      (variant != kSmall && variant != kSplit))
    return (int)cudaErrorInvalidValue;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  float* fo = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kSmall)
    return vec ? launch_small<true>(fa, fb, fo, N, M, D, shift, s)
               : launch_small<false>(fa, fb, fo, N, M, D, shift, s);
  return launch_split(fa, fb, fo, (float*)pt, (float*)h, (float*)lqt, N, M,
                      D, ldn, ldm, shift, s);
}
