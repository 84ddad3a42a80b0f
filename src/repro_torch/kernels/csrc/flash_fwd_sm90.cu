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
// boundary tiles only; the heaviest causal q tiles launch first. No
// --use_fast_math: exp2f and logf are the accurate ones.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                    // q rows a block
constexpr int kBK = 128;                    // kv rows a tile
constexpr int kStages = 2;                  // K and V ring depth
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Dims {
  int B, Hq, Hkv, Sq, Sk, causal, window;
  float scale;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// the box of `map` at (x, y, z) -> shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of r across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) B^T; A and B K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) B, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 pairs in registers) B, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


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

// (p0, p1) -> the bf16 pairs hi = bf16(p) and lo = bf16(p - hi), low
// half the first
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      p0 - __low2float(h), p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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
      wgmma_wait_all();
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
      wgmma_wait_all();
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda); null where the driver has none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 3-D map (hd, S, heads) of a contiguous bf16 (heads, S, hd) array,
// boxes of 64 columns x rows x 1 head, 128-byte swizzle, zeros past S
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
             int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
