// Shared body of the three squared-distance kernels (pairwise_dist.cu,
// cluster_dist.cu and int8_dist.cu): for every client c, query row b and
// gallery row g,
//
//   kFp32:       out[c, b, g] = |q_b|^2 + |g_g|^2 - 2 (q_b . g_g)
//   kFp32Norms:  out[c, b, g] = |q_b|^2 + n2[c, g] - 2 (q_b . g_g)
//   kInt8:       out[c, b, g] = |q_b|^2 + n2[c, g] - 2 ((q_b . code_g) s[c, g])
//
// The whole (C, B, G) matrix is written, as the TPU kernels write it.
//
// Summation order, the same in both variants (so their outputs are equal
// bit for bit, and equal to the 64 x 64 tile this file held before the
// tile variant): every dot product, |q|^2 and |g|^2 is one sequential
// chain of IEEE fp32 fmaf over f = 0 .. F - 1 starting from +0 (no TF32,
// no tensor cores: near-ties in the ranking depend on full fp32 sums),
// and the epilogue rounds (|q|^2 + n2) - 2 (dot) (times s for int8 codes)
// with explicit __fadd_rn / __fmul_rn / __fsub_rn, the one rounding that
// any FMA contraction of the old expression gave (2 x is exact). Zero
// padding past F or past a row adds fmaf(0, 0, x) steps, which leave an
// output unchanged.
//
// Variants (chosen by _plan in pairwise_dist.py, one launch each):
//
//   tile    16-byte rows and bases (fp32 F % 4 == 0, int8 F % 16 == 0):
//           64 query x 128 gallery output tiles, 128 threads, each
//           holding the 8 x 8 outputs of query rows ty + 8 i and gallery
//           rows tx + 16 j (ty = tid / 16, tx = tid % 16) in registers.
//           Blocks are persistent, two an SM (at most 255 registers and
//           ~55 KB of shared memory each): block x walks tiles x, x +
//           grid, .. in steps of 32 features through a 2-stage ring, so
//           the next step's copy, even the next tile's first one, is in
//           flight under this step's FMAs and this tile's epilogue. Both
//           operands stage by 16-byte cp.async (zeros past B, G and F),
//           row-major with a pitch of 9 float4s: 8 rows read at one quad
//           fall on 8 bank quads, and a quarter-warp's query reads are one
//           broadcast. Per float4 of k a thread issues 16 LDS.128 and then
//           four rounds of 64 independent FFMAs, one for each component,
//           so no FMA waits on the one before it. int8 codes are copied as
//           bytes and widened once a stage into an fp32 buffer by byte
//           permutes and one exact fp32 subtraction (2^23 + u - (2^23 +
//           128) for u = code + 128) instead of I2F, which runs at an
//           eighth of the FMA rate. |q|^2 is chained once per query row of
//           a tile (threads 0-63), |g|^2 (kFp32) once per gallery row, from
//           the staged tiles; the given n2 and s are read once per row. The
//           epilogue stores each (i, j) as two 64-byte row segments a warp.
//           At F = 64 a tile is two steps, so the epilogue, the copies and
//           the barriers weigh on the FMAs: PERF.md has the measured split.
//   ragged  any other width or base: 64 x 64 tiles, 4 x 4 outputs a
//           thread, both operands staged k-major by scalar loads, |q|^2
//           (and |g|^2) in the product loop.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_dist {

enum Gallery { kFp32 = 0, kFp32Norms = 1, kInt8 = 2 };
enum Variant { kTile = 0, kRagged = 1 };

// ---------------------------------------------------------------------------
// the tile variant
// ---------------------------------------------------------------------------

constexpr int kVB = 64;               // query rows a tile
constexpr int kVG = 128;              // gallery rows a tile
constexpr int kVK = 32;               // features a stage
constexpr int kQuads = kVK / 4;       // float4 quads of a row a stage
constexpr int kPitch = kQuads + 1;    // float4 slots a staged row takes
constexpr int kRI = 8;                // query rows a thread: ty + 8 i
constexpr int kGJ = 8;                // gallery rows a thread: tx + kTX j
constexpr int kTX = kVG / kGJ;        // threads across a tile
constexpr int kVThreads = kVB / kRI * kTX;   // 128: a thread a gallery row
constexpr int kMinBlocks = 2;         // blocks an SM holds
static_assert(kVThreads == kVG && kVB <= kVThreads, "a thread a staged row");
constexpr int kQStage = kVB * kPitch * 16;    // bytes of a query stage
constexpr int kGStage = kVG * kPitch * 16;    // bytes of an fp32 gallery stage
constexpr int kCodeStage = kVG * kVK;         // bytes of an int8 code stage
constexpr int kCodeQuads = kVK / 16;          // 16-code pieces of a staged row

// shared memory of the tile (bytes): the query ring, then the fp32 gallery
// ring (fp32) or the code ring and one widened buffer (int8), then the
// per-row terms of a tile (|q|^2; n2 or |g|^2; s)
template <typename GT>
constexpr int kRingBytes =
    2 * kQStage + (sizeof(GT) == 1 ? 2 * kCodeStage + kGStage : 2 * kGStage);
template <typename GT>
constexpr int kTileSmem = kRingBytes<GT> + 4 * (kVB + 2 * kVG);

// float4 slot of quad `quad` of row `row` in a stage: rows 9 slots apart,
// so 8 rows read at one quad fall on 8 different bank quads
__device__ __forceinline__ int slot(int row, int quad) {
  return row * kPitch + quad;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// four int8 codes (a little-endian word) -> four exact fp32 values
__device__ __forceinline__ float4 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;           // each byte: code + 128
  const float bias = 8388736.0f;                // 2^23 + 128
  return make_float4(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)), bias));
}

// the output tile of flat index t: gallery tiles fastest, then query tiles,
// then clients
struct Tile {
  int c, b0, g0;
};
__device__ __forceinline__ Tile tile_at(int t, int B, int G) {
  const int tg = (G + kVG - 1) / kVG, tb = (B + kVB - 1) / kVB;
  return {t / (tg * tb), (t / tg) % tb * kVB, t % tg * kVG};
}

// stage kt of tile tl: the query tile into qst, the gallery tile (fp32
// rows, or int8 codes kept as bytes in copy order) into gst
template <typename GT>
__device__ __forceinline__ void issue_stage(const float* __restrict__ q,
                                            const GT* __restrict__ g,
                                            uint32_t qst, uint32_t gst,
                                            Tile tl, int kt, int B, int G,
                                            int F) {
  const int tid = threadIdx.x;
  const int f0 = kt * kVK;
  const float* qc = q + (size_t)tl.c * B * F;
  const GT* gc = g + (size_t)tl.c * G * F;
#pragma unroll
  for (int r = 0; r < kVB * kQuads / kVThreads; ++r) {
    const int e = tid + r * kVThreads, row = e / kQuads, quad = e % kQuads;
    const bool ok = tl.b0 + row < B && f0 + 4 * quad < F;
    cp_async16(qst + 16 * slot(row, quad),
               ok ? qc + (size_t)(tl.b0 + row) * F + f0 + 4 * quad : q, ok);
  }
  if (sizeof(GT) == 1) {
    // a row's kVK codes as 16-byte pieces
#pragma unroll
    for (int r = 0; r < kVG * kCodeQuads / kVThreads; ++r) {
      const int e = tid + r * kVThreads, row = e / kCodeQuads;
      const int piece = e % kCodeQuads;
      const bool ok = tl.g0 + row < G && f0 + 16 * piece < F;
      cp_async16(gst + 16 * e,
                 ok ? gc + (size_t)(tl.g0 + row) * F + f0 + 16 * piece : g,
                 ok);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kVG * kQuads / kVThreads; ++r) {
      const int e = tid + r * kVThreads, row = e / kQuads, quad = e % kQuads;
      const bool ok = tl.g0 + row < G && f0 + 4 * quad < F;
      cp_async16(gst + 16 * slot(row, quad),
                 ok ? gc + (size_t)(tl.g0 + row) * F + f0 + 4 * quad : g, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a stage's codes (copy order) -> the fp32 gallery buffer
__device__ __forceinline__ void widen_stage(const uint4* __restrict__ codes,
                                            float4* __restrict__ gw) {
#pragma unroll
  for (int r = 0; r < kVG * kCodeQuads / kVThreads; ++r) {
    const int e = threadIdx.x + r * kVThreads, row = e / kCodeQuads;
    const int piece = e % kCodeQuads;
    const uint4 w = codes[e];
    gw[slot(row, 4 * piece + 0)] = widen4(w.x);
    gw[slot(row, 4 * piece + 1)] = widen4(w.y);
    gw[slot(row, 4 * piece + 2)] = widen4(w.z);
    gw[slot(row, 4 * piece + 3)] = widen4(w.w);
  }
}

// a row's squared norm over one stage, continuing the chain `part`
__device__ __forceinline__ float row_norm(const float4* __restrict__ st,
                                          int row, float part) {
#pragma unroll
  for (int kq = 0; kq < kQuads; ++kq) {
    const float4 v = st[slot(row, kq)];
    part = fmaf(v.x, v.x, part);
    part = fmaf(v.y, v.y, part);
    part = fmaf(v.z, v.z, part);
    part = fmaf(v.w, v.w, part);
  }
  return part;
}

// acc[i][j] += a[i].c v[j].c over the thread's 8 x 8 block, component c
#define REPRO_DIST_STEP(c)                                         \
  _Pragma("unroll") for (int i = 0; i < kRI; ++i)                  \
    _Pragma("unroll") for (int j = 0; j < kGJ; ++j)                \
      acc[i][j] = fmaf(a[i].c, v[j].c, acc[i][j]);

// one stage's products into the thread's 8 x 8 block, k in order: per
// float4 of k, 64 independent FMAs for each of its four components (two
// float4s unrolled: full unrolling ran no faster on the card)
__device__ __forceinline__ void product(const float4* __restrict__ qs,
                                        const float4* __restrict__ gs,
                                        int ty, int tx,
                                        float (&acc)[kRI][kGJ]) {
#pragma unroll 2
  for (int kq = 0; kq < kQuads; ++kq) {
    float4 a[kRI], v[kGJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) a[i] = qs[slot(ty + 8 * i, kq)];
#pragma unroll
    for (int j = 0; j < kGJ; ++j) v[j] = gs[slot(tx + kTX * j, kq)];
    REPRO_DIST_STEP(x)
    REPRO_DIST_STEP(y)
    REPRO_DIST_STEP(z)
    REPRO_DIST_STEP(w)
  }
}
#undef REPRO_DIST_STEP

// A persistent block: tiles blockIdx.x, blockIdx.x + gridDim.x, .., each
// ceil(F / kVK) steps, walked as one sequence through the 2-stage ring, so
// the next tile's first stage is in flight under this tile's last products
// and its epilogue, and this tile's stores under the next one's products.
template <typename GT, int kMode>
__global__ void __launch_bounds__(kVThreads, kMinBlocks)
dist_tile_kernel(const float* __restrict__ q, const GT* __restrict__ g,
                 const float* __restrict__ gscale,
                 const float* __restrict__ gn2, float* __restrict__ out,
                 int C, int B, int G, int F) {
  constexpr bool kCodes = sizeof(GT) == 1;
  extern __shared__ __align__(128) uint8_t smem[];
  float* qn = reinterpret_cast<float*>(smem + kRingBytes<GT>);
  float* gn = qn + kVB;                 // n2 given, or |g|^2 (kFp32)
  float* gsc = gn + kVG;                // int8 row scales
  float4* gw = reinterpret_cast<float4*>(smem + 2 * kQStage +
                                         2 * kCodeStage);
  const uint32_t base = smem_addr(smem);
  const uint32_t gring = base + 2 * kQStage;
  const int gstage = kCodes ? kCodeStage : kGStage;

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int ntiles = C * ((B + kVB - 1) / kVB) * ((G + kVG - 1) / kVG);
  const int nk = (F + kVK - 1) / kVK;
  const int steps = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nk;
  if (steps <= 0) return;

  float acc[kRI][kGJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kGJ; ++j) acc[i][j] = 0.f;
  // the chains of |q|^2 and |g|^2 of row tid, and the given terms of row tid
  float qpart = 0.f, gpart = 0.f, n2_in = 0.f, s_in = 1.f;

  Tile tl = tile_at(blockIdx.x, B, G);
  issue_stage(q, g, base, gring, tl, 0, B, G, F);
  for (int st = 0; st < steps; ++st) {
    const int s = st & 1, kt = st % nk;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();          // stage st landed; stage st - 1 is free
    if (st + 1 < steps) {     // the next step, maybe of the next tile
      const int kn = (st + 1) % nk;
      const Tile tn = kn ? tl
          : tile_at(blockIdx.x + (st + 1) / nk * gridDim.x, B, G);
      issue_stage(q, g, base + (s ^ 1) * kQStage, gring + (s ^ 1) * gstage,
                  tn, kn, B, G, F);
    }
    if (kMode != kFp32 && kt == 0) {    // the given terms, used at the end
      const int gi = tl.g0 + tid;
      n2_in = gi < G ? gn2[(size_t)tl.c * G + gi] : 0.f;
      if (kMode == kInt8) s_in = gi < G ? gscale[(size_t)tl.c * G + gi] : 1.f;
    }
    const float4* qs = reinterpret_cast<const float4*>(smem + s * kQStage);
    const float4* gs;
    if (kCodes) {
      widen_stage(reinterpret_cast<const uint4*>(smem + 2 * kQStage +
                                                 s * kCodeStage), gw);
      __syncthreads();
      gs = gw;
    } else {
      gs = reinterpret_cast<const float4*>(smem + 2 * kQStage + s * kGStage);
    }
    if (tid < kVB) qpart = row_norm(qs, tid, qpart);
    if (kMode == kFp32) gpart = row_norm(gs, tid, gpart);
    product(qs, gs, ty, tx, acc);
    if (kt != nk - 1) continue;

    // the tile's epilogue
    if (tid < kVB) qn[tid] = qpart;
    gn[tid] = kMode == kFp32 ? gpart : n2_in;
    gsc[tid] = s_in;
    __syncthreads();
    float n2[kGJ], sc[kGJ];
#pragma unroll
    for (int j = 0; j < kGJ; ++j) {
      n2[j] = gn[tx + kTX * j];
      sc[j] = gsc[tx + kTX * j];
    }
    float* oc = out + (size_t)tl.c * B * G;
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int b = tl.b0 + ty + 8 * i;
      const float qq = qn[ty + 8 * i];
      float* row = oc + (size_t)b * G;
#pragma unroll
      for (int j = 0; j < kGJ; ++j) {
        const int gi = tl.g0 + tx + kTX * j;
        const float dot = kMode == kInt8 ? __fmul_rn(acc[i][j], sc[j])
                                         : acc[i][j];
        if (b < B && gi < G)
          row[gi] = __fsub_rn(__fadd_rn(qq, n2[j]), __fmul_rn(2.f, dot));
        acc[i][j] = 0.f;
      }
    }
    qpart = gpart = 0.f;
    tl = tile_at(blockIdx.x + (st + 1) / nk * gridDim.x, B, G);
  }
}

// ---------------------------------------------------------------------------
// the ragged variant
// ---------------------------------------------------------------------------

// Grid: (ceil(G / kTG), ceil(B / kTB), C). A block of 256 threads owns a
// kTB x kTG output tile; thread (ty, tx) of the 16 x 16 layout owns the 4 x 4
// register block of query rows ty*4.. and gallery rows tx*4... The feature
// axis is walked in steps of kTK columns: each step stages the q tile and the
// g tile (int8 codes widened to fp32 here) in shared memory, k-major so that
// a thread reads its 4 query values and its 4 gallery values as one float4
// each. |q|^2, and for kFp32 |g|^2, are reduced from the same staged tiles;
// kFp32Norms and kInt8 read the given norms n2. The ragged B and G edges are
// masked in the loads and the stores; the wrapper pads nothing. The
// epilogue writes each thread's 4 consecutive outputs of a row as one
// float4 when G % 4 == 0 (every row then starts 16-byte aligned).
constexpr int kTB = 64;       // query rows per block
constexpr int kTG = 64;       // gallery rows per block
constexpr int kTK = 32;       // feature columns staged per step
constexpr int kPad = 4;       // row padding that keeps float4 alignment
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

template <typename GT, int kMode>
__global__ void __launch_bounds__(kThreads)
dist_ragged_kernel(const float* __restrict__ q, const GT* __restrict__ g,
                   const float* __restrict__ gscale,
                   const float* __restrict__ gn2, float* __restrict__ out,
                   int B, int G, int F) {
  __shared__ __align__(16) float qs[kTK][kTB + kPad];
  __shared__ __align__(16) float gs[kTK][kTG + kPad];

  const int c = blockIdx.z;
  const int b0 = blockIdx.y * kTB;
  const int g0 = blockIdx.x * kTG;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* qc = q + (size_t)c * B * F;
  const GT* gc = g + (size_t)c * G * F;

  float acc[4][4];
  float qq[4], gg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qq[i] = 0.f;
    gg[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < F; k0 += kTK) {
    // neighbouring threads read neighbouring feature columns of one row
    for (int e = tid; e < kTB * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int b = b0 + r, f = k0 + k;
      qs[k][r] = (b < B && f < F) ? qc[(size_t)b * F + f] : 0.f;
    }
    for (int e = tid; e < kTG * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int gi = g0 + r, f = k0 + k;
      gs[k][r] = (gi < G && f < F) ? widen(gc[(size_t)gi * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float v[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = fmaf(a[i], a[i], qq[i]);
        if (kMode == kFp32) gg[i] = fmaf(v[i], v[i], gg[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // per-column terms: |g|^2 and, for int8 codes, the row scale
  float n2[4], s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gi = g0 + tx * 4 + j;
    const bool in = gi < G;
    n2[j] = kMode == kFp32 ? gg[j] : (in ? gn2[(size_t)c * G + gi] : 0.f);
    s[j] = kMode == kInt8 && in ? gscale[(size_t)c * G + gi] : 1.f;
  }

  float* oc = out + (size_t)c * B * G;
  const int gcol = g0 + tx * 4;
  const bool vec = (G % 4 == 0) && (gcol + 3 < G);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) break;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dot = kMode == kInt8 ? __fmul_rn(acc[i][j], s[j])
                                       : acc[i][j];
      r[j] = __fsub_rn(__fadd_rn(qq[i], n2[j]), __fmul_rn(2.f, dot));
    }
    float* row = oc + (size_t)b * G + gcol;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gcol + j < G) row[j] = r[j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename GT, int kMode>
int launch_dist(const float* q, const GT* g, const float* gscale,
                const float* gn2, float* out, int C, int B, int G, int F,
                int variant, cudaStream_t stream) {
  if ((long long)C * B * G == 0) return 0;
  if (variant == kTile) {
    // the tile's 16-byte copies need 16-byte rows and bases; _plan sends
    // everything else to the ragged variant
    const int row_bytes = F * (int)sizeof(GT);
    if (F < 1 || row_bytes % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
        reinterpret_cast<uintptr_t>(g) % 16 || F % 4)
      return (int)cudaErrorInvalidValue;
    constexpr int bytes = kTileSmem<GT>;
    static int slots[64] = {};    // resident blocks a device, by ordinal
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess || dev >= 64) return (int)cudaErrorInvalidValue;
    if (!slots[dev]) {            // above 48 KB only once opted in
      int sms = 0, per_sm = 0;
      rc = cudaFuncSetAttribute(dist_tile_kernel<GT, kMode>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
      if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
      if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dist_tile_kernel<GT, kMode>, kVThreads, bytes);
      if (rc != cudaSuccess) return (int)rc;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      slots[dev] = sms * per_sm;
    }
    const long long tiles = (long long)C * ((B + kVB - 1) / kVB) *
                            ((G + kVG - 1) / kVG);
    if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const int grid = (int)(tiles < slots[dev] ? tiles : slots[dev]);
    dist_tile_kernel<GT, kMode><<<grid, kVThreads, bytes, stream>>>(
        q, g, gscale, gn2, out, C, B, G, F);
  } else if (variant == kRagged) {
    const dim3 grid((G + kTG - 1) / kTG, (B + kTB - 1) / kTB, C);
    dist_ragged_kernel<GT, kMode><<<grid, kThreads, 0, stream>>>(
        q, g, gscale, gn2, out, B, G, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_dist
