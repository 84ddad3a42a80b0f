// The wire codec's grouped top-k sparsify and index bit-packing. The
// codec's path takes two launches a sparse payload, each folding two or
// three Pallas TPU kernels of src/repro/kernels/:
//
//   batched_topk_encode    topk_pack.py: batched_topk_pack, then
//       batched_idx_bitpack
//       (C, P) fp32 -> values (C, nb*kg) fp32 + bit-planes (C, bits *
//       ceil(nb*kg/8)) uint8, with no int32 index tensor in between.
//   batched_topk_decode    batched_idx_bitunpack, then batched_topk_unpack
//       values + bit-planes -> dense (C, p) fp32.
//   batched_topk_decode_int8
//       src/repro/kernels/quantize.py:batched_dequantize, then the decode:
//       int8 codes (C, nb*kg) + chunk scales (C, ceil(nb*kg / chunk)) fp32
//       + bit-planes -> dense (C, p) fp32, each value
//       __fmul_rn((float)code, its chunk's scale) in the decode's prologue,
//       with no fp32 value tensor in between (the topk+int8 codec's path).
//
// Four one-stage kernels stay beside them, each replacing one of those
// Pallas kernels on its own (no main-path caller):
//
//   batched_topk_pack      src/repro/kernels/topk_pack.py:batched_topk_pack
//       (C, P) fp32 -> values (C, nb*kg) fp32 + absolute indices (C, nb*kg)
//       int32, nb = ceil(P / G): every group of G contiguous elements keeps
//       its kg largest magnitudes, in rank order.
//   batched_topk_unpack    src/repro/kernels/topk_pack.py:batched_topk_unpack
//       values + indices (C, nb*kg) -> dense (C, p) fp32.
//   batched_idx_bitpack    src/repro/kernels/topk_pack.py:batched_idx_bitpack
//       (C, K) int32 -> (C, bits*ceil(K/8)) uint8 bit-planes of the local
//       in-group index (bits = 3 at G = 8).
//   batched_idx_bitunpack  src/repro/kernels/topk_pack.py:batched_idx_bitunpack
//       the inverse, (C, bits*kb) uint8 -> (C, k) int32 absolute indices.
//
// What bounds them on an H100: bytes. Each moves its inputs and outputs once
// and does an 8x8 compare or a few shifts per element, far below the card's
// operations-per-byte balance. At the round's C = 5 a launch is ~6 us
// against a bound under 0.4 us: launch latency, which only folding two
// launches into one removes (encode, decode). At the fleet's C = 1000 the
// encode's ranking (G x G compares a group) also takes a share of the
// issue slots the loads need.
//
// Design of encode and decode: a block owns 256 * per consecutive groups of
// one row (per = 1 or 2, kernels/topk_pack.py:_plan: 2 past a small grid,
// for twice the bytes in flight), so its first slot falls on a byte of
// every plane; the plane bytes are built (encode) and read (decode) in
// shared memory, the values staged there and moved in 16-byte vectors (see
// topk_encode_kernel and topk_decode_kernel).
//
// Design of the one-stage kernels: one thread per group (pack, unpack) or
// per packed byte position, eight slots (bitpack, bitunpack). A group's G
// inputs sit in registers; neighbouring
// threads read and write neighbouring addresses, so a warp's accesses fall
// in a few contiguous lines. The TPU kernels tile P into 2048-element
// blocks and pad P to a tile multiple; here each thread masks the ragged
// row end itself, and the tail group reads zeros past P as the reference's
// padding does. At G = 8 the pack reads its group, and the unpack writes
// it, as two 16-byte vectors (the bit-unpack its eight slots likewise)
// where the row stride keeps them aligned
// (P % 4 == 0 and an aligned base; the wrapper decides), scalar accesses
// otherwise. Thread and slot indices are 32-bit (the wrapper refuses
// 2^31 threads or more): the row and slot divisions are the kernels' only
// arithmetic beyond the compares, and a 64-bit division costs several
// times a 32-bit one.
//
// Semantics mirror the reference's arithmetic, not only its result: ranks
// count the j with |x_j| > |x_i| or (|x_j| == |x_i| and j < i), and each
// output slot is the one-hot sum over the group, value_r = sum_i x_i *
// [rank_i == r] and index_r = sum_i (g*G + i) * [rank_i == r], in IEEE
// products and sums (no contraction into FMAs). For finite inputs this is
// the direct selection; a NaN or an infinity spreads through x * 0 across
// the group exactly as it does in the reference. The unpack sums
// value_s * [li_s == l] over the kg slots in slot order, so an out-of-range
// local index adds nothing and duplicates sum. The bit kernels use int32
// shifts and masks like the reference, so a malformed index packs the same
// bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 16;

// A group's G inputs from row xr into registers: two 16-byte vectors at
// G = 8 (G / 4 of them at any G that is a multiple of 4) where vec says the
// row keeps them aligned, scalar loads otherwise; zeros past P, as the
// reference's padding.
template <int G>
__device__ __forceinline__ void load_group(const float* __restrict__ xr,
                                           unsigned base, unsigned P,
                                           bool vec, float (&v)[G]) {
  if constexpr (G % 4 == 0) {
    if (vec && base + G <= P) {
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(xr + base + 4 * q);
        v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = base + i < P ? xr[base + i] : 0.f;
}

// rank[i] = #{j : |v_j| > |v_i| or (|v_j| == |v_i| and j < i)}.
template <int G>
__device__ __forceinline__ void rank_group(const float (&v)[G],
                                           int (&rank)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float ai = fabsf(v[i]);
    int r = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float aj = fabsf(v[j]);
      r += (aj > ai || (aj == ai && j < i)) ? 1 : 0;
    }
    rank[i] = r;
  }
}

// Slot s's one-hot sums: value = sum_i v_i * [rank_i == s] in IEEE
// products and sums, index = sum_i (base + i) * [rank_i == s] (wrapping
// 32-bit, as the reference's int32 sum).
template <int G>
__device__ __forceinline__ void onehot_slot(const float (&v)[G],
                                            const int (&rank)[G], int s,
                                            unsigned base, float& value,
                                            unsigned& index) {
  float acc = 0.f;
  unsigned ia = 0;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const bool hit = rank[i] == s;
    acc = __fadd_rn(acc, __fmul_rn(v[i], hit ? 1.f : 0.f));
    ia += hit ? base + i : 0u;
  }
  value = acc;
  index = ia;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
topk_pack_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, unsigned P, unsigned nb, int kg,
                 unsigned n_groups, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_groups) return;
  const unsigned c = t / nb;
  const unsigned base = (t - c * nb) * G;
  float v[G];
  load_group<G>(x + (size_t)c * P, base, P, vec, v);
  int rank[G];
  rank_group<G>(v, rank);

  float* vo = vals + (size_t)t * kg;
  int* io = idx + (size_t)t * kg;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s < kg) {
      float value;
      unsigned index;
      onehot_slot<G>(v, rank, s, base, value, index);
      vo[s] = value;
      io[s] = (int)index;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
topk_unpack_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   float* __restrict__ out, unsigned p, unsigned nb, int kg,
                   unsigned n_groups, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_groups) return;
  const unsigned c = t / nb;
  const unsigned base = (t - c * nb) * G;
  const float* vr = vals + (size_t)t * kg;
  const int* ir = idx + (size_t)t * kg;

  float acc[G];
#pragma unroll
  for (int l = 0; l < G; ++l) acc[l] = 0.f;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s < kg) {
      const float v = vr[s];
      const int li = ir[s] - (int)base;
#pragma unroll
      for (int l = 0; l < G; ++l)
        acc[l] = __fadd_rn(acc[l], __fmul_rn(v, li == l ? 1.f : 0.f));
    }
  }
  float* orow = out + (size_t)c * p;
  if constexpr (G == 8) {
    if (vec && base + G <= p) {
      *reinterpret_cast<float4*>(orow + base) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(orow + base + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < G; ++l)
    if (base + l < p) orow[base + l] = acc[l];
}

// One thread per (client, byte b): slots 8b..8b+7 of every plane.
__global__ void __launch_bounds__(kThreads)
idx_bitpack_kernel(const int* __restrict__ idx, uint8_t* __restrict__ out,
                   unsigned K, unsigned kb, int group, unsigned kg, int bits,
                   unsigned n_bytes) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_bytes) return;
  const unsigned c = t / kb;
  const unsigned b = t - c * kb;
  const int* ir = idx + (size_t)c * K;
  int li[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const unsigned s = b * 8 + l;
    li[l] = s < K ? ir[s] - (int)(s / kg) * group : 0;
  }
  uint8_t* orow = out + (size_t)c * bits * kb;
  for (int j = 0; j < bits; ++j) {
    int byte = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) byte |= ((li[l] >> j) & 1) << l;
    orow[(size_t)j * kb + b] = (uint8_t)byte;
  }
}

// One thread per (client, byte b): slots 8b..8b+7, each plane's byte read
// once; the group of slot s advances every kg slots, so no division per
// slot.
__global__ void __launch_bounds__(kThreads)
idx_bitunpack_kernel(const uint8_t* __restrict__ packed, int* __restrict__ out,
                     unsigned k, unsigned kb, int group, unsigned kg, int bits,
                     unsigned n_bytes, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_bytes) return;
  const unsigned c = t / kb;
  const unsigned b = t - c * kb;
  const uint8_t* prow = packed + (size_t)c * bits * kb + b;
  int li[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) li[l] = 0;
  for (int j = 0; j < bits; ++j) {
    const int byte = prow[(size_t)j * kb];
#pragma unroll
    for (int l = 0; l < 8; ++l) li[l] += ((byte >> l) & 1) << j;
  }
  const unsigned s0 = b * 8;
  unsigned gq = s0 / kg;
  unsigned gr = s0 - gq * kg;
  int v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    v[l] = (int)gq * group + li[l];
    if (++gr == kg) {
      gr = 0;
      ++gq;
    }
  }
  int* orow = out + (size_t)c * k;
  if (vec && s0 + 8 <= k) {
    *reinterpret_cast<int4*>(orow + s0) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(orow + s0 + 4) = make_int4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 8; ++l)
    if (s0 + l < k) orow[s0 + l] = v[l];
}

// ---------------------------------------------------------------------------
// encode (pack + bit-pack) and decode (bit-unpack + unpack): one launch each
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int bits_of(int g) {
  int b = 0;
  while ((1 << b) < g) ++b;
  return b;
}

// The scalar head of an n-float span of device memory at gm: the floats
// before its first 16-byte boundary (gm is 4-byte aligned).
__device__ __forceinline__ unsigned span_head(const float* gm, unsigned n) {
  return min(n, (unsigned)((16u - ((uintptr_t)gm & 15u)) & 15u) >> 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// The line holding p into L1 (the group is loaded from there later).
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// n floats from device memory into a block's 16-byte aligned shared buffer
// by cp.async, so a thread's copies are all in flight at once: element i
// lands at sm[off + i], off = gm's float offset within its 16-byte line,
// so the body between a scalar head and tail moves in 16-byte copies
// aligned on both sides. Returns off; waits for this thread's copies (the
// caller's barrier makes them the block's).
__device__ __forceinline__ unsigned stage_in(float* __restrict__ sm,
                                             const float* __restrict__ gm,
                                             unsigned n) {
  const unsigned off = (unsigned)((uintptr_t)gm >> 2) & 3u;
  const unsigned head = min(n, (4u - off) & 3u);
  const unsigned nv = (n - head) >> 2;
  for (unsigned i = threadIdx.x; i < head; i += kThreads)
    cp_async4(sm + off + i, gm + i);
  for (unsigned i = threadIdx.x; i < nv; i += kThreads)
    cp_async16(sm + off + head + 4 * i, gm + head + 4 * i);
  for (unsigned i = head + 4 * nv + threadIdx.x; i < n; i += kThreads)
    cp_async4(sm + off + i, gm + i);
  cp_async_wait_all();
  return off;
}

// The int8 decode's prologue: a tile's n codes q (slots j0, j0 + 1, ... of
// a row whose chunk scales are sc) into a block's 16-byte aligned shared
// buffer as __fmul_rn((float)code, sc[slot / chunk]), dequantize_kernel's
// single IEEE product (no FMA, no reciprocal). Element i lands at sm[off +
// i], off = q's offset within its 4-byte word, so the codes between a
// scalar head (up to q's next 16-byte boundary) and tail are read as
// 16-byte vectors and their values stored as four float4. A vector walks
// its chunk index without a division a code (a scale reload where it
// crosses a chunk, a hit in the line just read at chunk 256); any chunk >=
// 1. Returns off; the caller's barrier makes the values the block's. Out
// of line: one copy for every group size, and no register of it is held
// in the decode (a kernel of 32 registers, as the fp32 decode's).
__device__ __noinline__ unsigned dequant_in(float* __restrict__ sm,
                                            const int8_t* __restrict__ q,
                                            const float* __restrict__ sc,
                                            unsigned j0, unsigned chunk,
                                            unsigned n) {
  const unsigned off = (unsigned)(uintptr_t)q & 3u;
  const unsigned head =
      min(n, (unsigned)((16u - ((uintptr_t)q & 15u)) & 15u));
  const unsigned nv = (n - head) >> 4;
  for (unsigned i = threadIdx.x; i < head; i += kThreads)
    sm[off + i] = __fmul_rn((float)q[i], sc[(j0 + i) / chunk]);
  for (unsigned v = threadIdx.x; v < nv; v += kThreads) {
    const unsigned i = head + 16 * v;
    const uint4 w = *reinterpret_cast<const uint4*>(q + i);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned ci = (j0 + i) / chunk;
    unsigned r = j0 + i - ci * chunk;
    float s = sc[ci];
    float f[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (r == chunk) {
        r = 0;
        s = sc[++ci];
      }
      ++r;
      const float code = (float)(int8_t)(words[e >> 2] >> (8 * (e & 3)));
      f[e] = __fmul_rn(code, s);
    }
    float4* d = reinterpret_cast<float4*>(sm + off + i);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      d[t] = make_float4(f[4 * t], f[4 * t + 1], f[4 * t + 2], f[4 * t + 3]);
  }
  for (unsigned i = head + 16 * nv + threadIdx.x; i < n; i += kThreads)
    sm[off + i] = __fmul_rn((float)q[i], sc[(j0 + i) / chunk]);
  return off;
}

// The 128-byte lines of dequant_in's codes (a line a thread) and of its
// first and last scale into L1 before the plane bytes are staged, so the
// two round trips overlap, with no register held across the staging.
__device__ __forceinline__ void prefetch_int8(const int8_t* q,
                                              const float* sc, unsigned j0,
                                              unsigned chunk, unsigned n) {
  for (unsigned i = 128 * threadIdx.x; i < n + 127; i += 128 * kThreads)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(q + min(i, n - 1)));
  if (threadIdx.x < 2)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
        sc + (j0 + threadIdx.x * (n - 1)) / chunk));
}

// n floats of a shared buffer to device memory: 16-byte stores between a
// scalar head and tail (the shared side read as four words where the head
// leaves it off 16 bytes). Stores do not hold the thread, so a plain loop
// keeps them all in flight.
__device__ __forceinline__ void stage_out(float* __restrict__ gm,
                                          const float* __restrict__ sm,
                                          unsigned n) {
  const unsigned head = span_head(gm, n);
  const unsigned nv = (n - head) >> 2;
  float4* g4 = reinterpret_cast<float4*>(gm + head);
  for (unsigned i = threadIdx.x; i < head; i += kThreads) gm[i] = sm[i];
  if (head == 0) {
    for (unsigned i = threadIdx.x; i < nv; i += kThreads)
      g4[i] = reinterpret_cast<const float4*>(sm)[i];
  } else {
    for (unsigned i = threadIdx.x; i < nv; i += kThreads) {
      const float* s = sm + head + 4 * i;
      g4[i] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  for (unsigned i = head + 4 * nv + threadIdx.x; i < n; i += kThreads)
    gm[i] = sm[i];
}

// One group's selection into a block's shared buffers: its kg values at
// svt and the low bytes of their local indices (ia - base; bits < 8 of the
// int32 local index, all a plane takes) at slt, slot order.
//
// A group whose inputs are all finite takes a shortcut with the same
// bits: its ranks are a permutation, so slot r's one-hot sum has a single
// term that is not a signed zero and comes out as v_i + 0 (+0 for a zero
// of either sign), its index as base + i; the thread writes them at slot
// rank_i for each rank_i < kg. A group holding a NaN or an infinity
// spreads x * 0 across its slots and takes the full one-hot sums.
//
// The full sums run out of line, one copy per G, reloading the group (an
// L1 or L2 hit) rather than taking the registers' values by address: the
// path no finite row takes costs the kernel's body no stack, registers or
// unrolled code.
template <int G>
__device__ __noinline__ void select_nonfinite(const float* __restrict__ xr,
                                              unsigned base, unsigned P,
                                              bool vec, int kg, float* svt,
                                              uint8_t* slt) {
  float v[G];
  load_group<G>(xr, base, P, vec, v);
  int rank[G];
  rank_group<G>(v, rank);
#pragma unroll 1
  for (int s = 0; s < kg; ++s) {
    unsigned index;
    onehot_slot<G>(v, rank, s, base, svt[s], index);
    slt[s] = (uint8_t)(index - base);
  }
}

template <int G>
__device__ __forceinline__ void select_group(const float (&v)[G],
                                             const float* __restrict__ xr,
                                             unsigned base, unsigned P,
                                             bool vec, int kg, float* svt,
                                             uint8_t* slt) {
  bool finite = true;
#pragma unroll
  for (int i = 0; i < G; ++i)
    finite = finite && (__float_as_uint(v[i]) & 0x7fffffffu) < 0x7f800000u;
  if (!finite) {
    select_nonfinite<G>(xr, base, P, vec, kg, svt, slt);
    return;
  }
  int rank[G];
  rank_group<G>(v, rank);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (rank[i] < kg) {
      svt[rank[i]] = __fadd_rn(v[i], 0.f);
      slt[rank[i]] = (uint8_t)i;
    }
  }
}

// Encode and decode blocks hold per = 1 or kMaxPer groups a thread (the
// launch's choice, kernels/topk_pack.py:_plan); the shared buffers are
// sized for kMaxPer, 40 KB of static shared memory for the encode at G = 16.
constexpr int kMaxPer = 2;

// Grid (tiles, C); a block's tile is kThreads * per groups of one row,
// thread t holding groups t, t + kThreads, ... of it. Each thread first
// prefetches its later groups into L1 (per groups' bytes in flight), then
// loads and ranks each in turn as topk_pack_kernel does (select_group; one
// copy of the ranking code whatever per is); after the barrier the block
// stores its values with stage_out and builds each plane's bytes of its
// slots from shared memory, byte b from slots 8b..8b+7 at bit s % 8, as
// idx_bitpack_kernel does. No int32 index leaves the block.
template <int G>
__global__ void __launch_bounds__(kThreads)
topk_encode_kernel(const float* __restrict__ x, float* __restrict__ vals,
                   uint8_t* __restrict__ planes, unsigned P, unsigned nb,
                   int kg, unsigned kb, int per, bool vec) {
  constexpr int kBits = bits_of(G);
  __shared__ __align__(16) float sv[kMaxPer * kThreads * G];
  __shared__ __align__(16) uint8_t sl[kMaxPer * kThreads * G];
  const unsigned c = blockIdx.y;
  const unsigned tile = kThreads * per;
  const unsigned g0 = blockIdx.x * tile;
  const float* xr = x + (size_t)c * P;
  for (int h = 1; h < per; ++h) {         // later groups' bytes in flight
    const unsigned g = g0 + h * kThreads + threadIdx.x;
    if (g < nb) prefetch_l1(xr + (size_t)g * G);
  }
#pragma unroll 1                           // one copy of the ranking code
  for (int h = 0; h < per; ++h) {
    const unsigned local = h * kThreads + threadIdx.x;
    float* svt = sv + local * kg;
    uint8_t* slt = sl + local * kg;
    if (g0 + local < nb) {
      const unsigned base = (g0 + local) * G;
      float v[G];
      load_group<G>(xr, base, P, vec, v);
      select_group<G>(v, xr, base, P, vec, kg, svt, slt);
    } else {                     // past the row's last group: slots pack 0
      for (int s = 0; s < kg; ++s) {
        svt[s] = 0.f;
        slt[s] = 0;
      }
    }
  }
  __syncthreads();

  const unsigned K = nb * kg;
  const unsigned n = min(tile, nb - g0) * kg;         // slots of this tile
  stage_out(vals + (size_t)c * K + g0 * kg, sv, n);
  const unsigned nbytes = (n + 7) / 8;
  uint8_t* prow = planes + (size_t)c * kBits * kb + g0 * kg / 8;
  for (unsigned b = threadIdx.x; b < nbytes; b += kThreads) {
    const uint2 w = *reinterpret_cast<const uint2*>(sl + 8 * b);
#pragma unroll
    for (int j = 0; j < kBits; ++j) {
      unsigned byte = 0;
#pragma unroll
      for (int l = 0; l < 8; ++l)
        byte |= (((l < 4 ? w.x >> (8 * l) : w.y >> (8 * (l - 4))) >> j) & 1u)
                << l;
      prow[(size_t)j * kb + b] = (uint8_t)byte;
    }
  }
}

// One group's decode from a block's shared buffers (values sv, planes sp
// of plane_len bytes each): its kg local indices rebuilt from the plane
// bits of slots slot0.., value_s * [li_s == l] summed into its G outputs in
// slot order, as topk_unpack_kernel does (a local index >= G adds
// nothing), written as G / 4 16-byte vectors where vec allows.
template <int G>
__device__ __forceinline__ void decode_group(const float* sv,
                                             const uint8_t* sp,
                                             unsigned plane_len,
                                             unsigned slot0, int kg,
                                             float* orow, unsigned base,
                                             unsigned p, bool vec) {
  constexpr int kBits = bits_of(G);
  float acc[G];
#pragma unroll
  for (int l = 0; l < G; ++l) acc[l] = 0.f;
#pragma unroll 1
  for (unsigned slot = slot0; slot < slot0 + kg; ++slot) {
    int li = 0;
#pragma unroll
    for (int j = 0; j < kBits; ++j)
      li |= ((sp[j * plane_len + (slot >> 3)] >> (slot & 7)) & 1) << j;
    const float v = sv[slot];
#pragma unroll
    for (int l = 0; l < G; ++l)
      acc[l] = __fadd_rn(acc[l], __fmul_rn(v, li == l ? 1.f : 0.f));
  }
  if constexpr (G % 4 == 0) {
    if (vec && base + G <= p) {
#pragma unroll
      for (int q = 0; q < G / 4; ++q)
        *reinterpret_cast<float4*>(orow + base + 4 * q) = make_float4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < G; ++l)
    if (base + l < p) orow[base + l] = acc[l];
}

// Grid (tiles, C), the encode's tiles. The block stages each plane's bytes
// of its slots and its slots' values in shared memory: the fp32 values by
// cp.async (stage_in), or, where codes is not null (the int8 decode), the
// values dequantized from the int8 codes and chunk scales (dequant_in,
// their lines prefetched ahead of the plane bytes; vals unused). After the
// barrier thread t decodes groups t, t + kThreads, ... of the tile
// (decode_group): one decode body for both prologues.
template <int G>
__global__ void __launch_bounds__(kThreads)
topk_decode_kernel(const float* __restrict__ vals,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, unsigned nc,
                   unsigned chunk, const uint8_t* __restrict__ planes,
                   float* __restrict__ out, unsigned p, unsigned nb, int kg,
                   unsigned kb, int per, bool vec) {
  constexpr int kBits = bits_of(G);
  constexpr unsigned kPlane = kMaxPer * kThreads * G / 8;   // bytes, at most
  __shared__ __align__(16) float sv[kMaxPer * kThreads * G + 4];
  __shared__ uint8_t sp[kBits * kPlane];
  const unsigned c = blockIdx.y;
  const unsigned tile = kThreads * per;
  const unsigned g0 = blockIdx.x * tile;
  const unsigned K = nb * kg;
  const unsigned n = min(tile, nb - g0) * kg;
  const unsigned nbytes = (n + 7) / 8;
  const size_t first = (size_t)c * K + g0 * kg;      // the tile's slot 0
  const float* sc = scales + (size_t)c * nc;
  if (codes) prefetch_int8(codes + first, sc, g0 * kg, chunk, n);
  const uint8_t* prow = planes + (size_t)c * kBits * kb + g0 * kg / 8;
  for (unsigned b = threadIdx.x; b < nbytes; b += kThreads) {
    uint8_t t[kBits];                  // every plane's byte b in flight
#pragma unroll
    for (int j = 0; j < kBits; ++j) t[j] = prow[(size_t)j * kb + b];
#pragma unroll
    for (int j = 0; j < kBits; ++j) sp[j * kPlane + b] = t[j];
  }
  const unsigned off = codes ? dequant_in(sv, codes + first, sc, g0 * kg,
                                         chunk, n)
                              : stage_in(sv, vals + first, n);
  __syncthreads();

  float* orow = out + (size_t)c * p;
#pragma unroll 1
  for (int h = 0; h < per; ++h) {
    const unsigned local = h * kThreads + threadIdx.x;
    if (g0 + local < nb)
      decode_group<G>(sv + off, sp, kPlane, local * kg, kg, orow,
                      (g0 + local) * G, p, vec);
  }
}

constexpr long long kMaxThreads = 1LL << 31;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

#define REPRO_PLANE_GROUP_CASES(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
#define REPRO_GROUP_CASES(X) X(1) REPRO_PLANE_GROUP_CASES(X)

}  // namespace

// x: (C, P) fp32; vals: (C, nb*kg) fp32; idx: (C, nb*kg) int32, nb =
// ceil(P / group); 1 <= group <= 16, 1 <= kg <= group; vec = 16-byte loads
// are aligned; C * nb * kg < 2^31. All contiguous on the current device.
// Returns cudaGetLastError().
extern "C" int repro_batched_topk_pack(const void* x, void* vals, void* idx,
                                       long long C, long long P, int group,
                                       int kg, int vec, void* stream) {
  if (group < 1 || group > kMaxGroup || kg < 1 || kg > group)
    return (int)cudaErrorInvalidValue;
  const long long nb = (P + group - 1) / group;
  const long long n = C * nb;
  if (n == 0) return 0;
  if (n * kg >= kMaxThreads || P >= kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
#define X(G)                                                        \
  case G:                                                           \
    topk_pack_kernel<G><<<blocks_for(n), kThreads, 0, st>>>(        \
        (const float*)x, (float*)vals, (int*)idx, (unsigned)P,      \
        (unsigned)nb, kg, (unsigned)n, vec != 0);                   \
    break;
    REPRO_GROUP_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

// vals: (C, nb*kg) fp32; idx: (C, nb*kg) int32; out: (C, p) fp32, nb =
// ceil(p / group); vec = 16-byte stores are aligned; C * p < 2^31. Returns
// cudaGetLastError().
extern "C" int repro_batched_topk_unpack(const void* vals, const void* idx,
                                         void* out, long long C, long long p,
                                         int group, int kg, int vec,
                                         void* stream) {
  if (group < 1 || group > kMaxGroup || kg < 1 || kg > group)
    return (int)cudaErrorInvalidValue;
  const long long nb = (p + group - 1) / group;
  const long long n = C * nb;
  if (n == 0) return 0;
  if (n * group >= kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
#define X(G)                                                            \
  case G:                                                               \
    topk_unpack_kernel<G><<<blocks_for(n), kThreads, 0, st>>>(          \
        (const float*)vals, (const int*)idx, (float*)out, (unsigned)p,  \
        (unsigned)nb, kg, (unsigned)n, vec != 0);                       \
    break;
    REPRO_GROUP_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

// idx: (C, K) int32; out: (C, bits*ceil(K/8)) uint8; C * K < 2^31, kg >= 1.
// Returns cudaGetLastError().
extern "C" int repro_batched_idx_bitpack(const void* idx, void* out,
                                         long long C, long long K, int group,
                                         int kg, int bits, void* stream) {
  const long long kb = (K + 7) / 8;
  const long long n = C * kb;
  if (n == 0) return 0;
  if (C * kb * 8 >= kMaxThreads || kg < 1) return (int)cudaErrorInvalidValue;
  idx_bitpack_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (uint8_t*)out, (unsigned)K, (unsigned)kb, group,
      (unsigned)kg, bits, (unsigned)n);
  return (int)cudaGetLastError();
}

// packed: (C, bits*kb) uint8; out: (C, k) int32, k <= 8*kb, C * 8*kb < 2^31,
// kg >= 1; vec = 16-byte stores are aligned. Returns cudaGetLastError().
extern "C" int repro_batched_idx_bitunpack(const void* packed, void* out,
                                           long long C, long long k,
                                           long long kb, int group, int kg,
                                           int bits, int vec, void* stream) {
  const long long n = C * kb;
  if (C * k == 0) return 0;
  if (n * 8 >= kMaxThreads || k > kb * 8 || kg < 1)
    return (int)cudaErrorInvalidValue;
  idx_bitunpack_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (int*)out, (unsigned)k, (unsigned)kb, group,
      (unsigned)kg, bits, (unsigned)n, vec != 0);
  return (int)cudaGetLastError();
}


// x: (C, P) fp32; vals: (C, K) fp32, K = nb*kg, nb = ceil(P / group);
// planes: (C, bits*kb) uint8, kb = ceil(K / 8), bits = ceil(log2 group);
// 2 <= group <= 16, 1 <= kg <= group; vec = x's rows keep 16-byte loads
// aligned; per = groups a thread (1 or 2); C * K < 2^31, P < 2^31, C <=
// 65535. Returns cudaGetLastError().
extern "C" int repro_batched_topk_encode(const void* x, void* vals,
                                         void* planes, long long C,
                                         long long P, int group, int kg,
                                         int vec, int per, void* stream) {
  if (group < 2 || group > kMaxGroup || kg < 1 || kg > group)
    return (int)cudaErrorInvalidValue;
  const long long nb = (P + group - 1) / group;
  const long long K = nb * kg;
  if (C * K == 0) return 0;
  if (C * K >= kMaxThreads || P >= kMaxThreads || C > 65535 ||
      per < 1 || per > kMaxPer)
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)kThreads * per;
  const dim3 grid((unsigned)((nb + tile - 1) / tile), (unsigned)C);
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
#define X(G)                                                              \
  case G:                                                                 \
    topk_encode_kernel<G><<<grid, kThreads, 0, st>>>(                     \
        (const float*)x, (float*)vals, (uint8_t*)planes, (unsigned)P,     \
        (unsigned)nb, kg, (unsigned)((K + 7) / 8), per, vec != 0);        \
    break;
    REPRO_PLANE_GROUP_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

namespace {

// Both decode entries: the fp32 values (codes null) or the int8 codes with
// nc chunk scales a row. Checks as the entries below state them.
int run_decode(const float* vals, const int8_t* codes, const float* scales,
               long long nc, int chunk, const uint8_t* planes, float* out,
               long long C, long long p, long long kb, int group, int kg,
               int vec, int per, cudaStream_t st) {
  if (group < 2 || group > kMaxGroup || kg < 1 || kg > group)
    return (int)cudaErrorInvalidValue;
  const long long nb = (p + group - 1) / group;
  const long long K = nb * kg;
  if (codes && (chunk < 1 || nc != (K + chunk - 1) / chunk))
    return (int)cudaErrorInvalidValue;
  if (C * p == 0) return 0;
  if (C * nb * group >= kMaxThreads || K > kb * 8 || C > 65535 ||
      per < 1 || per > kMaxPer)
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)kThreads * per;
  const dim3 grid((unsigned)((nb + tile - 1) / tile), (unsigned)C);
  switch (group) {
#define X(G)                                                              \
  case G:                                                                 \
    topk_decode_kernel<G><<<grid, kThreads, 0, st>>>(                     \
        vals, codes, scales, (unsigned)nc, (unsigned)chunk, planes, out,  \
        (unsigned)p, (unsigned)nb, kg, (unsigned)kb, per, vec != 0);      \
    break;
    REPRO_PLANE_GROUP_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals: (C, K) fp32, K = nb*kg, nb = ceil(p / group); planes: (C,
// bits*kb) uint8 with K <= 8*kb; out: (C, p) fp32; 2 <= group <= 16,
// 1 <= kg <= group; vec = out's rows keep 16-byte stores aligned; per =
// groups a thread (1 or 2); C * nb * group < 2^31, C <= 65535. Returns
// cudaGetLastError().
extern "C" int repro_batched_topk_decode(const void* vals, const void* planes,
                                         void* out, long long C, long long p,
                                         long long kb, int group, int kg,
                                         int vec, int per, void* stream) {
  return run_decode((const float*)vals, nullptr, nullptr, 0, 1,
                    (const uint8_t*)planes, (float*)out, C, p, kb, group, kg,
                    vec, per, (cudaStream_t)stream);
}

// codes: (C, K) int8 and scales: (C, nc) fp32, nc = ceil(K / chunk), chunk
// >= 1 (batched_quantize's outputs); planes, out and the rest as
// repro_batched_topk_decode. out = repro_batched_topk_decode(
// repro_batched_dequantize(codes, scales), planes), bit for bit. Returns
// cudaGetLastError().
extern "C" int repro_batched_topk_decode_int8(
    const void* codes, const void* scales, const void* planes, void* out,
    long long C, long long p, long long kb, long long nc, int chunk,
    int group, int kg, int vec, int per, void* stream) {
  if (codes == nullptr) return (int)cudaErrorInvalidValue;
  return run_decode(nullptr, (const int8_t*)codes, (const float*)scales, nc,
                    chunk, (const uint8_t*)planes, (float*)out, C, p, kb,
                    group, kg, vec, per, (cudaStream_t)stream);
}
