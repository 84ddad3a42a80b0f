// The wire codec's grouped top-k sparsify and index bit-packing: four
// kernels, each replacing one Pallas TPU kernel of
// src/repro/kernels/topk_pack.py.
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
// operations-per-byte balance.
//
// Design: one thread per group (pack, unpack) or per packed byte position,
// eight slots (bitpack, bitunpack). A group's G inputs sit in registers; neighbouring
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

template <int G>
__global__ void __launch_bounds__(kThreads)
topk_pack_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, unsigned P, unsigned nb, int kg,
                 unsigned n_groups, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_groups) return;
  const unsigned c = t / nb;
  const unsigned base = (t - c * nb) * G;
  const float* xr = x + (size_t)c * P;

  float v[G];
  bool loaded = false;
  if constexpr (G == 8) {
    if (vec && base + G <= P) {
      const float4 lo = *reinterpret_cast<const float4*>(xr + base);
      const float4 hi = *reinterpret_cast<const float4*>(xr + base + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int i = 0; i < G; ++i) v[i] = base + i < P ? xr[base + i] : 0.f;
  }

  int rank[G];
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

  float* vo = vals + (size_t)t * kg;
  int* io = idx + (size_t)t * kg;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s < kg) {
      float acc = 0.f;
      int ia = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const bool hit = rank[i] == s;
        acc = __fadd_rn(acc, __fmul_rn(v[i], hit ? 1.f : 0.f));
        ia += hit ? (int)(base + i) : 0;
      }
      vo[s] = acc;
      io[s] = ia;
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

constexpr long long kMaxThreads = 1LL << 31;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

#define REPRO_GROUP_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

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
