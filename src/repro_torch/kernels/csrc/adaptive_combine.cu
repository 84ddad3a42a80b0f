// adaptive_combine: FedSTIL's adaptive-layer parameterization (paper Eq. 2),
// elementwise over every leaf of an adaptive tree in one launch:
//
//   theta = B * alpha + A
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/adaptive_combine.py:adaptive_combine (_combine_kernel),
// which the reference applies leaf by leaf
// (src/repro/kernels/adaptive_combine.py:adaptive_combine_tree).
//
// Why the design is what it is. Two callers with opposite limits:
// - The federated round's head (7 leaves, 188 480 fp32 values at C = 5,
//   combined 11 times a round) is launch-bound: the bytes take under a
//   microsecond, a launch several. One launch covers every leaf of a
//   dtype: the leaf table travels by value as a __grid_constant__ kernel
//   parameter (under 4 KB, so no copy to the device before the launch),
//   and each block finds its leaf by a binary search over the leaves'
//   first blocks, uniform across the block and served from the constant
//   bank.
// - The LM's bf16 leaves (up to 2048 x 152064) and the fleet's (1000,
//   57664) fp32 leaf are bound by bytes: three reads and one write per
//   value, two operations. Each thread keeps kUnroll 16-byte vectors of
//   each operand in flight (4 fp32 or 8 bf16 values each), all loads
//   issued before the first store, so a block moves 48 KB of operands a
//   pass.
// A leaf whose four bases are all 16-byte aligned takes the vectors (its
// last, partial vector scalar); any other leaf takes scalar accesses,
// coalesced across the block. The host plan (kernels/adaptive_combine.py:
// _plan) groups the leaves by dtype, splits a group past kMaxLeaves,
// gives each leaf its first block and its vector flag; the entry point
// checks that plan against this file's spans before it launches.
//
// Rounding. The two operations are written __fadd_rn(__fmul_rn(b, al), a):
// nvcc would otherwise contract b * al + a into one FMA (--fmad=true is its
// default), which rounds once, and the result would differ by an ulp from
// the plain version, which rounds the product and then the sum. In bf16
// each op runs in fp32 and its result is rounded to bf16 (nearest even),
// after the product and again after the sum, as eager PyTorch does for a
// bf16 `b * al + a`. Outputs are bit-identical to the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte vectors of each operand a thread
constexpr int kMaxLeaves = 64;

// The leaves of one launch: the four bases, the length, the first block
// (ascending, first[0] = 0) and the vector flag of each.
struct Table {
  const void* b[kMaxLeaves];
  const void* al[kMaxLeaves];
  const void* a[kMaxLeaves];
  void* out[kMaxLeaves];
  unsigned n[kMaxLeaves];
  unsigned first[kMaxLeaves];
  unsigned char vec[kMaxLeaves];
  int count;
};
static_assert(sizeof(Table) <= 4000, "the leaf table must stay a small "
              "kernel parameter");

__device__ __forceinline__ float comb(float b, float al, float a) {
  return __fadd_rn(__fmul_rn(b, al), a);
}

__device__ __forceinline__ __nv_bfloat16 comb(__nv_bfloat16 b,
                                              __nv_bfloat16 al,
                                              __nv_bfloat16 a) {
  const __nv_bfloat16 prod = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(b), __bfloat162float(al)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(prod), __bfloat162float(a)));
}

// one 16-byte vector of each operand -> one of the output
template <typename T>
__device__ __forceinline__ uint4 comb_vec(const uint4& bv, const uint4& lv,
                                          const uint4& av) {
  constexpr int kVec = 16 / sizeof(T);
  const T* bp = reinterpret_cast<const T*>(&bv);
  const T* lp = reinterpret_cast<const T*>(&lv);
  const T* ap = reinterpret_cast<const T*>(&av);
  uint4 ov;
  T* op = reinterpret_cast<T*>(&ov);
#pragma unroll
  for (int j = 0; j < kVec; ++j) op[j] = comb(bp[j], lp[j], ap[j]);
  return ov;
}

template <typename T>
__host__ __device__ constexpr unsigned span() {   // values a block covers
  return kThreads * kUnroll * (16 / sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_tree_kernel(const __grid_constant__ Table t) {
  const unsigned blk = blockIdx.x;
  int lo = 0, hi = t.count - 1;      // the last leaf whose first <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const T* __restrict__ b = static_cast<const T*>(t.b[lo]);
  const T* __restrict__ al = static_cast<const T*>(t.al[lo]);
  const T* __restrict__ a = static_cast<const T*>(t.a[lo]);
  T* __restrict__ out = static_cast<T*>(t.out[lo]);
  const unsigned n = t.n[lo];
  const unsigned start = (blk - t.first[lo]) * span<T>();

  if (!t.vec[lo]) {
    constexpr int kPer = span<T>() / kThreads;
#pragma unroll 4
    for (int j = 0; j < kPer; ++j) {
      const unsigned i = start + j * kThreads + threadIdx.x;
      if (i < n) out[i] = comb(b[i], al[i], a[i]);
    }
    return;
  }
  constexpr unsigned kVec = 16 / sizeof(T);
  uint4 bv[kUnroll], lv[kUnroll], av[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = start + (u * kThreads + threadIdx.x) * kVec;
    if (i + kVec <= n) {
      bv[u] = *reinterpret_cast<const uint4*>(b + i);
      lv[u] = *reinterpret_cast<const uint4*>(al + i);
      av[u] = *reinterpret_cast<const uint4*>(a + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = start + (u * kThreads + threadIdx.x) * kVec;
    if (i + kVec <= n) {
      *reinterpret_cast<uint4*>(out + i) = comb_vec<T>(bv[u], lv[u], av[u]);
    } else {
      for (unsigned j = i; j < n; ++j) out[j] = comb(b[j], al[j], a[j]);
    }
  }
}

// Checks a plan against this file's spans and launches it: first[0] = 0,
// each leaf 0 < n < 2^31 and first[i + 1] - first[i] = its blocks.
template <typename T>
int launch(const Table& t, long long blocks, cudaStream_t stream) {
  if (t.count < 1 || t.count > kMaxLeaves || t.first[0] != 0)
    return (int)cudaErrorInvalidValue;
  long long next = 0;
  for (int i = 0; i < t.count; ++i) {
    if (t.n[i] == 0 || t.n[i] >= (1u << 31) || t.first[i] != next)
      return (int)cudaErrorInvalidValue;
    next += (t.n[i] + span<T>() - 1) / span<T>();
  }
  if (next != blocks || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  combine_tree_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// Every leaf of one dtype group in one launch. desc: count rows of seven
// int64 (b, alpha, a, out, n, first block, vec), count <= kMaxLeaves, as
// kernels/adaptive_combine.py:_plan lays them out; bf16 picks the dtype
// (0 fp32, 1 bf16); blocks = the plan's total. Returns cudaErrorInvalidValue
// for a plan that does not match the spans, else cudaGetLastError().
extern "C" int repro_adaptive_combine_tree(const long long* desc, int count,
                                           int bf16, long long blocks,
                                           void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 7 * i;
    if (d[4] <= 0 || d[4] >= (1LL << 31) || d[5] < 0 || d[5] >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    t.b[i] = reinterpret_cast<const void*>(d[0]);
    t.al[i] = reinterpret_cast<const void*>(d[1]);
    t.a[i] = reinterpret_cast<const void*>(d[2]);
    t.out[i] = reinterpret_cast<void*>(d[3]);
    t.n[i] = (unsigned)d[4];
    t.first[i] = (unsigned)d[5];
    t.vec[i] = d[6] != 0;
  }
  t.count = count;
  return bf16 ? launch<__nv_bfloat16>(t, blocks, (cudaStream_t)stream)
              : launch<float>(t, blocks, (cudaStream_t)stream);
}
