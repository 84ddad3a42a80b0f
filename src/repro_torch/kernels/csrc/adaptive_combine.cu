// adaptive_combine: FedSTIL's adaptive-layer parameterization (paper Eq. 2),
// elementwise over one leaf of any shape:
//
//   theta = B * alpha + A
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/adaptive_combine.py:adaptive_combine (_combine_kernel),
// which the reference applies leaf by leaf (adaptive_combine_tree).
//
// What bounds it on an H100: bytes. Three fp32 reads and one write per
// element (16 bytes; 8 in bf16) for two floating-point operations.
//
// Design: a thread per 4 elements, read and written as 16-byte float4
// vectors when all four bases are 16-byte aligned (the wrapper decides; the
// last, partial vector of a ragged length is scalar), a thread per element
// otherwise. The two operations are written __fadd_rn(__fmul_rn(b, al), a):
// nvcc would otherwise contract b * al + a into one FMA (--fmad=true is its
// default), which rounds once, and the result would differ by an ulp from
// the plain version and from the reference, which both round the product
// and then the sum.
//
// bf16 (the LM's adaptive leaves at full width): the same in fp32 with a
// round to bf16 (nearest even) after the product and again after the sum,
// which is what eager PyTorch does for a bf16 `b * al + a` (each op in
// float, its result rounded to bf16), so the kernel is bit-identical to the
// plain version there too. 16-byte vectors of 8 values when aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float comb(float b, float al, float a) {
  return __fadd_rn(__fmul_rn(b, al), a);
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ b, const float* __restrict__ al,
               const float* __restrict__ a, float* __restrict__ out,
               unsigned n, unsigned n_items, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_items) return;
  if (!vec) {
    out[t] = comb(b[t], al[t], a[t]);
    return;
  }
  const unsigned i = t * 4;
  if (i + 4 <= n) {
    const float4 bv = *reinterpret_cast<const float4*>(b + i);
    const float4 lv = *reinterpret_cast<const float4*>(al + i);
    const float4 av = *reinterpret_cast<const float4*>(a + i);
    *reinterpret_cast<float4*>(out + i) = make_float4(
        comb(bv.x, lv.x, av.x), comb(bv.y, lv.y, av.y),
        comb(bv.z, lv.z, av.z), comb(bv.w, lv.w, av.w));
  } else {
    for (unsigned j = i; j < n; ++j) out[j] = comb(b[j], al[j], a[j]);
  }
}

__device__ __forceinline__ __nv_bfloat16 comb_bf16(__nv_bfloat16 b,
                                                   __nv_bfloat16 al,
                                                   __nv_bfloat16 a) {
  const __nv_bfloat16 prod = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(b), __bfloat162float(al)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(prod), __bfloat162float(a)));
}

__global__ void __launch_bounds__(kThreads)
combine_bf16_kernel(const __nv_bfloat16* __restrict__ b,
                    const __nv_bfloat16* __restrict__ al,
                    const __nv_bfloat16* __restrict__ a,
                    __nv_bfloat16* __restrict__ out, unsigned n,
                    unsigned n_items, bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_items) return;
  if (!vec) {
    out[t] = comb_bf16(b[t], al[t], a[t]);
    return;
  }
  const unsigned i = t * 8;
  if (i + 8 <= n) {
    const uint4 bv = *reinterpret_cast<const uint4*>(b + i);
    const uint4 lv = *reinterpret_cast<const uint4*>(al + i);
    const uint4 av = *reinterpret_cast<const uint4*>(a + i);
    const __nv_bfloat16* bp = reinterpret_cast<const __nv_bfloat16*>(&bv);
    const __nv_bfloat16* lp = reinterpret_cast<const __nv_bfloat16*>(&lv);
    const __nv_bfloat16* ap = reinterpret_cast<const __nv_bfloat16*>(&av);
    uint4 ov;
    __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) op[j] = comb_bf16(bp[j], lp[j], ap[j]);
    *reinterpret_cast<uint4*>(out + i) = ov;
  } else {
    for (unsigned j = i; j < n; ++j) out[j] = comb_bf16(b[j], al[j], a[j]);
  }
}

}  // namespace

// b, alpha, a, out: n fp32 each, contiguous on the current device, n < 2^31;
// vec = all four bases 16-byte aligned. Returns cudaGetLastError().
extern "C" int repro_adaptive_combine(const void* b, const void* alpha,
                                      const void* a, void* out, long long n,
                                      int vec, void* stream) {
  if (n == 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long items = vec ? (n + 3) / 4 : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  combine_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)b, (const float*)alpha, (const float*)a, (float*)out,
      (unsigned)n, (unsigned)items, vec != 0);
  return (int)cudaGetLastError();
}

// The same over bf16 b, alpha, a, out; vec = all four bases 16-byte
// aligned (8 values a thread). Returns cudaGetLastError().
extern "C" int repro_adaptive_combine_bf16(const void* b, const void* alpha,
                                           const void* a, void* out,
                                           long long n, int vec,
                                           void* stream) {
  if (n == 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long items = vec ? (n + 7) / 8 : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  combine_bf16_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)b, (const __nv_bfloat16*)alpha,
      (const __nv_bfloat16*)a, (__nv_bfloat16*)out, (unsigned)n,
      (unsigned)items, vec != 0);
  return (int)cudaGetLastError();
}
