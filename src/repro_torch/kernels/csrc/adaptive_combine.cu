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
// element (16 bytes) for two floating-point operations.
//
// Design: a thread per 4 elements, read and written as 16-byte float4
// vectors when all four bases are 16-byte aligned (the wrapper decides; the
// last, partial vector of a ragged length is scalar), a thread per element
// otherwise. The two operations are written __fadd_rn(__fmul_rn(b, al), a):
// nvcc would otherwise contract b * al + a into one FMA (--fmad=true is its
// default), which rounds once, and the result would differ by an ulp from
// the plain version and from the reference, which both round the product
// and then the sum.
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
