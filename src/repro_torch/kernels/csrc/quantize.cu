// batched_quantize: per-chunk symmetric int8 quantization of stacked rows,
// and batched_dequantize, its inverse.
//
// batched_quantize replaces the Pallas TPU kernel
// src/repro/kernels/quantize.py:batched_quantize (_quant_kernel). For every
// client row c and chunk j of `chunk` contiguous elements:
//
//     scale[c, j] = max |x[c, j*chunk : (j+1)*chunk]| * fl(1/127)  (not > 0 -> 1.0)
//     q[c, i]     = clip(rint(x[c, i] / scale), -127, 127)
//
// What bounds it on an H100: bytes. Each input float is read once and each
// code written once (5 bytes per element plus 4 per chunk) for a handful of
// ALU operations, far below the card's operations-per-byte balance.
//
// Design: one warp per chunk. The lanes stride over the chunk with
// neighbouring lanes on neighbouring addresses (coalesced 128-byte loads),
// reduce the absmax with warp shuffles, and then make a second pass over the
// same elements, which are still in L1, to divide, round and store. The
// chunk's data never leaves the SM between the two passes, which is what the
// TPU kernel's VMEM block bought. The short tail chunk of a row (P not a
// multiple of chunk) is handled by the loop bounds, not by padding.
//
// Bit-exactness with the plain PyTorch version and with the JAX reference
// rests on IEEE arithmetic in the same form. The scale is the absmax times
// the fp32 reciprocal of 127: that is what the reference's `absmax / 127.0`
// compiles to (XLA rewrites a division by a constant, and PyTorch's CUDA
// division by a scalar does the same), and it differs from a correctly
// rounded division by 1 ulp in a few percent of chunks. The code division
// x / scale is a true division, __fdiv_rn (correctly rounded whatever the
// flags), and rounding is rintf, half to even like torch.round and
// jnp.round. Never build this file with --use_fast_math.
//
// batched_dequantize replaces src/repro/kernels/quantize.py:batched_dequantize
// (_dequant_kernel):
//
//     out[c, i] = float(q[c, i]) * scale[c, i / chunk]
//
// one IEEE product (__fmul_rn), so it is bit-identical to the plain version
// and to the reference's ref and interpret paths. Bytes bound it: 1 byte in
// and 4 out per element. Design: a thread per 4 codes (a 4-byte char4 load,
// a 16-byte float4 store, the chunk's scale read once) when P and the chunk
// are multiples of 4 and both bases are aligned (the wrapper decides);
// otherwise a thread per code. The reference pads the tail chunk of a row
// with zero codes and scale 1.0; here each thread stays inside its row, so
// the tail chunk of a ragged P needs no padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;  // folded, correctly rounded

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long P, long long nc,
                long long n_chunks, int chunk) {
  const long long w = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= n_chunks) return;  // uniform across the warp
  const long long c = w / nc;
  const long long j = w % nc;
  const long long start = j * chunk;
  const long long end = start + chunk < P ? start + chunk : P;
  const float* xr = x + c * P;
  int8_t* qr = q + c * P;

  float m = 0.f;
  for (long long i = start + lane; i < end; i += 32) m = fmaxf(m, fabsf(xr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = m * kInv127;
  s = s > 0.f ? s : 1.f;  // all-zero (or subnormal) chunk

  for (long long i = start + lane; i < end; i += 32) {
    float v = rintf(__fdiv_rn(xr[i], s));
    v = fminf(fmaxf(v, -127.f), 127.f);
    qr[i] = (int8_t)(int)v;
  }
  if (lane == 0) scales[c * nc + j] = s;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  unsigned P, unsigned nc, unsigned chunk, unsigned n_items,
                  bool vec) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_items) return;
  if (vec) {
    const unsigned per_row = P / 4;
    const unsigned c = t / per_row;
    const unsigned i = (t - c * per_row) * 4;
    const float s = scales[(size_t)c * nc + i / chunk];
    const size_t off = (size_t)c * P + i;
    const char4 v = *reinterpret_cast<const char4*>(q + off);
    *reinterpret_cast<float4*>(out + off) = make_float4(
        __fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
        __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
  } else {
    const unsigned c = t / P;
    const unsigned i = t - c * P;
    out[t] = __fmul_rn((float)q[t], scales[(size_t)c * nc + i / chunk]);
  }
}

}  // namespace

// x: (C, P) fp32; q: (C, P) int8; scales: (C, ceil(P / chunk)) fp32.
// All contiguous on the current device. Returns cudaGetLastError().
extern "C" int repro_batched_quantize(const void* x, void* q, void* scales,
                                      long long C, long long P, int chunk,
                                      void* stream) {
  const long long nc = (P + chunk - 1) / chunk;
  const long long n_chunks = C * nc;
  if (n_chunks == 0) return 0;
  const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, P, nc, n_chunks, chunk);
  return (int)cudaGetLastError();
}

// q: (C, P) int8; scales: (C, ceil(P / chunk)) fp32; out: (C, P) fp32; C * P
// < 2^31; vec = P % 4 == 0, chunk % 4 == 0 and the bases of q (4 bytes) and
// out (16 bytes) aligned. All contiguous on the current device. Returns
// cudaGetLastError().
extern "C" int repro_batched_dequantize(const void* q, const void* scales,
                                        void* out, long long C, long long P,
                                        int chunk, int vec, void* stream) {
  const long long n = C * P;
  if (n == 0) return 0;
  if (n >= (1LL << 31) || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long nc = (P + chunk - 1) / chunk;
  const long long items = vec ? n / 4 : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  dequantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)out, (unsigned)P,
      (unsigned)nc, (unsigned)chunk, (unsigned)items, vec != 0);
  return (int)cudaGetLastError();
}
