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
// Two variants (chosen by _plan in quantize.py from the shape and the
// bases):
//   vector  chunk a power of two >= 16, P % 4 == 0, x 16-byte aligned. A
//           thread owns 16 contiguous elements of one chunk: four float4
//           loads, all issued before any use. A chunk is a group of
//           chunk / 16 neighbouring lanes (4 at the refresh's chunk of 64,
//           16 at the codec's 256, a warp at 512), which reduces the absmax
//           with xor shuffles inside the group; the codes come from the
//           values still in registers (no second read) and are stored as
//           wide as the row's alignment allows: 16 bytes a thread when P %
//           16 == 0, else two of 8 or four of 4. A chunk above 512 is one
//           warp looping over it in 512-element pieces, reading each piece
//           again for its codes. One block row of the grid a client row, so
//           offsets inside a row are 32-bit and need no division.
//   scalar  everything else (a chunk that is no power of two, P % 4 != 0, a
//           misaligned base): one warp per chunk, lanes striding over it
//           with neighbouring lanes on neighbouring addresses, the absmax by
//           warp shuffles, then a second pass over the same elements (in
//           L1) to divide, round and store a byte each.
// The short tail chunk of a row (P not a multiple of chunk) is handled by
// the bounds, not by padding.
//
// Bit-exactness with the plain PyTorch version and with the JAX reference
// rests on IEEE arithmetic in the same form, in both variants (the absmax
// is order-free). The scale is the absmax times the fp32 reciprocal of
// 127: that is what the reference's `absmax / 127.0` compiles to (XLA
// rewrites a division by a constant, and PyTorch's CUDA division by a
// scalar does the same), and it differs from a correctly rounded division
// by 1 ulp in a few percent of chunks. The code division x / scale is a
// true division, __fdiv_rn (correctly rounded whatever the flags), and
// rounding is rintf, half to even like torch.round and jnp.round. Never
// build this file with --use_fast_math.
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

enum Variant { kScalar = 0, kVector = 1 };

constexpr int kVecElems = 16;        // elements a vector thread owns
constexpr int kPiece = 32 * kVecElems;   // a warp's elements at once

// the scale of a chunk whose absmax is m
__device__ __forceinline__ float chunk_scale(float m) {
  const float s = m * kInv127;
  return s > 0.f ? s : 1.f;  // all-zero (or subnormal) chunk
}

__device__ __forceinline__ int code_of(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (int)v;
}

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

  const float s = chunk_scale(m);
  for (long long i = start + lane; i < end; i += 32)
    qr[i] = (int8_t)code_of(xr[i], s);
  if (lane == 0) scales[c * nc + j] = s;
}

// the 16 elements at xr[off ..] below end (a multiple of 4) into v, zeros
// past it
__device__ __forceinline__ void load16(const float* __restrict__ xr, int off,
                                       int end, float4 (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = off + 4 * u < end
               ? __ldg(reinterpret_cast<const float4*>(xr + off) + u)
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float absmax16(const float4 (&v)[4], float m) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    m = fmaxf(fmaxf(m, fmaxf(fabsf(v[u].x), fabsf(v[u].y))),
              fmaxf(fabsf(v[u].z), fabsf(v[u].w)));
  return m;
}

// the codes of v at qr[off ..] below end: kStore bytes a store (qr + off
// aligned to it), 4 where the 16 run past end
template <int kStore>
__device__ __forceinline__ void store16(int8_t* __restrict__ qr, int off,
                                        int end, const float4 (&v)[4],
                                        float s) {
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    w[u] = (uint32_t)(code_of(v[u].x, s) & 0xff) |
           (uint32_t)(code_of(v[u].y, s) & 0xff) << 8 |
           (uint32_t)(code_of(v[u].z, s) & 0xff) << 16 |
           (uint32_t)(code_of(v[u].w, s) & 0xff) << 24;
  if (off + kVecElems <= end && kStore == 16) {
    *reinterpret_cast<uint4*>(qr + off) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (off + kVecElems <= end && kStore == 8) {
    *reinterpret_cast<uint2*>(qr + off) = make_uint2(w[0], w[1]);
    *reinterpret_cast<uint2*>(qr + off + 8) = make_uint2(w[2], w[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (off + 4 * u < end)
        *reinterpret_cast<uint32_t*>(qr + off + 4 * u) = w[u];
  }
}

// the vector variant: row c = blockIdx.y; its thread t belongs to chunk t
// >> gshift, as lane t & (2^gshift - 1) of the chunk's group; a chunk of
// `pieces` pieces of 16 << gshift elements (pieces > 1 only at gshift 5)
template <int kStore>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, int P, int nc, int chunk,
                    int gshift, int pieces) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int j = t >> gshift;                    // the chunk; >= nc: idle
  const int l = t & ((1 << gshift) - 1);
  const int span = kVecElems << gshift;         // a piece
  const float* xr = x + (size_t)blockIdx.y * P;
  int8_t* qr = q + (size_t)blockIdx.y * P;
  const int start = j < nc ? j * chunk : 0;
  const int end = j < nc ? start + min(chunk, P - start) : 0;

  float4 v[4];
  float m = 0.f;
  for (int p = 0; p < pieces; ++p) {
    load16(xr, start + p * span + kVecElems * l, end, v);
    m = absmax16(v, m);
  }
  for (int off = (1 << gshift) >> 1; off > 0; off >>= 1)  // in the group
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = chunk_scale(m);
  if (j >= nc) return;
  if (pieces == 1) {
    if (kVecElems * l < end - start)
      store16<kStore>(qr, start + kVecElems * l, end, v, s);
  } else {
    for (int p = 0; p < pieces; ++p) {
      const int off = start + p * span + kVecElems * l;
      if (off >= end) break;
      load16(xr, off, end, v);
      store16<kStore>(qr, off, end, v, s);
    }
  }
  if (l == 0) scales[(size_t)blockIdx.y * nc + j] = s;
}

template <int kStore>
int run_vec(const float* x, int8_t* q, float* scales, long long C,
            long long P, int chunk, cudaStream_t s) {
  const int lanes = (chunk < kPiece ? chunk : kPiece) / kVecElems;
  const long long nc = (P + chunk - 1) / chunk;
  const long long blocks = (nc * lanes + kThreads - 1) / kThreads;
  int gshift = 0;
  while ((1 << gshift) < lanes) ++gshift;
  const dim3 grid((unsigned)blocks, (unsigned)C);
  quantize_vec_kernel<kStore><<<grid, kThreads, 0, s>>>(
      x, q, scales, (int)P, (int)nc, chunk, gshift,
      chunk > kPiece ? chunk / kPiece : 1);
  return (int)cudaGetLastError();
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
// All contiguous on the current device. variant (0 scalar, 1 vector) and
// store (the vector variant's code store width in bytes: 16, 8 or 4) as
// _plan gives them. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// plan the operands do not allow).
extern "C" int repro_batched_quantize(const void* x, void* q, void* scales,
                                      long long C, long long P, int chunk,
                                      int variant, int store, void* stream) {
  const long long nc = (P + chunk - 1) / chunk;
  const long long n_chunks = C * nc;
  if (n_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kVector) {
    const bool pow2 = chunk >= kVecElems && (chunk & (chunk - 1)) == 0;
    if (!pow2 || P % 4 || P + chunk >= (1ll << 31) || C >= 65536 ||
        (store != 16 && store != 8 && store != 4) || P % store ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(q) % 16)
      return (int)cudaErrorInvalidValue;
    if (store == 16)
      return run_vec<16>((const float*)x, (int8_t*)q, (float*)scales, C, P,
                         chunk, s);
    if (store == 8)
      return run_vec<8>((const float*)x, (int8_t*)q, (float*)scales, C, P,
                        chunk, s);
    return run_vec<4>((const float*)x, (int8_t*)q, (float*)scales, C, P,
                      chunk, s);
  }
  if (variant != kScalar) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
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
