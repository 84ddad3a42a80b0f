// flash_attention: attention over (B, H, S, hd) heads with an online
// softmax, in four stages, each a CUDA kernel with a plain C entry point:
//
//   repro_flash_fwd      o = softmax(q k^T * scale) v
//   repro_flash_fwd_lse  the same, and lse = m + log l (fp32) per q row
//   repro_flash_dq       dq = sum_k dS k,   P = exp(s - lse),
//                        dS = P (dO v^T - delta) scale
//   repro_flash_dkv      dk = dS^T q, dv = P^T dO, summed over the R q
//                        heads that share a kv head
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py:flash_attention (_attn_kernel),
//   src/repro/kernels/flash_attention_bwd.py:_fwd (_fwd_kernel),
//   src/repro/kernels/flash_attention_bwd.py:_dq_kernel (pallas_call in
//     _bwd_rule, :209) and
//   src/repro/kernels/flash_attention_bwd.py:_dkv_kernel (:226).
// delta = rowsum(O * dO) (fp32) is computed outside, as at
// flash_attention_bwd.py:204.
//
// Layout: q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd), contiguous, Hq =
// Hkv * R; q head h reads kv head h / R (the reference's (KVg, R) order).
// fp32 operands only (bf16 runs on the tensor cores: the forwards in
// flash_fwd_sm90.cu, dQ and dK/dV in flash_bwd_sm90.cu), fp32 arithmetic
// and outputs (lse fp32). hd 64 or 128, any S: the ragged edge of the
// last tile is masked here. Visibility of key kpos from query qpos: kpos
// < Sk, causal -> kpos <= qpos (aligned top-left, the Pallas rule),
// window > 0 -> kpos > qpos - window (models/layers.py:344). Masked entries get
// probability 0; a q row that sees no key comes out 0 with lse -1e30.
//
// What bounds it on an H100: operations. At the train step's shapes
// (B 2, 16 q / 8 kv heads, S 4096, hd 128, causal) the forward does 4
// flops per visible (q, k) pair and head dim (137 GFLOP), dQ 6, dK/dV 8,
// against ~0.1 GB of operands: hundreds of flops a byte, far above the
// card's ridge, so the floor is the bf16 tensor-core rate.
//
// Design (first, simple version): fp32 FMAs on CUDA cores, no wgmma or
// TMA, so the kernels run far from that floor. Every bf16 stage has moved
// to the tensor cores; the fp32 stages stay here, since TF32 products
// would miss their bars. One block of 256 threads per 64-row tile:
// the forward and dQ walk the kv tiles of one q tile (causal tiles past
// the diagonal and window tiles before it skipped), dK/dV walk the q
// tiles of one kv tile for each of the R q heads of its group. Tiles are
// staged in shared memory as fp32 rows padded to hd + 1 floats, and each
// thread owns 4 rows and every 16th column of a 64 x 64 score tile, so
// the inner loops read shared memory without bank conflicts. The softmax
// statistics of a row live in the 16 lanes that share it and are reduced
// with warp shuffles. q is scaled once as it is staged (the Pallas
// kernels' q * scale); dK/dV then takes dk = sum P (dp - delta) (q *
// scale), which is dS^T q. No --use_fast_math: expf and logf are the
// accurate ones.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // q rows a tile
constexpr int kBK = 64;         // kv rows a tile
constexpr int kThreads = 256;   // (ty, tx) = (tid / 16, tid % 16)
constexpr int kPLD = kBK + 4;   // row stride of the probability tiles
constexpr float kNegInf = -1e30f;

struct Dims {
  int B, Hq, Hkv, Sq, Sk, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const Dims& d) {
  return qpos < d.Sq && kpos < d.Sk && (!d.causal || kpos <= qpos) &&
         (d.window <= 0 || kpos > qpos - d.window);
}

__device__ __forceinline__ float max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [r0, r0 + 64) of one head's (S, HD) slice -> shared [64][HD + 1]
// fp32, each times mul; rows past S are zero
template <int HD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S, float mul) {
  for (int e = threadIdx.x; e < 64 * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] =
        (r0 + r < S) ? src[(size_t)(r0 + r) * HD + c] * mul : 0.f;
  }
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

template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Dims d) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / d.Hq, h = bh % d.Hq;
  const int g = h / (d.Hq / d.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const size_t kv_off = (size_t)(b * d.Hkv + g) * d.Sk * HD;
  load_rows<HD>(Qs, q + (size_t)bh * d.Sq * HD, q0, d.Sq, d.scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int t_lo, t_hi;
  kv_tiles(q0, d, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile's reads are done
    load_rows<HD>(Ks, k + kv_off, k0, d.Sk, 1.f);
    load_rows<HD>(Vs, v + kv_off, k0, d.Sk, 1.f);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int e = 0; e < HD; ++e) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      unsigned vis = 0;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(qpos, k0 + tx + 16 * j, d)) {
          vis |= 1u << j;
          mx = fmaxf(mx, s[i][j]);
        }
      mx = max16(mx);
      const float corr = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (vis >> j & 1u) ? expf(s[i][j] - mx) : 0.f;
        Ps[(ty * 4 + i) * kPLD + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + sum16(ps);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= d.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)bh * d.Sq + qpos) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / lc;
    if (kLse && tx == 0) lse[(size_t)bh * d.Sq + qpos] = m[i] + logf(lc);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, Dims d) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kBQ * LD;         // dO
  float* Ks = Os + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;         // dS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / d.Hq, h = bh % d.Hq;
  const int g = h / (d.Hq / d.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const size_t kv_off = (size_t)(b * d.Hkv + g) * d.Sk * HD;
  const size_t q_off = (size_t)bh * d.Sq * HD;
  load_rows<HD>(Qs, q + q_off, q0, d.Sq, d.scale);
  load_rows<HD>(Os, dout + q_off, q0, d.Sq, 1.f);
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    lr[i] = qpos < d.Sq ? lse[(size_t)bh * d.Sq + qpos] : 0.f;
    dr[i] = qpos < d.Sq ? delta[(size_t)bh * d.Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int t_lo, t_hi;
  kv_tiles(q0, d, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    load_rows<HD>(Ks, k + kv_off, k0, d.Sk, 1.f);
    load_rows<HD>(Vs, v + kv_off, k0, d.Sk, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int e = 0; e < HD; ++e) {
      float a[4], oo[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * LD + e];
        oo[i] = Os[(ty * 4 + i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * LD + e];
        bv[j] = Vs[(tx + 16 * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(qpos, k0 + tx + 16 * j, d)
                            ? expf(s[i][j] - lr[i]) : 0.f;
        Ps[(ty * 4 + i) * kPLD + tx + 16 * j] =
            p * (dp[i][j] - dr[i]) * d.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(ty * 4 + i) * kPLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= d.Sq) continue;
    float* row = dq + ((size_t)bh * d.Sq + qpos) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, Dims d) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* Os = Qs + kBQ * LD;         // dO
  float* PT = Os + kBQ * LD;         // P^T: kv rows x q rows
  float* DT = PT + kBK * kPLD;       // P (dp - delta), transposed likewise
  float* Ls = DT + kBK * kPLD;
  float* Ds = Ls + kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bg = blockIdx.y, b = bg / d.Hkv, g = bg % d.Hkv;
  const int R = d.Hq / d.Hkv;
  const int k0 = blockIdx.x * kBK;
  const size_t kv_off = (size_t)bg * d.Sk * HD;
  load_rows<HD>(Ks, k + kv_off, k0, d.Sk, 1.f);
  load_rows<HD>(Vs, v + kv_off, k0, d.Sk, 1.f);
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  // the q tiles that see any key of this tile: causal -> qpos >= k0;
  // window -> qpos < kpos + window <= k0 + kBK - 1 + window
  const int lo = d.causal ? k0 : 0;
  const int hi = d.window > 0 ? min(d.Sq, k0 + kBK - 1 + d.window) : d.Sq;
  const int t_lo = lo / kBQ;
  const int t_hi = hi > lo ? (hi + kBQ - 1) / kBQ : t_lo;
  for (int r = 0; r < R; ++r) {
    const int bh = b * d.Hq + g * R + r;
    const size_t q_off = (size_t)bh * d.Sq * HD;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();
      load_rows<HD>(Qs, q + q_off, q0, d.Sq, d.scale);
      load_rows<HD>(Os, dout + q_off, q0, d.Sq, 1.f);
      for (int e = threadIdx.x; e < kBQ; e += kThreads) {
        const int qpos = q0 + e;
        Ls[e] = qpos < d.Sq ? lse[(size_t)bh * d.Sq + qpos] : 0.f;
        Ds[e] = qpos < d.Sq ? delta[(size_t)bh * d.Sq + qpos] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};   // [kv row i][q row j]
#pragma unroll 4
      for (int e = 0; e < HD; ++e) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(ty * 4 + i) * LD + e];
          vv[i] = Vs[(ty * 4 + i) * LD + e];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = Qs[(tx + 16 * j) * LD + e];
          oo[j] = Os[(tx + 16 * j) * LD + e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          const float p = visible(q0 + qi, kpos, d)
                              ? expf(s[i][j] - Ls[qi]) : 0.f;
          PT[(ty * 4 + i) * kPLD + qi] = p;
          DT[(ty * 4 + i) * kPLD + qi] = p * (dp[i][j] - Ds[qi]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBQ; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = PT[(ty * 4 + i) * kPLD + j];
          ds[i] = DT[(ty * 4 + i) * kPLD + j];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float oo = Os[j * LD + tx + 16 * c];
          const float qq = Qs[j * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][c] = fmaf(p[i], oo, dva[i][c]);
            dka[i][c] = fmaf(ds[i], qq, dka[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= d.Sk) continue;
    const size_t row = ((size_t)bg * d.Sk + kpos) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = dka[i][c];
      dv[row + tx + 16 * c] = dva[i][c];
    }
  }
}

constexpr size_t fwd_smem(int hd) {
  return (size_t)(3 * 64 * (hd + 1) + kBQ * kPLD) * sizeof(float);
}
constexpr size_t dq_smem(int hd) {
  return (size_t)(4 * 64 * (hd + 1) + kBQ * kPLD) * sizeof(float);
}
constexpr size_t dkv_smem(int hd) {
  return (size_t)(4 * 64 * (hd + 1) + 2 * kBK * kPLD + 2 * kBQ) *
         sizeof(float);
}

// lets kern take smem bytes of dynamic shared memory (above 48 KB)
template <typename K>
int allow_smem(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int check_dims(const Dims& d, int hd) {
  if ((hd != 64 && hd != 128) || d.B < 1 || d.Hkv < 1 || d.Hq < d.Hkv ||
      d.Hq % d.Hkv != 0 || d.Sq < 1 || d.Sk < 1 ||
      (long long)d.B * d.Hq > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int HD>
int run_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
            const Dims& d, cudaStream_t stream) {
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  const size_t smem = fwd_smem(HD);
  const dim3 grid((d.Sq + kBQ - 1) / kBQ, d.B * d.Hq);
  if (lse) {
    auto kern = fwd_kernel<HD, true>;
    if (int rc = allow_smem(kern, smem)) return rc;
    kern<<<grid, kThreads, smem, stream>>>(qf, kf, vf, (float*)o, lse, d);
  } else {
    auto kern = fwd_kernel<HD, false>;
    if (int rc = allow_smem(kern, smem)) return rc;
    kern<<<grid, kThreads, smem, stream>>>(qf, kf, vf, (float*)o, nullptr,
                                           d);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, const Dims& d,
           cudaStream_t stream) {
  const size_t smem = dq_smem(HD);
  const dim3 grid((d.Sq + kBQ - 1) / kBQ, d.B * d.Hq);
  auto kern = dq_kernel<HD>;
  if (int rc = allow_smem(kern, smem)) return rc;
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, d);
  return (int)cudaGetLastError();
}

template <int HD>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            const Dims& d, cudaStream_t stream) {
  const size_t smem = dkv_smem(HD);
  const dim3 grid((d.Sk + kBK - 1) / kBK, d.B * d.Hkv);
  auto kern = dkv_kernel<HD>;
  if (int rc = allow_smem(kern, smem)) return rc;
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: contiguous fp32 tensors on the current device as laid
// out above, scale the softmax scale (1/sqrt(hd), rounded to fp32 by the
// caller), causal 0/1, window 0 for none; bf16 must be 0 (bf16 operands
// run on the tensor cores: repro_flash_fwd_sm90, repro_flash_dq_sm90,
// repro_flash_dkv_sm90). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or dtype the kernels do not take).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq,
                               int Sk, int hd, int causal, int window,
                               float scale, int bf16, void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  if (bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return hd == 64 ? run_fwd<64>(q, k, v, o, nullptr, d, st)
                  : run_fwd<128>(q, k, v, o, nullptr, d, st);
}

extern "C" int repro_flash_fwd_lse(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Hq, int Hkv, int Sq, int Sk, int hd,
                                   int causal, int window, float scale,
                                   int bf16, void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  if (!lse || bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  return hd == 64 ? run_fwd<64>(q, k, v, o, l, d, st)
                  : run_fwd<128>(q, k, v, o, l, d, st);
}

extern "C" int repro_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int B, int Hq,
                              int Hkv, int Sq, int Sk, int hd, int causal,
                              int window, float scale, int bf16,
                              void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  if (bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  return hd == 64 ? run_dq<64>(q, k, v, dout, l, dl, dq, d, st)
                  : run_dq<128>(q, k, v, dout, l, dl, dq, d, st);
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int Hq, int Hkv, int Sq, int Sk, int hd,
                               int causal, int window, float scale, int bf16,
                               void* stream) {
  const Dims d{B, Hq, Hkv, Sq, Sk, causal, window, scale};
  if (int rc = check_dims(d, hd)) return rc;
  if (bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  return hd == 64 ? run_dkv<64>(q, k, v, dout, l, dl, dk, dv, d, st)
                  : run_dkv<128>(q, k, v, dout, l, dl, dk, dv, d, st);
}
