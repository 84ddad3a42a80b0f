// decode_attention: one new token's attention against the KV cache, read in
// place in its own dtype (flash-decoding: the cache's slots split over
// blocks, the splits' softmax statistics merged in a second pass):
//
//   o[b, g, r] = sum_j p_j v[b, j, g],
//   p_j = softmax_j(q[b, g, r] . k[b, j, g] / sqrt(hd))
//
// over the valid slots j in [lo, hi) of this rank's cache; q (B, KV, R, hd)
// fp32 (kv head g serves q heads g * R .. g * R + R - 1), k and v (B, S, KV,
// hd) in bf16 or fp32 with any batch and slot stride (a stacked layer's view).
// Unsharded the output is the normalized o; under tensor parallelism the
// unnormalized o with its m (the scores' max) and l (sum of exp(s - m)), which
// the caller merges across ranks. A rank whose range is empty returns o = 0,
// m = -1e30, l = 0: its partial merges to nothing.
//
// Replaces no TPU kernel: the JAX package decodes with jnp einsums
// (src/repro/models/layers.py's decode attention), which the port ran as two
// einsums over a whole-cache fp32 copy. The kernel was added because that
// path spent ~90% of a 32k-slot decode step copying the cache.
//
// What bounds it on the H100: bytes. At R q heads a kv head, each cache
// element takes R multiply-adds for the scores and R for the weighted sum:
// 1-4 operations a byte of bf16, far below even the fp32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20). So no tensor cores; the design only moves the cache's
// bytes once, at full width:
// - A block takes one (b, kv head, split) and up to RT of the kv head's q
//   heads (R > 4 runs ceil(R / 4) blocks a split, launched next to each other
//   so that their second and later reads of a slot hit L2). A block per (b,
//   split) over all kv heads would read each slot's whole row contiguously;
//   the per-head block was chosen because it needs no rule tying hd and KV to
//   the block's width: each slot's hd values are a 128- or 256-byte run,
//   whole cache lines either way.
// - GP lanes (8 up to hd 64, 16 up to hd 128) share a slot, each holding 8 of
//   its hd values: one 16-byte load of bf16 (two of fp32), converted exactly
//   to fp32 in registers. A lane group takes U slots at a time, every load
//   issued before the first use, so a lane has 4 U 16-byte loads in flight
//   and a 256-thread block 32 KB; at 74 / 104 registers a thread (bf16, R 1
//   / 2) 3 / 2 blocks share an SM, 96 / 64 KB in flight. Launching a (b,
//   split)'s kv heads next to each other took the decode cells' shapes from
//   88.6 / 85.4% to 90.0 / 86.7% of the bytes bound on an H100 (a
//   streaming-load hint, __ldcs, measured 91.5 / 89.8% beside them).
// - Scores, the online softmax and the weighted sum stay in fp32 registers
//   (expf, IEEE; q scaled by 1/sqrt(hd) with one rounded fp32 multiply, as
//   the plain version does); the dot's partial sums meet by warp shuffles.
//   Each lane group keeps its own (m, l, acc); the block merges its groups
//   through shared memory, then writes one partial per (split, q head).
// - The split count comes from the host (kernels/decode_attention.py:_plan):
//   enough splits that the grid fills the card many times over at the shape's
//   B x KV, none shorter than a few hundred slots. With one split the block
//   writes the final output itself (normalized unless partial): one launch;
//   otherwise the merge kernel combines the splits: two launches.
// Precision: the same work as the plain version in another order: the
// bf16 -> fp32 upcast is exact, products and sums are fp32, p stays fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // head-dim values a lane holds
constexpr float kEmpty = -1e30f;     // m of a split that saw no slot
constexpr int kMaxSplits = 4096;     // the merge's weights in shared memory
constexpr int kMergeThreads = 128; // one output dim a thread, hd <= 128

// Eight consecutive values of one slot: one 16-byte load of bf16, two of fp32.
template <typename T> struct Row8;

template <> struct Row8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  // exact: a bf16 is the high half of the fp32 with the same value; the
  // element at the lower address is the low half of each 32-bit word
  __device__ __forceinline__ void get(float (&f)[kVec]) const {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&f)[kVec]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Slots a lane group takes at once: 4 U 16-byte loads in flight a lane
template <typename T, int RT>
__host__ __device__ constexpr int unroll() {
  return (RT >= 4 || sizeof(T) == 4) ? 2 : 4;
}

// grid (ceil(R / RT), KV, B * nsplit): a (b, split)'s kv heads are launched
// next to each other, so the blocks that share the cache's slot rows run
// together; o, m, l are the partials
// [B * KV][nsplit][R](hd), or with one split the outputs themselves
// (normalize: o / max(l, 1e-30), m and l not written)
template <typename T, int GP, int RT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int B, int KV, int R, int hd, long long k_b, long long k_s,
                    long long v_b, long long v_s, int lo, int hi, int chunk,
                    float scale, int normalize) {
  constexpr int NG = kThreads / GP;          // lane groups of the block
  constexpr int U = unroll<T, RT>();
  const int nsplit = gridDim.z / B;
  const int b = blockIdx.z / nsplit, split = blockIdx.z - b * nsplit;
  const int g = blockIdx.y;
  const int bg = b * KV + g;
  const int h0 = blockIdx.x * RT;            // the block's first q head of g
  const int group = threadIdx.x / GP, lane = threadIdx.x % GP;
  const int d0 = lane * kVec;
  const bool active = d0 < hd;               // lanes past hd hold zeros

  float qr[RT][kVec];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float* qp = q + ((long long)bg * R + h0 + r) * hd + d0;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qr[r][e] = (active && h0 + r < R) ? __fmul_rn(qp[e], scale) : 0.f;
  }
  float m[RT], l[RT], acc[RT][kVec];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kEmpty;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }

  const T* kp = k + b * k_b + (long long)g * hd + d0;
  const T* vp = v + b * v_b + (long long)g * hd + d0;
  const int s0 = lo + split * chunk;
  const int s1 = min(hi, s0 + chunk);
  for (int base = s0; base < s1; base += NG * U) {
    Row8<T> kr[U], vr[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NG + group;
      in[u] = j < s1;
      if (in[u] && active) {
        kr[u].load(kp + j * k_s);
        vr[u].load(vp + j * v_s);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float s[U][RT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kVec];
      kr[u].get(kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(qr[r][e], kf[e], d);
        s[u][r] = d;
      }
    }
    // the dot's lane partials meet: every lane of the group holds the score
#pragma unroll
    for (int off = GP / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], off);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (in[u]) mx = fmaxf(mx, s[u][r]);
      const float corr = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[kVec];
      vr[u].get(vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float p = in[u] ? expf(s[u][r] - m[r]) : 0.f;
        l[r] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // the block's groups merge: each group's acc scaled to the block's max,
  // then summed a dim a thread
  __shared__ float sm_m[NG][RT], sm_l[NG][RT];
  __shared__ float red[kThreads * kVec];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      sm_m[group][r] = m[r];
      sm_l[group][r] = l[r];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float mb = kEmpty;
    for (int i = 0; i < NG; ++i) mb = fmaxf(mb, sm_m[i][r]);
    const float w = expf(m[r] - mb);
#pragma unroll
    for (int e = 0; e < kVec; ++e) red[t * kVec + e] = acc[r][e] * w;
    __syncthreads();
    const int h = h0 + r;
    if (t < hd && h < R) {
      // dim t of group i sits at lane t / 8, value t % 8: red[i GP 8 + t]
      float sum = 0.f, lsum = 0.f;
      for (int i = 0; i < NG; ++i) {
        sum += red[i * GP * kVec + t];
        lsum += sm_l[i][r] * expf(sm_m[i][r] - mb);
      }
      const long long row = ((long long)bg * nsplit + split) * R + h;
      if (normalize) {
        o[row * hd + t] = sum / fmaxf(lsum, 1e-30f);
      } else {
        o[row * hd + t] = sum;
        if (t == 0) {
          m_out[row] = mb;
          l_out[row] = lsum;
        }
      }
    }
    __syncthreads();                         // red is rewritten next
  }
}

// grid (B * KV * R): one (b, kv head, q head) row over its nsplit partials
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ m_part,
                    const float* __restrict__ l_part, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int R, int hd, int nsplit, int normalize) {
  __shared__ float w[kMaxSplits];
  const int row = blockIdx.x;
  const int bg = row / R, h = row - bg * R;
  const long long first = (long long)bg * nsplit * R + h;  // split 0's row
  float mb = kEmpty;
  for (int s = 0; s < nsplit; ++s) mb = fmaxf(mb, m_part[first + s * R]);
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x)
    w[s] = expf(m_part[first + s * R] - mb);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= hd) return;
  float sum = 0.f, lsum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    sum += o_part[(first + s * R) * hd + t] * w[s];
    lsum += l_part[first + s * R] * w[s];
  }
  if (normalize) {
    o[(long long)row * hd + t] = sum / fmaxf(lsum, 1e-30f);
  } else {
    o[(long long)row * hd + t] = sum;
    if (t == 0) {
      m_out[row] = mb;
      l_out[row] = lsum;
    }
  }
}

template <typename T, int GP, int RT>
int launch(const float* q, const T* k, const T* v, float* o, float* m,
           float* l, int B, int KV, int R, int hd, long long k_b,
           long long k_s, long long v_b, long long v_s, int lo, int hi,
           int nsplit, int chunk, float scale, int normalize,
           cudaStream_t stream) {
  const dim3 grid((R + RT - 1) / RT, KV, B * nsplit);
  decode_split_kernel<T, GP, RT><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, m, l, B, KV, R, hd, k_b, k_s, v_b, v_s, lo, hi, chunk,
      scale, normalize);
  return (int)cudaGetLastError();
}

template <typename T, int GP>
int by_heads(const float* q, const T* k, const T* v, float* o, float* m,
             float* l, int B, int KV, int R, int hd, long long k_b,
             long long k_s, long long v_b, long long v_s, int lo, int hi,
             int nsplit, int chunk, float scale, int normalize,
             cudaStream_t stream) {
  if (R == 1)
    return launch<T, GP, 1>(q, k, v, o, m, l, B, KV, R, hd, k_b, k_s, v_b,
                            v_s, lo, hi, nsplit, chunk, scale, normalize,
                            stream);
  if (R == 2)
    return launch<T, GP, 2>(q, k, v, o, m, l, B, KV, R, hd, k_b, k_s, v_b,
                            v_s, lo, hi, nsplit, chunk, scale, normalize,
                            stream);
  return launch<T, GP, 4>(q, k, v, o, m, l, B, KV, R, hd, k_b, k_s, v_b, v_s,
                          lo, hi, nsplit, chunk, scale, normalize, stream);
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int B, int KV, int R, int hd, long long k_b,
             long long k_s, long long v_b, long long v_s, int lo, int hi,
             int nsplit, int chunk, float scale, int normalize,
             cudaStream_t stream) {
  const float* qq = static_cast<const float*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  float* oo = static_cast<float*>(o);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (hd <= 64)
    return by_heads<T, 8>(qq, kk, vv, oo, mm, ll, B, KV, R, hd, k_b, k_s,
                          v_b, v_s, lo, hi, nsplit, chunk, scale, normalize,
                          stream);
  return by_heads<T, 16>(qq, kk, vv, oo, mm, ll, B, KV, R, hd, k_b, k_s, v_b,
                         v_s, lo, hi, nsplit, chunk, scale, normalize,
                         stream);
}

}  // namespace

// The split pass. Strides in elements; the kv head's stride is hd and its
// values contiguous. Splits cover [lo, hi): split i takes lo + i chunk ..
// min(hi, lo + (i + 1) chunk), every split but an empty range's one
// non-empty. normalize (one split only): write o / max(l, 1e-30) and no m, l.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int KV, int R, int hd, long long k_b, long long k_s,
    long long v_b, long long v_s, int lo, int hi, int nsplit, int chunk,
    float scale, int normalize, int bf16, void* stream) {
  const long long len = (long long)hi - lo;
  if (B < 1 || KV < 1 || R < 1 || KV > 65535 || hd < 8 || hd > 128 ||
      hd % kVec || lo < 0 || len < 0 || nsplit < 1 ||
      (long long)B * nsplit > 65535 || chunk < 0 ||
      (normalize && nsplit != 1) ||
      (long long)nsplit * chunk < len ||
      (len > 0 && (long long)(nsplit - 1) * chunk >= len) ||
      (len == 0 && nsplit != 1))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return by_width<__nv_bfloat16>(q, k, v, o, m, l, B, KV, R, hd, k_b, k_s,
                                   v_b, v_s, lo, hi, nsplit, chunk, scale,
                                   normalize, (cudaStream_t)stream);
  return by_width<float>(q, k, v, o, m, l, B, KV, R, hd, k_b, k_s, v_b, v_s,
                         lo, hi, nsplit, chunk, scale, normalize,
                         (cudaStream_t)stream);
}

// The merge of the split pass's partials: rows = B * KV * R
extern "C" int repro_decode_attention_merge(
    const void* o_part, const void* m_part, const void* l_part, void* o,
    void* m, void* l, int rows, int R, int hd, int nsplit, int normalize,
    void* stream) {
  if (rows < 1 || R < 1 || rows % R || hd < 1 || hd > kMergeThreads ||
      nsplit < 1 || nsplit > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  decode_merge_kernel<<<rows, kMergeThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), R, hd, nsplit,
      normalize);
  return (int)cudaGetLastError();
}
