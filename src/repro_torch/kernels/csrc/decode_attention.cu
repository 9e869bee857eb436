// Single-token GQA attention over a ring KV cache, online softmax in fp32.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (line 66; body _decode_attn_kernel). It computes what the reference model's
// decode path computes with plain jnp (src/repro/models/layers.py::
// decode_attention, line 236): out[b, h] = softmax(q[b, h] . k[b, :L] /
// sqrt(hd)) . v[b, :L] with L = cache_len[b].
//
// Bound on an H100: device-memory bandwidth. A step reads each valid cache
// slot's key and value once, 2 * sum_b(L_b) * KV * hd * 4 bytes, and does
// 4 FLOPs per element read.
//
// Design. One CTA per (KV head, slot); it serves all G = H / KV query heads of
// its group at once, so each key and value is read once for G heads. The CTA
// walks only the slot's first L = min(cache_len, W) ring entries: invalid
// entries are skipped, not masked, so it reads fewer bytes than the TPU
// kernel, which streams the whole window. hd / 4 threads share one cache entry
// (one float4 each), so 256 threads keep 256 / (hd / 4) entries in flight; each
// such group keeps its own running max, sum and weighted value in registers,
// and the groups are combined once at the end in a fixed order. The result is
// deterministic. Split-KV (flash-decoding) across CTAs is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 8;
constexpr float kNeg = -3.4e38f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ cache_len,
                   float* __restrict__ out, int H, int W, int KV, int G, float scale) {
  constexpr int kLanes = HD / 4;             // threads per cache entry
  constexpr int kGroups = kThreads / kLanes; // entries in flight per CTA
  __shared__ float sm_m[kGroups][kMaxG];
  __shared__ float sm_l[kGroups][kMaxG];
  __shared__ __align__(16) float sm_acc[kGroups][kMaxG][HD];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, grp = tid / kLanes, lane = tid % kLanes;
  const int L = max(0, min(cache_len[b], W));

  float4 qv[kMaxG];
  float m[kMaxG], l[kMaxG];
  float4 acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    qv[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G)
      qv[g] = *reinterpret_cast<const float4*>(
          q + (static_cast<size_t>(b) * H + kvh * G + g) * HD + lane * 4);
    m[g] = kNeg;
    l[g] = 0.0f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t0 = 0; t0 < L; t0 += kGroups) {  // uniform trip count per CTA
    const int t = t0 + grp;
    const bool active = t < L;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (active) {
      const size_t off = ((static_cast<size_t>(b) * W + t) * KV + kvh) * HD + lane * 4;
      kv = *reinterpret_cast<const float4*>(kc + off);
      vv = *reinterpret_cast<const float4*>(vc + off);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s = qv[g].x * kv.x;
      s = fmaf(qv[g].y, kv.y, s);
      s = fmaf(qv[g].z, kv.z, s);
      s = fmaf(qv[g].w, kv.w, s);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (active) {
        s *= scale;
        const float mn = fmaxf(m[g], s);
        const float corr = expf(m[g] - mn);
        const float p = expf(s - mn);
        l[g] = l[g] * corr + p;
        acc[g].x = fmaf(p, vv.x, acc[g].x * corr);
        acc[g].y = fmaf(p, vv.y, acc[g].y * corr);
        acc[g].z = fmaf(p, vv.z, acc[g].z * corr);
        acc[g].w = fmaf(p, vv.w, acc[g].w * corr);
        m[g] = mn;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) { sm_m[grp][g] = m[g]; sm_l[grp][g] = l[g]; }
    *reinterpret_cast<float4*>(&sm_acc[grp][g][lane * 4]) = acc[g];
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, dim = e % HD;
    float M = kNeg;
    for (int j = 0; j < kGroups; ++j) M = fmaxf(M, sm_m[j][g]);
    float lsum = 0.0f, o = 0.0f;
    for (int j = 0; j < kGroups; ++j) {
      const float w = expf(sm_m[j][g] - M);
      lsum = fmaf(sm_l[j][g], w, lsum);
      o = fmaf(sm_acc[j][g][dim], w, o);
    }
    out[(static_cast<size_t>(b) * H + kvh * G + g) * HD + dim] = o / fmaxf(lsum, 1e-30f);
  }
}

}  // namespace

// q (B, H, hd), k/v cache (B, W, KV, hd), cache_len (B,) i32 -> out (B, H, hd),
// all f32 and contiguous. The caller guarantees hd in {64, 128}, H % KV == 0
// and H / KV <= 8.
extern "C" int decode_attention_launch(const float* q, const float* k, const float* v,
                                       const int* cache_len, float* out, int B, int H,
                                       int W, int KV, int hd, cudaStream_t stream) {
  const int G = H / KV;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  dim3 grid(KV, B);
  if (hd == 64)
    decode_attn_kernel<64><<<grid, kThreads, 0, stream>>>(q, k, v, cache_len, out, H, W, KV, G, scale);
  else
    decode_attn_kernel<128><<<grid, kThreads, 0, stream>>>(q, k, v, cache_len, out, H, W, KV, G, scale);
  return static_cast<int>(cudaGetLastError());
}
