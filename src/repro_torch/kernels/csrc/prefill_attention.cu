// Blockwise (flash) attention for prefill: causal with tile skipping, optional
// sliding window and bidirectional prefix, GQA; online softmax in fp32 and the
// S x S score matrix never built.
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas
// (line 90; body _prefill_kernel). On the card it also stands for the
// reference model's plain_attention / blockwise_attention
// (src/repro/models/layers.py, lines 218 and 133), which every re-prefill after
// a document swap runs.
//
// Bound on an H100: at the serving path's short contexts (S ~ 100-300, hd 64)
// neither bound is near: q, k, v and out are S*(2H + 2KV)*hd*4 bytes and the
// allowed (query, key) pairs cost 4*hd FLOPs per head on the fp32 CUDA cores;
// at long S the FLOPs bound it.
//
// Design. One CTA per (q tile of kBQ rows, batch * head). The q tile sits in
// shared memory; the CTA walks the k/v tiles in order and skips those wholly
// above the diagonal (unless they hold prefix keys) or wholly behind the
// window, as the TPU kernel does (prefill_attention.py:44-48). The TPU grid
// carried the softmax state from one kv grid step to the next; here the loop
// over kv tiles inside the CTA carries it. Eight threads own one query row:
// each scores four keys of the tile (a sequential fmaf chain over hd), the row
// max and sum are reduced across the eight with warp shuffles, and each thread
// accumulates hd / 8 output dimensions. Masked pairs contribute exactly zero,
// so a row whose first tiles are all masked never picks up weight from them.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr float kNeg = -3.4e38f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int S, int H,
                    int KV, int causal, int window, int prefix_len, float scale) {
  constexpr int kPad = HD + 1;
  constexpr int kDpt = HD / 8;               // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kBQ][kPad]
  float* ks = qs + kBQ * kPad;               // [kBK][kPad]
  float* vs = ks + kBK * kPad;               // [kBK][HD]
  float* ps = vs + kBK * HD;                 // [kBQ][kBK + 1]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_lo = blockIdx.x * kBQ;
  const int tid = threadIdx.x, r = tid / 8, sub = tid % 8;
  const int qi = q_lo + r;

  for (int f = tid; f < kBQ * (HD / 4); f += kThreads) {
    const int rr = f / (HD / 4), c4 = f % (HD / 4);
    const int s = q_lo + rr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S)
      x = *reinterpret_cast<const float4*>(q + ((static_cast<size_t>(b) * S + s) * H + h) * HD + c4 * 4);
    float* dst = qs + rr * kPad + c4 * 4;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }

  const int nk = (S + kBK - 1) / kBK;
  int lo = 0, hi = nk;
  if (causal) {
    int need = (q_lo + kBQ - 1) / kBK + 1;             // tiles reaching the diagonal
    if (prefix_len > 0) need = max(need, (prefix_len + kBK - 1) / kBK);
    hi = min(nk, need);
  }
  if (window > 0 && q_lo - window > 0) lo = (q_lo - window) / kBK;

  float m = kNeg, l = 0.0f;
  float acc[kDpt];
#pragma unroll
  for (int e = 0; e < kDpt; ++e) acc[e] = 0.0f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();                         // previous tile fully consumed
    for (int f = tid; f < kBK * (HD / 4); f += kThreads) {
      const int c = f / (HD / 4), c4 = f % (HD / 4);
      const int s = k_lo + c;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (s < S) {
        const size_t off = ((static_cast<size_t>(b) * S + s) * KV + kvh) * HD + c4 * 4;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      float* kd = ks + c * kPad + c4 * 4;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(vs + c * HD + c4 * 4) = vx;
    }
    __syncthreads();

    float sc[kBK / 8];
    bool ok[kBK / 8];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int c = sub + 8 * j, kidx = k_lo + c;
      const float* qr = qs + r * kPad;
      const float* kr = ks + c * kPad;
      float a = 0.0f;
#pragma unroll 16
      for (int i = 0; i < HD; ++i) a = fmaf(qr[i], kr[i], a);
      bool allowed = kidx < S;
      if (causal) allowed = allowed && (kidx <= qi || (qi < prefix_len && kidx < prefix_len));
      if (window > 0) allowed = allowed && (kidx > qi - window);
      sc[j] = a * scale;
      ok[j] = allowed;
      if (allowed) mx = fmaxf(mx, sc[j]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p = ok[j] ? expf(sc[j] - mn) : 0.0f;
      ps[r * (kBK + 1) + sub + 8 * j] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = mn;
    __syncwarp();                            // the row's eight threads share one warp
#pragma unroll
    for (int e = 0; e < kDpt; ++e) acc[e] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r * (kBK + 1) + c];
      const float* vr = vs + c * HD + sub * kDpt;
#pragma unroll
      for (int e = 0; e < kDpt; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vr + e);
        acc[e] = fmaf(p, x.x, acc[e]);
        acc[e + 1] = fmaf(p, x.y, acc[e + 1]);
        acc[e + 2] = fmaf(p, x.z, acc[e + 2]);
        acc[e + 3] = fmaf(p, x.w, acc[e + 3]);
      }
    }
    __syncwarp();                            // ps row read before the next write
  }

  if (qi < S) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * S + qi) * H + h) * HD + sub * kDpt;
#pragma unroll
    for (int e = 0; e < kDpt; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(acc[e] * inv, acc[e + 1] * inv, acc[e + 2] * inv, acc[e + 3] * inv);
  }
}

template <int HD>
void launch(const float* q, const float* k, const float* v, float* out, int B, int S,
            int H, int KV, int causal, int window, int prefix_len, cudaStream_t stream) {
  constexpr int kPad = HD + 1;
  const size_t smem = sizeof(float) * (kBQ * kPad + kBK * kPad + kBK * HD + kBQ * (kBK + 1));
  cudaFuncSetAttribute(prefill_attn_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  prefill_attn_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, out, S, H, KV, causal,
                                                            window, prefix_len, scale);
}

}  // namespace

// q (B, S, H, hd), k/v (B, S, KV, hd) -> out (B, S, H, hd), all f32 and
// contiguous. The caller guarantees hd in {64, 128} and H % KV == 0.
extern "C" int prefill_attention_launch(const float* q, const float* k, const float* v,
                                        float* out, int B, int S, int H, int KV, int hd,
                                        int causal, int window, int prefix_len,
                                        cudaStream_t stream) {
  if (hd == 64)
    launch<64>(q, k, v, out, B, S, H, KV, causal, window, prefix_len, stream);
  else
    launch<128>(q, k, v, out, B, S, H, KV, causal, window, prefix_len, stream);
  return static_cast<int>(cudaGetLastError());
}
