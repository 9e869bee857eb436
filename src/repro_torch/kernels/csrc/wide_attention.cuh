// Attention of one query row over a run of cache or sequence entries at a
// head dim above 256: the wide-head path of B2 (decode_attention.cu) and B3
// (prefill_attention.cu). Both kernels' instances stop at hd 256, whose
// arrays and tiles are sized at compile time; this path takes any hd that
// is a multiple of 4 (the wrappers zero-pad the rest, with the real hd's
// softmax scale), and the hd <= 256 instances never run it.
//
// Replaces, above hd 256: src/repro/kernels/decode_attention.py::
// decode_attention_pallas (line 66) and src/repro/kernels/prefill_attention.py::
// prefill_attention_pallas (line 90), which are shaped by hd alone.
//
// Bound on an H100: device-memory bandwidth for decode (each valid key and
// value read once, about 0.5 FLOP a byte), the fp32 CUDA cores for a long
// prefill. No config of the repo has hd > 256, so the design is the simple
// one and not a fast one: one CTA of kThreads per (query row, head) walks
// its entries in tiles of kTile. Warp w scores entries w, w + kWarps, ... of
// a tile: its lanes walk the float4 columns lane, lane + 32, ... (one fmaf
// chain each) and a shuffle tree sums them. Warp 0 then turns the tile's 32
// scores into online-softmax weights (a max and a sum over its lanes), and
// each thread folds the weights into its own float4 columns of the
// accumulator, which is the output row itself in device memory, so no array
// is sized by hd and any hd fits. A thread reads back only the columns it
// wrote, in program order, so the accumulator needs no barrier. The walk,
// the tiles and every sum depend only on the row's own entries and hd: an
// output row is the same bytes at any batch size. Entries past the run
// (decode: index >= cache_len) are never read; a masked entry's weight is 0
// and its value is not read either.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wide {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                   // entries per tile: one a lane of warp 0
constexpr float kNeg = -3.4e38f;            // the running max before any entry
constexpr unsigned kAll = 0xffffffffu;

// out[0 .. hd) = softmax over the allowed entries t in [t_lo, t_hi) of
// scale * q . k[t], times v[t]; entry t's key starts at k + t * stride
// (floats), its value at v + t * stride. With uniform every allowed entry
// scores 0 (equal weights: the mean of v) and no key is read. The caller
// guarantees some entry in the run is allowed.
template <class Allowed>
__device__ void attend_row(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, size_t stride, int t_lo, int t_hi,
                           Allowed allowed, bool uniform, float scale, int hd,
                           float* __restrict__ out) {
  __shared__ float s_p[kTile];
  __shared__ float s_corr, s_l;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nvec = hd / 4;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int c = tid; c < nvec; c += kThreads) o4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNeg, l = 0.0f;                 // warp 0's running max and sum

  for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
    for (int j = warp; j < kTile; j += kWarps) {
      const int t = t0 + j;
      const bool ok = t < t_hi && allowed(t);   // the same for the whole warp
      float s = -INFINITY;                      // a masked entry
      if (ok) {
        s = 0.0f;
        if (!uniform) {
          const float4* k4 = reinterpret_cast<const float4*>(k + static_cast<size_t>(t) * stride);
          float a = 0.0f;
          for (int c = lane; c < nvec; c += 32) {
            const float4 x = k4[c], y = q4[c];
            a = fmaf(y.x, x.x, a);
            a = fmaf(y.y, x.y, a);
            a = fmaf(y.z, x.z, a);
            a = fmaf(y.w, x.w, a);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kAll, a, o);
          s = a * scale;
        }
      }
      if (lane == 0) s_p[j] = s;
    }
    __syncthreads();
    if (warp == 0) {
      const float s = s_p[lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
      const float mn = fmaxf(m, mx);
      const float corr = expf(m - mn);
      const float p = s == -INFINITY ? 0.0f : expf(s - mn);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kAll, ps, o);
      l = fmaf(l, corr, ps);
      m = mn;
      s_p[lane] = p;
      if (lane == 0) {
        s_corr = corr;
        s_l = l;
      }
    }
    __syncthreads();
    const float corr = s_corr;
    const int n = min(kTile, t_hi - t0);
    for (int c = tid; c < nvec; c += kThreads) {
      float4 a = o4[c];
      a = make_float4(a.x * corr, a.y * corr, a.z * corr, a.w * corr);
      for (int j = 0; j < n; ++j) {
        const float p = s_p[j];
        if (p == 0.0f) continue;            // masked: adds exactly 0, read nothing
        const float4 x =
            reinterpret_cast<const float4*>(v + static_cast<size_t>(t0 + j) * stride)[c];
        a = make_float4(fmaf(p, x.x, a.x), fmaf(p, x.y, a.y), fmaf(p, x.z, a.z),
                        fmaf(p, x.w, a.w));
      }
      o4[c] = a;
    }
    __syncthreads();                        // s_p is the next tile's
  }
  const float inv = 1.0f / fmaxf(s_l, 1e-30f);
  for (int c = tid; c < nvec; c += kThreads) {
    const float4 a = o4[c];
    o4[c] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

}  // namespace wide
