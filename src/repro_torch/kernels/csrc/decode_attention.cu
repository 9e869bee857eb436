// Single-token GQA attention over a ring KV cache, split over fixed chunks of
// the cache (flash-decoding), fp32 throughout.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (line 66; body _decode_attn_kernel). It computes what the reference model's
// decode path computes with plain jnp (src/repro/models/layers.py::
// decode_attention, line 236): out[b, h] = softmax(q[b, h] . k[b, :L] /
// sqrt(hd)) . v[b, :L] with L = min(cache_len[b], W). With cache_len <= 0
// every entry is masked, the reference's softmax weights are all equal, and
// the output is the mean of v over the whole window W: the kernel takes
// L = W with every score 0.
//
// Bound on an H100: device-memory bandwidth. A step reads each valid cache
// entry's key and value once, 2 * sum_b(L_b) * KV * hd * 4 bytes, at about
// 0.5 FLOP per byte for G = H / KV = 1; fp32 fmaf on the CUDA cores is
// enough (no tensor cores, no TF32).
//
// Design. What bounds the time is how many bytes are in flight and how long
// the chain of dependent steps after them is, not the arithmetic. A slot's
// valid entries are cut into fixed chunks of kChunk = 64 entries (boundaries
// at 0, 64, 128, ...), and one CTA serves one (chunk, KV head, slot): at B=1,
// L=512 and 16 KV heads that is 128 CTAs, where one CTA per (KV head, slot)
// gave 16. Each warp owns 8 entries of the chunk and issues every load of
// their keys and values into registers at once (the whole chunk is in flight
// before the first use): a key over 4 lanes, so a score is 2 shuffles away,
// and a value row over min(32, pow2(hd / 4)) lanes, one float4 column each
// (two at hd > 128; lanes past hd / 4 idle), so P.V needs at most three
// shuffles. The warp then walks the G query heads of its group (q
// from shared memory, in tiles of kHeadTile heads): score, max and sum over
// its 8 entries and P.V, all by fixed shuffle trees, with no block barrier.
// One barrier per tile, then a thread per (head, float4 column) merges the
// warps in order. Entries at index >= L are never read. A slot of one chunk
// writes its output directly. Otherwise each chunk writes its (m, l, acc) to
// the scratch that the wrapper allocates, and the last CTA of the (KV head,
// slot) to arrive -- a ticket counter in a per-device int32 buffer, zeroed
// once by the wrapper and reset by that CTA -- merges the chunks in order
// 0..n-1, loading up to kBatch chunks' partials at once. Chunk and warp
// boundaries and the order of every sum depend only on the slot's own L and
// on G and hd, never on B, W or which CTA finishes last: a slot's output is
// the same bytes at any batch size, and repeated calls give the same bytes.
// No float atomics. One launch per call, no other runtime call.
//
// Head dims: the kernel is instantiated for hd in {16, 32, 64, 112, 128,
// 256} (kHeads); the wrapper zero-pads any other hd <= 256 to the next
// instance, and the softmax scale comes from the call (the real hd's), so a
// padded lane adds 0 to every score and gives a 0 output column that the
// wrapper drops. The per-HD shapes (Dims) keep every array static: at hd
// 256 a pass covers 4 query heads, so sQ and sAcc stay at 36 KB.
//
// Above hd 256 (a multiple of 4, the wrapper pads the rest) a call runs
// decode_wide_kernel, split-KV as above but shaped for rows of 1-2 KB that
// no warp can hold in registers. A slot's valid entries are cut into
// chunks of kWideBlock = 32 entries, or of a larger multiple of 32 where
// that keeps a slot at kWideMaxChunks = 64 chunks at most (L = 16,384: 256
// entries a chunk), so the chunk size depends on L alone and the merge
// reads at most 64 partials. One CTA of 256 threads serves one (chunk, KV
// head, slot) and all G query heads of the group, 16 a pass: each key and
// value byte is read once a group. What bounds it is latency, not
// arithmetic: each tile's compute sits between two barriers on the path
// of the next tile's copy, so nothing but the copy engine spends an
// instruction on a load, and many short CTAs (8 tiles at L <= 2,048) keep
// every SM busy while others ramp up or merge. The chunk streams through a
// 4-slot ring (wide_attention.cuh) in tiles of 8 entries by one column
// slice, asked for by one warp with bulk copies: for each block of 32
// entries the keys' tiles, then the values'. The pass's q rows sit in
// shared memory (hd <= 512; read through L1 above). Scoring, warp w takes
// entry w of a key tile, its lanes the float4 columns, a fixed shuffle
// tree finishing each score; warp w then turns heads w and w + 8 of the
// block's 32 scores into online-softmax weights (a lane an entry). Each
// thread keeps the accumulator of one float4 column for every other head
// of the pass in registers and folds in each value row once. Each chunk
// writes its (m, l, acc) to the wrapper's scratch and the last CTA of the
// (KV head, slot) merges them in chunk order, as above; a one-chunk slot
// writes its row. 3 tiles (48 KB at hd 512) are in flight a CTA, two CTAs
// an SM.
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "smem_attr.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 8;                  // cache entries per warp
constexpr int kChunk = kWarps * kWarpRows;    // cache entries per CTA
constexpr int kBatch = 8;                     // chunks whose partials the merge loads at once
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -3.4e38f;

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y), fmaf(p, v.z, a.z),
                     fmaf(p, v.w, a.w));
}

__device__ __forceinline__ float4 div4(float4 a, float l) {
  return make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
}

// Take a ticket: an atomic add at device scope that releases this CTA's
// partial (its writes precede the call through a __syncthreads) and
// acquires those of the CTAs that took the earlier tickets.
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The wide-head kernel's merge, decode_attn_kernel's with hd known at run
// time: after every chunk of a (KV head, slot) wrote its partials (pacc
// [n][G][hd], pml [n][G][2]), the CTA that takes the last ticket merges the
// n chunks in order 0..n-1, a thread per (head, float4 column), loading up
// to kBatch chunks' partials at once, writes the group's G rows out_g
// [G][hd] and resets the ticket; every other CTA returns. The order of
// every sum depends on n, G and hd only.
__device__ __forceinline__ void merge_chunks(const float* pacc, const float* pml, int* ticket,
                                             float* out_g, int n, int G, int hd) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) s_last = take_ticket(ticket) == n - 1;
  __syncthreads();
  if (!s_last) return;
  const int nvec = hd / 4;
  for (int e = threadIdx.x; e < G * nvec; e += kThreads) {
    const int g = e / nvec, x = e % nvec;
    float M = kNeg, lsum = 0.0f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < n; r0 += kBatch) {    // one L2 round trip per kBatch chunks
      float2 ml[kBatch];
      float4 a[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        ml[i] = make_float2(kNeg, 0.0f);
        a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + i < n) {
          const size_t pg = static_cast<size_t>(r0 + i) * G + g;
          ml[i] = __ldcg(reinterpret_cast<const float2*>(pml + pg * 2));
          a[i] = __ldcg(reinterpret_cast<const float4*>(pacc + pg * hd + x * 4));
        }
      }
      float Mb = M;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) Mb = fmaxf(Mb, ml[i].x);
      const float f = expf(M - Mb);             // rescale the earlier batches (0 at first)
      lsum *= f;
      o = make_float4(o.x * f, o.y * f, o.z * f, o.w * f);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r0 + i < n) {
          const float w = expf(ml[i].x - Mb);
          lsum = fmaf(ml[i].y, w, lsum);
          o = fma4(w, a[i], o);
        }
      }
      M = Mb;
    }
    *reinterpret_cast<float4*>(out_g + static_cast<size_t>(g) * hd + x * 4) = div4(o, lsum);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// How a warp lays a cache row of HD floats over its lanes.
template <int HD>
struct Dims {
  static_assert(HD % 4 == 0 && HD >= 16 && HD <= 256, "HD: a multiple of 4 in [16, 256]");
  static constexpr int kVec = HD / 4;                       // float4 per cache row
  static constexpr int kKeyVec = (kVec + 3) / 4;            // float4 of a key per lane (4 lanes a key)
  static constexpr int kVP = kVec >= 32 ? 32 : pow2_at_least(kVec);  // lanes per value row
  static constexpr int kVCols = (kVec + 31) / 32;           // float4 columns per lane
  static constexpr int kRowsPerLoad = 32 / kVP;             // value rows one warp-wide load covers
  static constexpr int kValRows = kWarpRows / kRowsPerLoad; // value rows per lane
  static constexpr int kHeadTile = kThreads / kVec < 8 ? kThreads / kVec : 8;  // heads a pass
};

// registers: hd 256 keeps 32 float4 of keys and values per lane (1 CTA an
// SM by registers), hd 112 and 128 keep 15-16 (2), hd <= 64 at most 8 (3)
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : (HD <= 128 ? 2 : 1))
decode_attn_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ cache_len,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ tickets, int H, int W, int KV, int G, float scale) {
  using D = Dims<HD>;
  constexpr int kVec = D::kVec, kKeyVec = D::kKeyVec, kVP = D::kVP, kVCols = D::kVCols;
  constexpr int kRowsPerLoad = D::kRowsPerLoad, kValRows = D::kValRows;
  constexpr int kHeadTile = D::kHeadTile;
  __shared__ __align__(16) float sQ[kHeadTile][HD];
  __shared__ __align__(16) float sAcc[kWarps][kHeadTile][HD];
  __shared__ float sM[kWarps][kHeadTile];
  __shared__ float sL[kWarps][kHeadTile];
  __shared__ int s_last;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = cache_len[b];
  const bool uniform = len <= 0;                // every entry masked: equal weights
  const int L = uniform ? W : min(len, W);
  const int t0 = c * kChunk;
  if (t0 >= L) return;
  const int n = (L + kChunk - 1) / kChunk;      // this slot's chunks
  const int valid = min(kChunk, L - t0);        // entries of this chunk
  const int nw = (valid + kWarpRows - 1) / kWarpRows;  // warps that hold an entry

  const float* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
  auto copy_q = [&](int g0, int gn) {
    for (int i = tid; i < gn * kVec; i += kThreads)
      cp_async16(&sQ[0][0] + i * 4, qb + static_cast<size_t>(g0) * HD + i * 4, 16);
    cp_async_commit();
  };
  copy_q(0, min(kHeadTile, G));

  // this warp's entries w0 .. w0 + 7 of the chunk, every load issued here
  const int w0 = warp * kWarpRows;
  const int ke = lane / 4, kq = lane % 4;       // key: entry, quarter (float4 kq + 4i)
  const int vr = lane / kVP, vx = lane % kVP;   // value: first row, first float4 column
  const size_t stride = static_cast<size_t>(KV) * HD;  // floats between entries
  const size_t base = ((static_cast<size_t>(b) * W + t0 + w0) * KV + kvh) * HD;
  const bool key_ok = w0 + ke < valid;
  float4 kr[kKeyVec], vv[kValRows][kVCols];
#pragma unroll
  for (int i = 0; i < kKeyVec; ++i)
    kr[i] = key_ok && !uniform && kq + 4 * i < kVec  // equal scores read no key
                ? *reinterpret_cast<const float4*>(kc + base + ke * stride + (kq + 4 * i) * 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kValRows; ++j) {
    const int e = vr + kRowsPerLoad * j;
#pragma unroll
    for (int cc = 0; cc < kVCols; ++cc) {
      const int col = vx + 32 * cc;
      vv[j][cc] = w0 + e < valid && col < kVec
                      ? *reinterpret_cast<const float4*>(vc + base + e * stride + col * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const size_t slot_row = static_cast<size_t>(b) * KV + kvh;   // (slot, KV head)
  float* pacc = part + slot_row * nc * G * HD;                    // [nc][G][HD]
  float* pml = part + static_cast<size_t>(gridDim.z) * KV * nc * G * HD
               + slot_row * nc * G * 2;                           // [nc][G][2]

  for (int g0 = 0; g0 < G; g0 += kHeadTile) {
    const int gn = min(kHeadTile, G - g0);
    if (g0 > 0) {
      __syncthreads();                          // the last tile is done with sQ, sAcc
      copy_q(g0, gn);
    }
    cp_async_wait<0>();
    __syncthreads();

    if (warp < nw) {
      for (int g = 0; g < gn; ++g) {
        const float4* qr = reinterpret_cast<const float4*>(sQ[g]);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kKeyVec; ++i) {
          if (kq + 4 * i < kVec) {            // hd / 4 not a multiple of 4: a short key
            const float4 a = qr[kq + 4 * i];
            s = fmaf(a.x, kr[i].x, s);
            s = fmaf(a.y, kr[i].y, s);
            s = fmaf(a.z, kr[i].z, s);
            s = fmaf(a.w, kr[i].w, s);
          }
        }
        s += __shfl_xor_sync(kAll, s, 1);
        s += __shfl_xor_sync(kAll, s, 2);
        s = key_ok ? (uniform ? 0.0f : s * scale) : kNeg;
        // max and sum over the warp's 8 entries (lane bits 2-4)
        float m = s;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
        const float p = expf(s - m);
        float l = p;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) l += __shfl_xor_sync(kAll, l, o);
        float4 acc[kVCols];
#pragma unroll
        for (int cc = 0; cc < kVCols; ++cc) acc[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kValRows; ++j) {
          const float pj = __shfl_sync(kAll, p, 4 * (vr + kRowsPerLoad * j));
#pragma unroll
          for (int cc = 0; cc < kVCols; ++cc) acc[cc] = fma4(pj, vv[j][cc], acc[cc]);
        }
#pragma unroll
        for (int cc = 0; cc < kVCols; ++cc) {
#pragma unroll
          for (int o = kVP; o < 32; o <<= 1) {  // rows split over lane groups
            acc[cc].x += __shfl_xor_sync(kAll, acc[cc].x, o);
            acc[cc].y += __shfl_xor_sync(kAll, acc[cc].y, o);
            acc[cc].z += __shfl_xor_sync(kAll, acc[cc].z, o);
            acc[cc].w += __shfl_xor_sync(kAll, acc[cc].w, o);
          }
          const int col = vx + 32 * cc;
          if (lane < kVP && col < kVec)
            *reinterpret_cast<float4*>(&sAcc[warp][g][col * 4]) = acc[cc];
        }
        if (lane == 0) {
          sM[warp][g] = m;
          sL[warp][g] = l;
        }
      }
    }
    __syncthreads();

    // merge the chunk's warps in order, a thread per (head, float4 column)
    if (tid < gn * kVec) {
      const int g = tid / kVec, x = tid % kVec;
      float M = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w < nw) M = fmaxf(M, sM[w][g]);
      float lc = 0.0f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < nw) {
          const float f = expf(sM[w][g] - M);
          lc = fmaf(sL[w][g], f, lc);
          o = fma4(f, *reinterpret_cast<const float4*>(&sAcc[w][g][x * 4]), o);
        }
      }
      if (n == 1) {
        *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * HD
                                   + x * 4) = div4(o, lc);
      } else {
        const size_t pg = static_cast<size_t>(c) * G + g0 + g;
        *reinterpret_cast<float4*>(pacc + pg * HD + x * 4) = o;
        if (x == 0) *reinterpret_cast<float2*>(pml + pg * 2) = make_float2(M, lc);
      }
    }
  }
  if (n == 1) return;

  // the last chunk of this (KV head, slot) to finish merges all n in order
  __syncthreads();
  if (tid == 0) s_last = take_ticket(tickets + slot_row) == n - 1;
  __syncthreads();
  if (!s_last) return;
  for (int e = tid; e < G * kVec; e += kThreads) {
    const int g = e / kVec, x = e % kVec;
    float M = kNeg, lsum = 0.0f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < n; r0 += kBatch) {    // one L2 round trip per kBatch chunks
      float2 ml[kBatch];
      float4 a[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        ml[i] = make_float2(kNeg, 0.0f);
        a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + i < n) {
          const size_t pg = static_cast<size_t>(r0 + i) * G + g;
          ml[i] = __ldcg(reinterpret_cast<const float2*>(pml + pg * 2));
          a[i] = __ldcg(reinterpret_cast<const float4*>(pacc + pg * HD + x * 4));
        }
      }
      float Mb = M;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) Mb = fmaxf(Mb, ml[i].x);
      const float f = expf(M - Mb);             // rescale the earlier batches (0 at first)
      lsum *= f;
      o = make_float4(o.x * f, o.y * f, o.z * f, o.w * f);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r0 + i < n) {
          const float w = expf(ml[i].x - Mb);
          lsum = fmaf(ml[i].y, w, lsum);
          o = fma4(w, a[i], o);
        }
      }
      M = Mb;
    }
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * H + kvh * G + g) * HD + x * 4) =
        div4(o, lsum);
  }
  if (tid == 0) tickets[slot_row] = 0;
}

// hd > 256 (the design note at the top): one CTA per (chunk, KV head, slot)
// and 16 query heads of the group a pass
constexpr int kWideBlock = 32;        // entries a block (one softmax step, a lane each),
                                      // and the shortest chunk
constexpr int kWideMaxChunks = 64;    // a slot's chunks at most
constexpr int kWideSub = 8;           // entries a tile: one a warp when scoring
constexpr int kWideHeads = 16;        // query heads a pass
constexpr int kWideSubs = kWideBlock / kWideSub;   // tiles of one kind a block
constexpr int kWideTile = kWideSub * wide::kPitch; // floats of a tile
// the ring, then (hd <= 512) the pass's q rows: kWideSmem + 4 * kPitch a head
constexpr int kWideSmem = 4 * wide::kStages * kWideTile;

// registers: 16 partial scores, 8 float4 accumulators (two CTAs an SM).
// kOneSlice: hd <= 512, every row one column slice.
template <bool kOneSlice>
__global__ void __launch_bounds__(wide::kThreads, 2)
decode_wide_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ cache_len,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ tickets, int H, int W, int KV, int G, int hd,
                   float scale) {
  using wide::kPitch;
  using wide::kSlice;
  using wide::kStages;
  constexpr int kAhead = kStages - 1;                   // tiles in flight past the one in use
  extern __shared__ __align__(16) float ring[];          // [kStages][kWideSub][kPitch]
  float* sQ = ring + kStages * kWideTile;               // [min(G, 16)][kPitch]: kOneSlice
  __shared__ float sP[kWideHeads][kWideBlock];          // a block's scores, then weights
  __shared__ float sM[kWideHeads], sL[kWideHeads], sCorr[kWideHeads];
  __shared__ __align__(8) unsigned long long sBar[kStages + 1];   // the ring's, sQ's

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = cache_len[b];
  const bool uniform = len <= 0;                // every entry masked: equal weights
  const int L = uniform ? W : min(len, W);
  // whole blocks, so that the slot has kWideMaxChunks chunks at most
  const int span = kWideBlock * kWideMaxChunks;
  const int chunk = kWideBlock * ((L + span - 1) / span);
  const int n = (L + chunk - 1) / chunk;        // this slot's chunks
  if (c >= n) return;
  const int t0 = c * chunk;
  const int valid = min(chunk, L - t0);         // entries of this chunk
  const int nb = (valid + kWideBlock - 1) / kWideBlock;   // blocks of 32 entries
  const int nvec = hd / 4, ns = kOneSlice ? 1 : (nvec + kSlice - 1) / kSlice;
  // a block's tiles: kWideSubs x ns key tiles (none at equal scores), then
  // kWideSubs value tiles of the pass's column slice; a pass: nb blocks;
  // the passes: (16 heads, column slice) pairs
  const int nK = uniform ? 0 : kWideSubs * ns;
  const int tpb = nK + kWideSubs;
  const int T = (G + kWideHeads - 1) / kWideHeads * ns * nb * tpb;

  const size_t stride = static_cast<size_t>(KV) * hd;   // floats between entries
  const size_t base = (static_cast<size_t>(b) * W * KV + kvh) * hd + t0 * stride;
  const float* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd;
  const size_t slot_row = static_cast<size_t>(b) * KV + kvh;       // (slot, KV head)
  float* pacc = part + slot_row * nc * G * hd;                     // [nc][G][hd]
  float* pml = part + static_cast<size_t>(gridDim.z) * KV * nc * G * hd
               + slot_row * nc * G * 2;                            // [nc][G][2]

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wide::bar_init(&sBar[i]);
    wide::bar_init_fence();
  }
  __syncthreads();
  wide::Cursor ld;                              // warp 0: the next tile to ask for
  auto fetch = [&](int i) {
    const bool key = ld.k < nK;
    const int sub = key ? (kOneSlice ? ld.k : ld.k / ns) : ld.k - nK;
    const int s = kOneSlice ? 0 : (key ? ld.k % ns : ld.pass % ns);
    const int e0 = ld.blk * kWideBlock + sub * kWideSub;   // the tile's first entry
    wide::fetch_tile(ring + (i % kStages) * kWideTile,
                     (key ? kc : vc) + base + e0 * stride + 4 * s * kSlice, stride,
                     max(0, min(kWideSub, valid - e0)), min(kSlice, nvec - s * kSlice),
                     &sBar[i % kStages]);
    ld.next(tpb, nb);
  };
  const int gq = min(G, kWideHeads);
  if (warp == 0) {
    // the first pass's q rows (one pass when G <= 16), with the first tiles
    if (kOneSlice && !uniform) wide::fetch_tile(sQ, qg, hd, gq, nvec, &sBar[kStages]);
    for (int i = 0; i < kAhead && i < T; ++i) fetch(i);
  }

  float sacc[kWideHeads];                       // scoring: warp's entry x each head
  float4 acc[kWideHeads / 2];                   // column x of heads hp, hp + 2, ...
  const int x = tid % kSlice, hp = tid / kSlice;
  wide::Cursor cu;
  for (int i = 0; i < T; ++i, cu.next(tpb, nb)) {
    wide::bar_wait(&sBar[i % kStages], (i / kStages) & 1);
    __syncthreads();                            // tile i landed; tile i - 1 consumed
    if (warp == 0 && i + kAhead < T) fetch(i + kAhead);
    const int blk = cu.blk, k = cu.k;
    const int g0 = (kOneSlice ? cu.pass : cu.pass / ns) * kWideHeads;
    const int gn = min(kWideHeads, G - g0);
    const float* tile = ring + (i % kStages) * kWideTile;
    if (k < nK) {                               // keys: partial scores over one slice
      const int sub = kOneSlice ? k : k / ns, s = kOneSlice ? 0 : k % ns;
      const int col0 = s * kSlice, ncols = min(kSlice, nvec - col0);
      if (s == 0) {
#pragma unroll
        for (int g = 0; g < kWideHeads; ++g) sacc[g] = 0.0f;
      }
      const float* kr = tile + warp * kPitch;
      // q: staged in shared memory at hd <= 512 (a pass's rows, reloaded for
      // each further pass), read through L1 above
      if (kOneSlice && blk == 0 && sub == 0) {
        // (the last pass's reads of sQ ended before this tile's barrier)
        if (cu.pass > 0 && warp == 0)
          wide::fetch_tile(sQ, qg + static_cast<size_t>(g0) * hd, hd, gn, nvec, &sBar[kStages]);
        wide::bar_wait(&sBar[kStages], cu.pass & 1);
      }
      const float4* q4 = reinterpret_cast<const float4*>(qg) + static_cast<size_t>(g0) * nvec
                         + col0;
#pragma unroll
      for (int j = 0; j < kSlice / 32; ++j) {
        const int xc = lane + 32 * j;
        if (xc < ncols) {
          const float4 kv = wide::ld4(kr + 4 * xc);
#pragma unroll
          for (int g = 0; g < kWideHeads; ++g)
            if (g < gn)
              sacc[g] = wide::dot4(kOneSlice ? wide::ld4(sQ + g * kPitch + 4 * xc)
                                             : __ldg(q4 + g * nvec + xc),
                                   kv, sacc[g]);
        }
      }
      if (s == ns - 1) {                        // a row past the chunk scores garbage: masked below
#pragma unroll
        for (int g = 0; g < kWideHeads; ++g) {
          if (g < gn) {
            float a = sacc[g];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kAll, a, o);
            if (lane == 0) sP[g][sub * kWideSub + warp] = a * scale;
          }
        }
      }
      continue;
    }
    const int sub = k - nK;
    if (sub == 0) {                             // the block's scores -> weights
      const bool ok = blk * kWideBlock + lane < valid;
      for (int g = warp; g < gn; g += kWarps) {
        const float sc = ok ? (uniform ? 0.0f : sP[g][lane]) : kNeg;
        const float m_old = blk == 0 ? kNeg : sM[g];
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
        const float mn = fmaxf(m_old, mx);
        const float corr = expf(m_old - mn);
        const float p = ok ? expf(sc - mn) : 0.0f;
        float ps = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kAll, ps, o);
        sP[g][lane] = p;
        __syncwarp();
        if (lane == 0) {
          sL[g] = blk == 0 ? ps : fmaf(sL[g], corr, ps);
          sM[g] = mn;
          sCorr[g] = corr;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWideHeads / 2; ++j) {
        const int g = hp + 2 * j;
        if (g < gn) {
          const float f = blk == 0 ? 0.0f : sCorr[g];
          acc[j] = blk == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                            : make_float4(acc[j].x * f, acc[j].y * f, acc[j].z * f,
                                          acc[j].w * f);
        }
      }
    }
    const int col0 = kOneSlice ? 0 : cu.pass % ns * kSlice;
    const int ncols = min(kSlice, nvec - col0);
    const int nv = valid - (blk * kWideBlock + sub * kWideSub);   // the tile's rows read
    if (x < ncols) {                            // values: P . V over one slice
#pragma unroll
      for (int t = 0; t < kWideSub; ++t) {
        if (t < nv) {
          const float4 v = wide::ld4(tile + t * kPitch + 4 * x);
#pragma unroll
          for (int j = 0; j < kWideHeads / 2; ++j) {
            const int g = hp + 2 * j;
            if (g < gn) acc[j] = fma4(sP[g][sub * kWideSub + t], v, acc[j]);
          }
        }
      }
    }
    if (blk == nb - 1 && sub == kWideSubs - 1) {   // the pass's last tile: its rows out
      if (x < ncols) {
#pragma unroll
        for (int j = 0; j < kWideHeads / 2; ++j) {
          const int g = hp + 2 * j;
          if (g < gn) {
            const size_t col = 4 * static_cast<size_t>(col0 + x);
            if (n == 1)
              *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * H + kvh * G + g0 + g)
                                                   * hd + col) = div4(acc[j], sL[g]);
            else
              *reinterpret_cast<float4*>(pacc + (static_cast<size_t>(c) * G + g0 + g) * hd
                                         + col) = acc[j];
          }
        }
      }
      if (n > 1 && col0 == 0 && tid < gn)
        *reinterpret_cast<float2*>(pml + (static_cast<size_t>(c) * G + g0 + tid) * 2) =
            make_float2(sM[tid], sL[tid]);
    }
  }
  if (n == 1) return;
  merge_chunks(pacc, pml, tickets + slot_row,
               out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd, n, G, hd);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* cache_len, float* out,
           float* part, int* tickets, int B, int H, int W, int KV, float scale,
           cudaStream_t stream) {
  dim3 grid((W + kChunk - 1) / kChunk, KV, B);
  decode_attn_kernel<HD><<<grid, kThreads, 0, stream>>>(q, k, v, cache_len, out, part,
                                                        tickets, H, W, KV, H / KV, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const float* q, const float* k, const float* v, const int* cache_len,
                float* out, float* part, int* tickets, int B, int H, int W, int KV, int hd,
                float scale, cudaStream_t stream) {
  const int nc = (W + kWideBlock - 1) / kWideBlock;
  dim3 grid(nc < kWideMaxChunks ? nc : kWideMaxChunks, KV, B);
  // once per instantiation and device
  if (hd <= 4 * wide::kSlice) {
    const int G = H / KV;
    const int smem = kWideSmem + 4 * wide::kPitch * (G < kWideHeads ? G : kWideHeads);
    static bool smem_allowed[kMaxDevices] = {};
    allow_smem(smem_allowed, decode_wide_kernel<true>,
               kWideSmem + 4 * wide::kPitch * kWideHeads);
    decode_wide_kernel<true><<<grid, wide::kThreads, smem, stream>>>(
        q, k, v, cache_len, out, part, tickets, H, W, KV, H / KV, hd, scale);
  } else {
    static bool smem_allowed[kMaxDevices] = {};
    allow_smem(smem_allowed, decode_wide_kernel<false>, kWideSmem);
    decode_wide_kernel<false><<<grid, wide::kThreads, kWideSmem, stream>>>(
        q, k, v, cache_len, out, part, tickets, H, W, KV, H / KV, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, hd), k/v cache (B, W, KV, hd), cache_len (B,) i32 -> out (B, H, hd),
// all f32 and contiguous. part: the chunks' partials, B * H * nc * (hd + 2)
// floats with nc = ceil(W / 64) (unused when W <= 64), and above hd 256 nc =
// min(ceil(W / 32), 64) (unused when W <= 32); tickets: B * KV int32, zero
// between launches (each launch leaves them zero). scale multiplies every
// score (the caller's 1 / sqrt of the unpadded hd). The caller guarantees
// H % KV == 0. An hd above 256 that is a multiple of 4 runs the wide-head
// kernel; any other hd with no instance returns cudaErrorInvalidValue
// without a launch.
extern "C" int decode_attention_launch(const float* q, const float* k, const float* v,
                                       const int* cache_len, float* out, float* part,
                                       int* tickets, int B, int H, int W, int KV, int hd,
                                       float scale, cudaStream_t stream) {
  switch (hd) {
#define DECODE_CASE(N) \
  case N:              \
    return launch<N>(q, k, v, cache_len, out, part, tickets, B, H, W, KV, scale, stream);
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(112)
    DECODE_CASE(128)
    DECODE_CASE(256)
#undef DECODE_CASE
    default:
      if (hd <= 256 || hd % 4) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wide(q, k, v, cache_len, out, part, tickets, B, H, W, KV, hd, scale,
                         stream);
  }
}
