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
// at long S the FLOPs bound it. A call is a few microseconds of work, so what
// sets its time is how many SMs it fills and how long each CTA waits on loads.
//
// Design. One CTA per (batch * head, q tile of kBQ = 16 rows): S = 160 gives
// 160 CTAs at 16 heads, S = 300 gives 304, for the card's 132 SMs. The q tile
// index runs backwards over blockIdx.y, so the tiles with the longest causal
// walk are launched first. The CTA walks the k/v tiles, skipping those wholly
// above the diagonal (unless they hold prefix keys) or wholly behind the
// window, as the TPU kernel does (prefill_attention.py:44-48); the TPU grid
// carried the softmax state from one kv grid step to the next, here the loop
// inside the CTA carries it. k/v tiles are double-buffered: cp.async copies
// the next tile while this one is scored. Sixteen threads (a half-warp) own a
// pair of q rows: each scores kBK / 16 keys for both rows from 16-byte reads
// of q and k (2 + kBK / 16 loads per 8 * kBK / 16 FMAs, each score a
// sequential fmaf chain over hd), the row max and sum are reduced across the
// half-warp with shuffles, and each thread accumulates the float4 output
// columns ct, ct + 16, ... of both rows from 16-byte reads of p and v. Masked pairs
// contribute exactly zero, so a row whose first tiles are all masked never
// picks up weight from them. No choice of tiling depends on B: an output row
// depends only on its own sequence.
//
// Head dims: instantiated for hd in {16, 32, 64, 112, 128, 256}; the
// wrapper zero-pads any other hd <= 256 to the next instance and passes the
// real hd's softmax scale, so padded lanes add 0 to every score and give 0
// output columns that the wrapper drops. hd 256 takes 151 KB of dynamic
// shared memory (one CTA an SM), under the card's 227 KB.
//
// Above hd 256 (a multiple of 4, the wrapper pads the rest) a call runs
// prefill_wide_kernel, where a row (1-2 KB) no longer fits a thread's
// registers and each (query, key) pair costs 4 * hd FMAs, so the FMA units
// bound it once the rows of a q tile share their key and value loads. One
// CTA of 256 threads per (batch * head, q tile of kWideRows = 16 rows),
// longest causal walk first, walks K/V tiles of 16 keys, skipping those its
// masks rule out as above. The q tile stays in shared memory; key and value
// tiles stream through the 4-slot bulk-copy ring of wide_attention.cuh, 3
// tiles (99 KB at hd 512) in flight, 174 KB of shared memory in all (one
// CTA an SM). Scoring a 16 x 16 tile, each warp takes two of the 16
// residues of the float4 columns mod 16 (one a half-warp, the halves 4 bank
// quads apart) and each lane a 4-row x 4-key block: a column costs a lane
// 8 shared loads (each row address shared by 4 lanes, rows skewed 16 B
// apart so the 8 addresses of a load fall in 8 bank quads) for 64 FMAs.
// The half-warps add their partials by one shuffle, the 8 warps' meet in
// shared memory and are summed in warp order, a thread per (row, key),
// which then runs the row's online softmax over a half-warp. For P.V each
// thread keeps 8 rows x one float4 column of the accumulator in registers
// and reads a value once for 32 FMAs. Rows of one q tile read each K/V tile
// once: 16 times less L2 traffic than a CTA per row. Above hd 512 a pass a
// slice of output columns; q slices then stream through the ring too.
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "smem_attr.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kThreads = 128;      // 8 row pairs x 16 threads
constexpr int kBQ = 16;            // q rows per CTA
constexpr int kCols = 16;          // threads sharing a row pair (one half-warp)
constexpr float kNeg = -3.4e38f;

template <int HD>
struct Tile {
  static_assert(HD % 4 == 0 && HD >= 16 && HD <= 256, "HD: a multiple of 4 in [16, 256]");
  static constexpr int kBK = HD <= 64 ? 64 : 32;   // keys per k/v tile
  static constexpr int kKPT = kBK / kCols;          // keys per thread in q k^T
  static constexpr int kVec = HD / 4;               // float4 per row
  static constexpr int kDV = (kVec + kCols - 1) / kCols;   // float4 output columns per thread
  static constexpr int kPitch = HD + 4;             // q and k rows: 16-byte reads of 8
                                                    // consecutive rows hit 8 bank quads
  static constexpr int kPPitch = kBK + 4;           // probability rows
  static constexpr int kSmem =
      4 * (kBQ * kPitch + 2 * kBK * kPitch + 2 * kBK * HD + kBQ * kPPitch);
};

using wide::ld4;

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int S, int H,
                    int KV, int causal, int window, int prefix_len, float scale) {
  using Tl = Tile<HD>;
  constexpr int kBK = Tl::kBK, kKPT = Tl::kKPT, kVec = Tl::kVec, kDV = Tl::kDV;
  constexpr int kPitch = Tl::kPitch, kPPitch = Tl::kPPitch;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kBQ][kPitch]
  float* ks = qs + kBQ * kPitch;             // [2][kBK][kPitch]
  float* vs = ks + 2 * kBK * kPitch;         // [2][kBK][HD]
  float* ps = vs + 2 * kBK * HD;             // [kBQ][kPPitch]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest causal walk first
  const int tid = threadIdx.x, ct = tid % kCols;
  const int r0 = 2 * (tid / kCols);          // this thread's rows: r0, r0 + 1

  for (int f = tid; f < kBQ * (HD / 4); f += kThreads) {
    const int r = f / (HD / 4), c4 = f % (HD / 4), s = q_lo + r;
    const bool ok = s < S;
    cp_async16(qs + r * kPitch + c4 * 4,
               ok ? q + ((static_cast<size_t>(b) * S + s) * H + h) * HD + c4 * 4 : q,
               ok ? 16 : 0);
  }
  auto load_kv = [&](int kt, int buf) {
    float* kd = ks + buf * kBK * kPitch;
    float* vd = vs + buf * kBK * HD;
    for (int f = tid; f < kBK * (HD / 4); f += kThreads) {
      const int c = f / (HD / 4), c4 = f % (HD / 4), s = kt * kBK + c;
      const bool ok = s < S;
      const size_t off = ((static_cast<size_t>(b) * S + s) * KV + kvh) * HD + c4 * 4;
      cp_async16(kd + c * kPitch + c4 * 4, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(vd + c * HD + c4 * 4, ok ? v + off : v, ok ? 16 : 0);
    }
  };

  const int nk = (S + kBK - 1) / kBK;
  int lo = 0, hi = nk;
  if (causal) {
    int need = (q_lo + kBQ - 1) / kBK + 1;             // tiles reaching the diagonal
    if (prefix_len > 0) need = max(need, (prefix_len + kBK - 1) / kBK);
    hi = min(nk, need);
  }
  if (window > 0 && q_lo - window > 0) lo = (q_lo - window) / kBK;

  load_kv(lo, 0);
  cp_async_commit();                         // group: the q tile and the first k/v tile

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[2][4 * kDV];
#pragma unroll
  for (int e = 0; e < 4 * kDV; ++e) acc[0][e] = acc[1][e] = 0.0f;

  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_kv(kt + 1, buf ^ 1);              // in flight while this tile is scored
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt_s = ks + buf * kBK * kPitch;
    const float* vt_s = vs + buf * kBK * HD;

    float s[2][kKPT];
#pragma unroll
    for (int j = 0; j < kKPT; ++j) s[0][j] = s[1][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 qa = ld4(qs + r0 * kPitch + c), qb = ld4(qs + (r0 + 1) * kPitch + c);
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float4 kv = ld4(kt_s + (ct + kCols * j) * kPitch + c);
        s[0][j] = fmaf(qa.x, kv.x, s[0][j]);
        s[0][j] = fmaf(qa.y, kv.y, s[0][j]);
        s[0][j] = fmaf(qa.z, kv.z, s[0][j]);
        s[0][j] = fmaf(qa.w, kv.w, s[0][j]);
        s[1][j] = fmaf(qb.x, kv.x, s[1][j]);
        s[1][j] = fmaf(qb.y, kv.y, s[1][j]);
        s[1][j] = fmaf(qb.z, kv.z, s[1][j]);
        s[1][j] = fmaf(qb.w, kv.w, s[1][j]);
      }
    }

    const int k_lo = kt * kBK;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int qi = q_lo + r0 + a;
      bool ok[kKPT];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int kidx = k_lo + ct + kCols * j;
        bool allowed = kidx < S;
        if (causal) allowed = allowed && (kidx <= qi || (qi < prefix_len && kidx < prefix_len));
        if (window > 0) allowed = allowed && (kidx > qi - window);
        ok[j] = allowed;
        s[a][j] *= scale;
        if (allowed) mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int o = kCols / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[a], mx);
      const float corr = expf(m[a] - mn);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float p = ok[j] ? expf(s[a][j] - mn) : 0.0f;
        ps[(r0 + a) * kPPitch + ct + kCols * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = kCols / 2; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[a] = l[a] * corr + psum;
      m[a] = mn;
#pragma unroll
      for (int e = 0; e < 4 * kDV; ++e) acc[a][e] *= corr;
    }
    __syncwarp();                            // the row pair's half-warp wrote its p rows

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 pa4 = ld4(ps + r0 * kPPitch + c), pb4 = ld4(ps + (r0 + 1) * kPPitch + c);
      const float pa[4] = {pa4.x, pa4.y, pa4.z, pa4.w};
      const float pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = vt_s + (c + cc) * HD;
#pragma unroll
        for (int e4 = 0; e4 < kDV; ++e4) {
          const int col = ct + kCols * e4;
          if (col >= kVec) continue;         // hd / 4 not a multiple of 16
          const float4 x = ld4(vr + 4 * col);
          const int e = 4 * e4;
          acc[0][e] = fmaf(pa[cc], x.x, acc[0][e]);
          acc[0][e + 1] = fmaf(pa[cc], x.y, acc[0][e + 1]);
          acc[0][e + 2] = fmaf(pa[cc], x.z, acc[0][e + 2]);
          acc[0][e + 3] = fmaf(pa[cc], x.w, acc[0][e + 3]);
          acc[1][e] = fmaf(pb[cc], x.x, acc[1][e]);
          acc[1][e + 1] = fmaf(pb[cc], x.y, acc[1][e + 1]);
          acc[1][e + 2] = fmaf(pb[cc], x.z, acc[1][e + 2]);
          acc[1][e + 3] = fmaf(pb[cc], x.w, acc[1][e + 3]);
        }
      }
    }
    __syncthreads();                         // both buffers and the p rows consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qi = q_lo + r0 + a;
    if (qi < S) {
      const float inv = 1.0f / fmaxf(l[a], 1e-30f);
      float* o = out + ((static_cast<size_t>(b) * S + qi) * H + h) * HD;
#pragma unroll
      for (int e4 = 0; e4 < kDV; ++e4) {
        const int col = ct + kCols * e4;
        if (col < kVec)
          *reinterpret_cast<float4*>(o + 4 * col) =
              make_float4(acc[a][4 * e4] * inv, acc[a][4 * e4 + 1] * inv,
                          acc[a][4 * e4 + 2] * inv, acc[a][4 * e4 + 3] * inv);
      }
    }
  }
}

// hd > 256 (the design note at the top)
constexpr int kWideRows = 16;                             // q rows a CTA, keys a tile
constexpr int kWideTile = kWideRows * wide::kPitch;       // floats of a tile
constexpr int kWideSmem = 4 * (1 + wide::kStages) * kWideTile;   // the q tile and the ring

// kOneSlice: hd <= 512, every row one column slice (the q tile stays put)
template <bool kOneSlice>
__global__ void __launch_bounds__(wide::kThreads, 1)
prefill_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int S, int H,
                    int KV, int hd, int causal, int window, int prefix_len, float scale) {
  using wide::kPitch;
  using wide::kSlice;
  using wide::kStages;
  using wide::kWarps;
  // above one slice a key tile reads the q slice of the tile before it, so
  // that slot is refilled one tile later
  constexpr int kAhead = kOneSlice ? kStages - 1 : kStages - 2;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                 // [kWideRows][kPitch]: kOneSlice
  float* ring = smem + kWideTile;                   // [kStages][kWideRows][kPitch]
  __shared__ float sRed[kWarps][kWideRows][kWideRows];      // warps' partial scores
  __shared__ __align__(16) float sP[kWideRows][kWideRows];  // weights [key][row]
  __shared__ float sCorr[kWideRows], sL[kWideRows];
  __shared__ __align__(8) unsigned long long sBar[kStages + 1];   // the ring's, the q tile's

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kWideRows;   // longest causal walk first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nvec = hd / 4, ns = kOneSlice ? 1 : (nvec + kSlice - 1) / kSlice;
  const int nk = (S + kWideRows - 1) / kWideRows;
  int lo = 0, hi = nk;
  if (causal) {
    int need = (q_lo + kWideRows - 1) / kWideRows + 1;   // tiles reaching the diagonal
    if (prefix_len > 0) need = max(need, (prefix_len + kWideRows - 1) / kWideRows);
    hi = min(nk, need);
  }
  if (window > 0 && q_lo - window > 0) lo = (q_lo - window) / kWideRows;
  // a block's tiles: its keys (above one slice: slice by slice, each after
  // its q slice), then its values in the pass's column slice; a pass a slice
  const int nblk = hi - lo, tpb = kOneSlice ? 2 : 2 * ns + 1, T = ns * nblk * tpb;
  const size_t qstride = static_cast<size_t>(H) * hd, kstride = static_cast<size_t>(KV) * hd;
  const float* qt = q + (static_cast<size_t>(b) * S * H + h) * hd + q_lo * qstride;
  const float* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const float* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int q_rows = min(kWideRows, S - q_lo);

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wide::bar_init(&sBar[i]);
    wide::bar_init_fence();
  }
  __syncthreads();
  wide::Cursor ld;                                  // warp 0: the next tile to ask for
  auto fetch = [&](int i) {
    const bool val = ld.k == tpb - 1;
    const int s = kOneSlice ? 0 : (val ? ld.pass : ld.k / 2);
    const int kt = lo + ld.blk, ncols = min(kSlice, nvec - s * kSlice);
    float* dst = ring + (i % kStages) * kWideTile;
    if (!kOneSlice && !val && ld.k % 2 == 0)
      wide::fetch_tile(dst, qt + 4 * s * kSlice, qstride, q_rows, ncols, &sBar[i % kStages]);
    else
      wide::fetch_tile(dst, (val ? vb : kb) + kt * kWideRows * kstride + 4 * s * kSlice,
                       kstride, min(kWideRows, S - kt * kWideRows), ncols, &sBar[i % kStages]);
    ld.next(tpb, nblk);
  };
  if (warp == 0) {
    if (kOneSlice) wide::fetch_tile(sQ, qt, qstride, q_rows, nvec, &sBar[kStages]);
    for (int i = 0; i < kAhead && i < T; ++i) fetch(i);
  }
  if (kOneSlice) wide::bar_wait(&sBar[kStages], 0);

  // scoring: lane (h2, rq, kq) of warp w takes rows rq + 4a and keys kq + 4c
  // over the float4 columns congruent to w (h2 = 0) or 8 + (w + 4) % 8 (h2 =
  // 1) mod 16, so that the 8 row addresses of one load fall in 8 bank quads
  const int h2 = lane / 16, rq = lane / 4 % 4, kq = lane % 4;
  const int col_first = h2 == 0 ? warp : 8 + (warp + 4) % 8;
  float part[16];                                   // [4a + c]
  float4 acc[8];                                    // rows 8 rg + a, float4 column x
  float m_row = kNeg, l_row = 0.0f;                 // the softmax state of row tid / 16
  const int rg = tid / kSlice, x = tid % kSlice;
  const int row = tid / kWideRows, key = tid % kWideRows;
  wide::Cursor cu;
  for (int i = 0; i < T; ++i, cu.next(tpb, nblk)) {
    wide::bar_wait(&sBar[i % kStages], (i / kStages) & 1);
    __syncthreads();                                // tile i landed; tile i - 1 consumed
    if (warp == 0 && i + kAhead < T) fetch(i + kAhead);
    const int blk = cu.blk, kk = cu.k, kt = lo + blk;
    const float* tile = ring + (i % kStages) * kWideTile;

    if (kk == tpb - 1) {                            // values: P . V over one slice
      const int col0 = kOneSlice ? 0 : cu.pass * kSlice, ncols = min(kSlice, nvec - col0);
      const int nv = min(kWideRows, S - kt * kWideRows);   // the tile's rows read
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float f = sCorr[8 * rg + a];
        acc[a] = blk == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : make_float4(acc[a].x * f, acc[a].y * f, acc[a].z * f, acc[a].w * f);
      }
      if (x < ncols) {
#pragma unroll 4
        for (int t = 0; t < kWideRows; ++t) {
          if (t < nv) {
            const float4 pa = wide::ld4(&sP[t][8 * rg]), pb = wide::ld4(&sP[t][8 * rg + 4]);
            const float4 vv = wide::ld4(tile + t * kPitch + 4 * x);
            acc[0] = wide::fma4(pa.x, vv, acc[0]);
            acc[1] = wide::fma4(pa.y, vv, acc[1]);
            acc[2] = wide::fma4(pa.z, vv, acc[2]);
            acc[3] = wide::fma4(pa.w, vv, acc[3]);
            acc[4] = wide::fma4(pb.x, vv, acc[4]);
            acc[5] = wide::fma4(pb.y, vv, acc[5]);
            acc[6] = wide::fma4(pb.z, vv, acc[6]);
            acc[7] = wide::fma4(pb.w, vv, acc[7]);
          }
        }
        if (blk == nblk - 1) {                      // the pass's last block: its columns out
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int qi = q_lo + 8 * rg + a;
            if (qi < S) {
              const float inv = 1.0f / fmaxf(sL[8 * rg + a], 1e-30f);
              *reinterpret_cast<float4*>(out + ((static_cast<size_t>(b) * S + qi) * H + h) * hd
                                         + 4 * (col0 + x)) =
                  make_float4(acc[a].x * inv, acc[a].y * inv, acc[a].z * inv, acc[a].w * inv);
            }
          }
        }
      }
      continue;
    }
    if (!kOneSlice && kk % 2 == 0) continue;        // a q slice: read by the next tile

    // keys: partial scores of the 16 x 16 tile over one slice (rows past S
    // and keys past S score garbage: masked below)
    const int s = kOneSlice ? 0 : kk / 2, col0 = s * kSlice, ncols = min(kSlice, nvec - col0);
    const float* qs = kOneSlice ? sQ : ring + ((i + kStages - 1) % kStages) * kWideTile;
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = 0.0f;
    }
#pragma unroll 2
    for (int xc = col_first; xc < ncols; xc += 16) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = wide::ld4(qs + (rq + 4 * a) * kPitch + 4 * xc);
#pragma unroll
      for (int c = 0; c < 4; ++c) ka[c] = wide::ld4(tile + (kq + 4 * c) * kPitch + 4 * xc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[4 * a + c] = wide::dot4(qa[a], ka[c], part[4 * a + c]);
    }
    if (s < ns - 1) continue;
#pragma unroll
    for (int e = 0; e < 16; ++e) part[e] += __shfl_xor_sync(0xffffffffu, part[e], 16);
    if (h2 == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sRed[warp][rq + 4 * a][kq + 4 * c] = part[4 * a + c];
    }
    __syncthreads();

    // a thread per (row, key): the score, then the row's online softmax
    float sc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sc += sRed[w][row][key];
    sc *= scale;
    const int qi = q_lo + row, kj = kt * kWideRows + key;
    bool ok = qi < S && kj < S;
    if (causal) ok = ok && (kj <= qi || (qi < prefix_len && kj < prefix_len));
    if (window > 0) ok = ok && kj > qi - window;
    if (blk == 0) {
      m_row = kNeg;
      l_row = 0.0f;
    }
    float mx = ok ? sc : kNeg;
#pragma unroll
    for (int o = kWideRows / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m_row, mx);
    const float corr = expf(m_row - mn);
    const float p = ok ? expf(sc - mn) : 0.0f;
    float ps = p;
#pragma unroll
    for (int o = kWideRows / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l_row = fmaf(l_row, corr, ps);
    m_row = mn;
    sP[key][row] = p;
    if (key == 0) {
      sCorr[row] = corr;
      sL[row] = l_row;
    }
  }
}

template <int HD>
void launch(const float* q, const float* k, const float* v, float* out, int B, int S,
            int H, int KV, int causal, int window, int prefix_len, float scale,
            cudaStream_t stream) {
  // once per instantiation and device
  static bool smem_allowed[kMaxDevices] = {};
  allow_smem(smem_allowed, prefill_attn_kernel<HD>, Tile<HD>::kSmem);
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  prefill_attn_kernel<HD><<<grid, kThreads, Tile<HD>::kSmem, stream>>>(
      q, k, v, out, S, H, KV, causal, window, prefix_len, scale);
}

void launch_wide(const float* q, const float* k, const float* v, float* out, int B, int S,
                 int H, int KV, int hd, int causal, int window, int prefix_len, float scale,
                 cudaStream_t stream) {
  dim3 grid(B * H, (S + kWideRows - 1) / kWideRows);
  // once per instantiation and device
  if (hd <= 4 * wide::kSlice) {
    static bool smem_allowed[kMaxDevices] = {};
    allow_smem(smem_allowed, prefill_wide_kernel<true>, kWideSmem);
    prefill_wide_kernel<true><<<grid, wide::kThreads, kWideSmem, stream>>>(
        q, k, v, out, S, H, KV, hd, causal, window, prefix_len, scale);
  } else {
    static bool smem_allowed[kMaxDevices] = {};
    allow_smem(smem_allowed, prefill_wide_kernel<false>, kWideSmem);
    prefill_wide_kernel<false><<<grid, wide::kThreads, kWideSmem, stream>>>(
        q, k, v, out, S, H, KV, hd, causal, window, prefix_len, scale);
  }
}

}  // namespace

// q (B, S, H, hd), k/v (B, S, KV, hd) -> out (B, S, H, hd), all f32 and
// contiguous; scale multiplies every score (the caller's 1 / sqrt of the
// unpadded hd). The caller guarantees H % KV == 0. An hd above 256 that is
// a multiple of 4 runs the wide-head kernel; any other hd with no instance
// returns cudaErrorInvalidValue without a launch.
extern "C" int prefill_attention_launch(const float* q, const float* k, const float* v,
                                        float* out, int B, int S, int H, int KV, int hd,
                                        int causal, int window, int prefix_len, float scale,
                                        cudaStream_t stream) {
  switch (hd) {
#define PREFILL_CASE(N)                                                                \
  case N:                                                                              \
    launch<N>(q, k, v, out, B, S, H, KV, causal, window, prefix_len, scale, stream); \
    break;
    PREFILL_CASE(16)
    PREFILL_CASE(32)
    PREFILL_CASE(64)
    PREFILL_CASE(112)
    PREFILL_CASE(128)
    PREFILL_CASE(256)
#undef PREFILL_CASE
    default:
      if (hd <= 256 || hd % 4) return static_cast<int>(cudaErrorInvalidValue);
      launch_wide(q, k, v, out, B, S, H, KV, hd, causal, window, prefix_len, scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
