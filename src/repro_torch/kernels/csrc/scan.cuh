// The tiled scan shared by the full scans (dense_topk.cu: B1, B6) and the
// gathered scans (gathered_topk.cu: B4, B5, B7, B8). A scan walks, for each
// query, `ncols` columns: the KB's rows for a full scan (column == id), or
// the query's candidate columns for a gathered scan (column c reads the row
// cand[b][c] of the resident KB, or row b * C + c of a pre-gathered slab).
//
// Design. The TPU kernels walk their tiles in order on one core and carry a
// running top-k in VMEM from one grid step to the next. Here:
//  1. scan_kernel: a persistent grid of `lists` CTAs per query block (the
//     caller sizes it: one CTA per SM for the full scans; for the gathered
//     scans two per SM, kCtas, shared among the queries). CTA x walks the
//     column tiles x, x + lists, ... of kTileRows columns (a gathered CTA:
//     a contiguous run of tiles, the queries fastest in the grid); each is
//     scored in steps of kDC elements of d. A ring of 3-8 steps in shared
//     memory (as deep as fits in the CTA's share) is fed by cp.async 16-byte
//     copies (the rows as stored: fp32, or raw int8 codes, cast as they are
//     read; beside them the queries' chunk), so device memory stays busy
//     while the CTA scores and selects. A gathered scan skips a tile of pads
//     only, looks up a tile's row ids once, when its first step is issued,
//     and does not read a pad (cand < 0) or an id at or past the KB's N rows:
//     the copy zero-fills, and the column scores kNeg. Each thread owns RM
//     rows x QN queries of the tile and reads them as 16-byte vectors. Query blocks: QB = 1 (every gathered scan: its
//     rows are the query's own), 4, 16 (2 x 8 per thread) and 64 (4 x 8 per
//     thread, 512 threads, for 17 <= B and k <= 32). Every score is one
//     thread's fmaf chain over d in order from 0.0f, so a query's scores do
//     not depend on B, its block, the split or k; int8 rows: the row's scale
//     multiplies the finished score.
//     Selection (k <= 256) is by threshold (Block/WarpSelect in Johnson et
//     al., "Billion-scale similarity search with GPUs"): per query the CTA
//     keeps a list of `cap` keys in shared memory and the key of its k-th
//     best; a scored row whose key does not beat it is dropped in registers,
//     others are appended (one shared atomic per warp and query). A full
//     list is sorted by one warp (bitonic) down to its best k, which raises
//     the threshold. The first tile seeds the threshold from warp-wide k-th
//     maxima and is cut to k at once. Keys are unique (the column is in the
//     key), so the set kept does not depend on the order rows arrive in.
//     Each CTA writes one list of k keys per query, and launch_merge
//     (topk_common.cuh) merges the `lists` lists per query.
//     With kKeys (k > 256) the same kernel writes every column's key to a
//     (B, ncols) buffer instead, and launch_select (topk_common.cuh) keeps
//     the top k: the same scores, whatever k is.
#pragma once

#include "cp_async.cuh"
#include "smem_attr.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kTileRows = 256;       // columns per tile (every configuration)
constexpr int kSmemMax = 232448;     // dynamic shared memory a CTA may use (227 KB)
constexpr int kSmemPerSm = 233472;   // shared memory of one SM, 1 KB of it per CTA reserved
constexpr int kMaskedTiles = 128;    // a gathered CTA's tiles whose pads-only flag is kept
constexpr int kWideMaxK = 32;        // largest k for 64-query blocks (list size)
constexpr int kMaxK = 256;           // largest k the lists take; above it, the select pass

// Where column c of query b reads its row.
enum class Src {
  kDense,   // row c of rows (N, d): the full scans
  kFused,   // row cand[b][c] of the resident rows (N, d), scales (N,)
  kSlab,    // row b * C + c of a pre-gathered slab (B * C, d), scales (B * C,)
};

// Per-query list size: a power of two, at least 64 and 2k.
int list_cap(int k) {
  int c = 64;
  while (c < 2 * k) c <<= 1;
  return c;
}

// kCtas: the CTAs an SM holds at once (the shared-memory budget of each)
template <int QB, int QN, int RM, int THREADS, typename T, int kCtas = 1>
struct Cfg {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kNQG = QB / QN;                  // query groups
  static constexpr int kNRG = THREADS / kNQG;           // row groups
  static_assert(kNRG * RM == kTileRows, "a tile is kTileRows rows");
  static constexpr int kDC = kInt8 ? 64 : 32;           // elements of d per step
  static constexpr int kVec = 16 / sizeof(T);           // elements per 16-byte copy
  static constexpr int kPieces = kDC / kVec;            // 16-byte copies per staged row
  static constexpr int kRowBytes = kDC * sizeof(T) + 16;  // staged row pitch:
  // 16-byte reads of 8 consecutive rows hit 8 distinct bank quads
  static constexpr int kQPitch = kDC + 4;               // staged query pitch (floats)
  static constexpr int kStageBytes = kTileRows * kRowBytes + QB * kQPitch * 4;
  static constexpr int kMaxCap = QB > 16 ? 2 * kWideMaxK : 2 * kMaxK;
  static constexpr int kListBytes = QB * kMaxCap * 8 + QB * 12;  // lists, thresholds, counts
  static constexpr int kBudget = kCtas == 1 ? kSmemMax
                                            : kSmemPerSm / kCtas - 1024 - 64;  // 64: static
  // the deepest ring that fits beside the largest lists, up to 8 steps
  static constexpr int kStages = (kBudget - kListBytes) / kStageBytes < 8
                                     ? (kBudget - kListBytes) / kStageBytes : 8;
  static_assert(kStages >= 3, "the copy ring needs three stages");
  static constexpr size_t smem(int cap) {
    return static_cast<size_t>(kStages) * kStageBytes + static_cast<size_t>(QB) * cap * 8 +
           QB * 12;
  }
};

// Four int8 codes (one 32-bit word) -> exact floats without I2F, which runs
// at a quarter of the FMA rate: with the sign bit flipped, byte b is x + 128,
// and 2^23 + b is the float whose low mantissa byte is b.
__device__ __forceinline__ void cast4(uint32_t word, float* x) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + e)) - 8388736.0f;
}

// Sort one query's list (cap keys, a power of two; empty slots 0) descending
// with one warp, keep the best k, and raise the threshold to the k-th key
// once k keys are held.
__device__ void flush_list(uint64_t* list, int cap, int k, int* cnt, uint64_t* thr,
                           int lane) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < cap / 2; i += 32) {
        const int a = i + (i & -stride);     // 2*stride*(i/stride) + i%stride
        const bool desc = (a & size) == 0;
        const uint64_t x = list[a], y = list[a + stride];
        if ((x < y) == desc) { list[a] = y; list[a + stride] = x; }
      }
      __syncwarp();
    }
  }
  const int keep = min(min(*cnt, cap), k);
  for (int i = keep + lane; i < cap; i += 32) list[i] = 0ull;
  __syncwarp();
  if (lane == 0) {
    *cnt = keep;
    if (keep == k && list[k - 1] > *thr) *thr = list[k - 1];
  }
  __syncwarp();
}

// The k-th largest (1 <= k <= 32) of the warp's 32 values: a bitonic sort
// across the lanes, descending, then lane k - 1's value.
__device__ uint64_t warp_kth(uint64_t v, int k, int lane) {
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, static_cast<unsigned long long>(v), stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max == (v > o) ? v : o;
    }
  }
  return __shfl_sync(0xffffffffu, static_cast<unsigned long long>(v), k - 1);
}

// rows: (N, d) for kDense and kFused, (B * C, d) for kSlab; scales (int8
// only) indexed as the rows; cand (B, ncols) for the gathered scans, else
// nullptr; N the resident rows (a kFused id at or past it is not read).
template <int QB, int QN, int RM, int THREADS, typename T, Src S, bool kKeys, int kCtas>
__global__ void __launch_bounds__(THREADS, kCtas)
scan_kernel(const float* __restrict__ q, const T* __restrict__ rows,
            const float* __restrict__ scales, const int* __restrict__ cand,
            uint64_t* __restrict__ partial, int B, int N, int ncols, int d, int k, int cap) {
  using C = Cfg<QB, QN, RM, THREADS, T, kCtas>;
  constexpr bool kGather = S != Src::kDense;
  static_assert(!kGather || QB == 1, "a gathered scan reads one query's rows per CTA");
  constexpr int kStages = C::kStages;
  constexpr int kWarps = THREADS / 32;
  constexpr int kPieces = C::kPieces;
  constexpr int kIssueRows = kTileRows * kPieces / THREADS;   // staged rows a thread copies
  static_assert(kTileRows * kPieces % THREADS == 0, "a step's copies split evenly");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);  // [QB][cap]
  uint64_t* thr = lists + QB * cap;                                                // [QB]
  int* cnt = reinterpret_cast<int*>(thr + QB);                                     // [QB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid % C::kNRG, qg = tid / C::kNRG;
  // The CTA's split of its query block's columns. A full scan strides its
  // tiles over the splits (x, x + lists, ...). A gathered scan's grid runs
  // the queries fastest and each CTA takes a contiguous run of tiles, so
  // the CTAs that run at once read the same part of every query's id-sorted
  // candidates: rows that queries share are read close in time, from L2.
  const int split = kGather ? blockIdx.y : blockIdx.x;
  const int nsplit = kGather ? gridDim.y : gridDim.x;
  const int q0 = (kGather ? blockIdx.x : blockIdx.y) * QB;
  const int nchunk = (d + C::kDC - 1) / C::kDC;
  const int ntiles = (ncols + kTileRows - 1) / kTileRows;
  const int run = (ntiles + nsplit - 1) / nsplit;      // a gathered CTA's tiles
  const int my_tiles = kGather ? max(0, min(run, ntiles - split * run))
                       : split < ntiles ? (ntiles - 1 - split) / nsplit + 1 : 0;
  // the column of the CTA's t-th tile
  auto tile_row0 = [&](int t) {
    return (kGather ? split * run + t : split + t * nsplit) * kTileRows;
  };
  // a gathered scan: the row that column c of this query reads, or -1 (a
  // pad, an id at or past N, or c past the columns)
  auto row_of = [&](int c) {
    const int id = c < ncols ? __ldg(cand + static_cast<size_t>(q0) * ncols + c) : -1;
    if (id < 0 || (S == Src::kFused && id >= N)) return -1;
    return S == Src::kSlab ? q0 * ncols + c : id;
  };

  for (int x = tid; x < QB * cap; x += THREADS) lists[x] = 0ull;
  for (int j = tid; j < QB; j += THREADS) { thr[j] = 0ull; cnt[j] = 0; }

  // A gathered scan's lists skip a tile of pads only (the backends put the
  // pads last, so at B = 1 ~40% of the tiles): its columns would come out
  // as (NEG, -1), as an empty slot does. (The key pass writes every
  // column's key: the select pass counts on each key being there and
  // unique.) Bit t: the CTA's tile t (t < 128) holds a column that is not a
  // pad; later tiles are all walked.
  constexpr bool kSkip = kGather && !kKeys;
  uint32_t* live_mask = nullptr;
  int walked = my_tiles;               // tiles the CTA walks
  if constexpr (kSkip) {
    __shared__ uint32_t mask[kMaskedTiles / 32];
    live_mask = mask;
    if (tid < kMaskedTiles / 32) live_mask[tid] = 0u;
    __syncthreads();
    for (int t = warp; t < min(my_tiles, kMaskedTiles); t += kWarps) {
      bool any = false;
      for (int c = tile_row0(t) + lane; c < min(tile_row0(t) + kTileRows, ncols); c += 32)
        any |= __ldg(cand + static_cast<size_t>(q0) * ncols + c) >= 0;
      if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(&live_mask[t / 32], 1u << (t % 32));
    }
    __syncthreads();
    walked = max(my_tiles - kMaskedTiles, 0);
#pragma unroll
    for (int w = 0; w < kMaskedTiles / 32; ++w) walked += __popc(live_mask[w]);
  }
  // the first tile at or after t that the CTA walks
  auto next_tile = [&](int t) {
    if constexpr (kSkip)
      while (t < min(my_tiles, kMaskedTiles) && !((live_mask[t / 32] >> (t % 32)) & 1u)) ++t;
    return t;
  };
  const int steps = walked * nchunk;
  int issue_tile = -1, tile = -1;      // the tiles being issued and scored

  // one step: the tile's rows x kDC columns of d, and the queries' kDC columns
  int src_row[kIssueRows];             // gathered: the rows this thread copies in the tile
  auto issue = [&](int step) {
    if (step < steps) {
      unsigned char* st = smem + (step % kStages) * C::kStageBytes;
      if (step % nchunk == 0) issue_tile = next_tile(issue_tile + 1);
      const int row0 = tile_row0(issue_tile), c0 = (step % nchunk) * C::kDC;
      if constexpr (kGather) {
        if (step % nchunk == 0) {      // a new tile: look its rows up once
#pragma unroll
          for (int m = 0; m < kIssueRows; ++m) src_row[m] = row_of(row0 + (tid + m * THREADS) / kPieces);
        }
#pragma unroll
        for (int m = 0; m < kIssueRows; ++m) {
          const int f = tid + m * THREADS;
          const int r = f / kPieces, p = f % kPieces;
          const int gcol = c0 + p * C::kVec;
          const bool ok = src_row[m] >= 0 && gcol < d;
          cp_async16(st + r * C::kRowBytes + p * 16,
                     ok ? rows + static_cast<size_t>(src_row[m]) * d + gcol : rows, ok ? 16 : 0);
        }
      } else {
        for (int f = tid; f < kTileRows * kPieces; f += THREADS) {
          const int r = f / kPieces, p = f % kPieces;
          const int grow = row0 + r, gcol = c0 + p * C::kVec;
          const bool ok = grow < N && gcol < d;
          cp_async16(st + r * C::kRowBytes + p * 16,
                     ok ? rows + static_cast<size_t>(grow) * d + gcol : rows, ok ? 16 : 0);
        }
      }
      float* qs = reinterpret_cast<float*>(st + kTileRows * C::kRowBytes);
      for (int f = tid; f < QB * (C::kDC / 4); f += THREADS) {
        const int j = f / (C::kDC / 4), p = f % (C::kDC / 4);
        const int gq = q0 + j, gcol = c0 + p * 4;
        const bool ok = gq < B && gcol < d;
        cp_async16(qs + j * C::kQPitch + p * 4,
                   ok ? q + static_cast<size_t>(gq) * d + gcol : q, ok ? 16 : 0);
      }
    }
    cp_async_commit();                 // empty groups too: the wait count stays uniform
  };

  float acc[RM][QN];
  float sc[RM];
  bool live[RM];                       // gathered: the column holds a row that was read
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    sc[i] = 1.0f;
    live[i] = true;
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = 0.0f;
  }
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();      // this step's copies have landed ...
    __syncthreads();                   // ... for every thread, and step - 1 is consumed
    issue(step + kStages - 1);
    const int chunk = step % nchunk;
    if (chunk == 0) tile = next_tile(tile + 1);
    const int row0 = tile_row0(tile);
    if (chunk == 0) {                  // what the tile's end needs: live rows, scales
      if constexpr (kGather) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = row_of(row0 + rg + C::kNRG * i);
          live[i] = row >= 0;
          if constexpr (C::kInt8) sc[i] = live[i] ? __ldg(scales + row) : 0.0f;
        }
      } else if constexpr (C::kInt8) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = row0 + rg + C::kNRG * i;
          sc[i] = row < N ? __ldg(scales + row) : 0.0f;
        }
      }
    }
    const unsigned char* st = smem + (step % kStages) * C::kStageBytes;
    const float* qs = reinterpret_cast<const float*>(st + kTileRows * C::kRowBytes) +
                      qg * QN * C::kQPitch;
    // kVec columns of d for the thread's rows and queries, each acc in d order
    auto score = [&](int c) {
      if constexpr (!C::kInt8) {
        float4 x[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          x[i] = *reinterpret_cast<const float4*>(st + (rg + C::kNRG * i) * C::kRowBytes + c * 4);
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(qs + j * C::kQPitch + c);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j] = fmaf(w.x, x[i].x, acc[i][j]);
            acc[i][j] = fmaf(w.y, x[i].y, acc[i][j]);
            acc[i][j] = fmaf(w.z, x[i].z, acc[i][j]);
            acc[i][j] = fmaf(w.w, x[i].w, acc[i][j]);
          }
        }
      } else {
        uint4 raw[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          raw[i] = *reinterpret_cast<const uint4*>(st + (rg + C::kNRG * i) * C::kRowBytes + c);
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          float x[RM][4];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            cast4(w4 == 0 ? raw[i].x : w4 == 1 ? raw[i].y : w4 == 2 ? raw[i].z : raw[i].w, x[i]);
#pragma unroll
          for (int j = 0; j < QN; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(qs + j * C::kQPitch + c + 4 * w4);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              acc[i][j] = fmaf(w.x, x[i][0], acc[i][j]);
              acc[i][j] = fmaf(w.y, x[i][1], acc[i][j]);
              acc[i][j] = fmaf(w.z, x[i][2], acc[i][j]);
              acc[i][j] = fmaf(w.w, x[i][3], acc[i][j]);
            }
          }
        }
      }
    };
    constexpr int kStep = C::kInt8 ? 16 : 4;
    const int cmax = min(C::kDC, d - chunk * C::kDC);   // a multiple of kVec
    if (cmax == C::kDC) {              // a whole chunk: unrolled without a branch
#pragma unroll
      for (int c = 0; c < C::kDC; c += kStep) score(c);
    } else {                           // the last, partial chunk of d
      for (int c = 0; c < cmax; c += kStep) score(c);
    }
    if (chunk != nchunk - 1) continue;

    // the tile is scored: a column that was not read scores kNeg
    auto key_of = [&](int i, int j) {
      const float s = C::kInt8 ? acc[i][j] * sc[i] : acc[i][j];
      return make_key(kGather && !live[i] ? kNeg : s, row0 + rg + C::kNRG * i);
    };
    if constexpr (kKeys) {             // every column's key, for the select pass
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int row = row0 + rg + C::kNRG * i, jj = qg * QN + j;
          if (row < ncols && q0 + jj < B)
            partial[static_cast<size_t>(q0 + jj) * ncols + row] = key_of(i, j);
          acc[i][j] = 0.0f;
        }
      }
      continue;
    }
    // drop what cannot beat a query's k-th best, append the rest, and cut
    // full lists down to k (raising the threshold)
    const bool first_tile = step < nchunk;
    if (first_tile && k <= 32) {
      // no threshold yet: seed one from the tile itself, so that its rows do
      // not all go through the lists. Per query, the k-th largest of the
      // warp's 32 lane maxima has k keys at or above it, so a key below it
      // cannot be in the top k.
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        uint64_t best = 0ull;
#pragma unroll
        for (int i = 0; i < RM; ++i)
          if (row0 + rg + C::kNRG * i < ncols && q0 + qg * QN + j < B) {
            const uint64_t key = key_of(i, j);
            if (key > best) best = key;
          }
        const uint64_t kth = warp_kth(best, k, lane);
        if (lane == 0 && kth != 0ull)
          atomicMax(reinterpret_cast<unsigned long long*>(thr + qg * QN + j),
                    static_cast<unsigned long long>(kth - 1));
      }
      __syncthreads();
    }
    uint64_t pending = 0;            // bit i * QN + j: row i, query j still to place
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const int jj = qg * QN + j;
        if (row0 + rg + C::kNRG * i < ncols && q0 + jj < B && key_of(i, j) > thr[jj])
          pending |= 1ull << (i * QN + j);
      }
    }
    while (__syncthreads_or(pending != 0)) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          // jj is the same across the warp (a warp holds one query group):
          // one atomic per warp reserves the slots of all its lanes' keys
          const uint64_t bit = 1ull << (i * QN + j);
          const int jj = qg * QN + j;
          const uint64_t key = key_of(i, j);
          if ((pending & bit) && key <= thr[jj]) pending &= ~bit;   // the threshold rose
          const unsigned want = __ballot_sync(0xffffffffu, (pending & bit) != 0);
          if (want) {
            const int leader = __ffs(want) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(&cnt[jj], __popc(want));
            base = __shfl_sync(0xffffffffu, base, leader);
            const int pos = base + __popc(want & ((1u << lane) - 1u));
            if ((pending & bit) && pos < cap) { lists[jj * cap + pos] = key; pending &= ~bit; }
          }
        }
      }
      __syncthreads();
      for (int jj = warp; jj < QB; jj += kWarps)
        if (cnt[jj] >= cap || (first_tile && cnt[jj] > k))   // after the first tile the
          flush_list(lists + jj * cap, cap, k, cnt + jj, thr + jj, lane);   // threshold is exact
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j) acc[i][j] = 0.0f;
  }
  cp_async_wait<0>();
  if constexpr (kKeys) return;
  __syncthreads();
  for (int jj = warp; jj < QB; jj += kWarps)
    if (cnt[jj] > k) flush_list(lists + jj * cap, cap, k, cnt + jj, thr + jj, lane);
  __syncthreads();
  for (int f = tid; f < QB * k; f += THREADS) {
    const int jj = f / k, i = f - jj * k;
    if (q0 + jj < B)
      partial[(static_cast<size_t>(q0 + jj) * nsplit + split) * k + i] =
          lists[jj * cap + i];
  }
}

// One scan launch: grid (lists, ceil(B / QB)); cap 0 for the key pass.
template <int QB, int QN, int RM, int THREADS, typename T, Src S, bool kKeys, int kCtas = 1>
void launch_scan(const float* q, const T* rows, const float* scales, const int* cand,
                 uint64_t* partial, int B, int N, int ncols, int d, int k, int lists,
                 cudaStream_t stream) {
  using C = Cfg<QB, QN, RM, THREADS, T, kCtas>;
  // once per instantiation and device, at its largest list size
  static bool smem_allowed[kMaxDevices] = {};
  allow_smem(smem_allowed, scan_kernel<QB, QN, RM, THREADS, T, S, kKeys, kCtas>,
             static_cast<int>(C::smem(kKeys ? 0 : C::kMaxCap)));
  const int cap = kKeys ? 0 : list_cap(k);
  const int qblocks = (B + QB - 1) / QB;
  const dim3 grid = S == Src::kDense ? dim3(lists, qblocks) : dim3(qblocks, lists);
  scan_kernel<QB, QN, RM, THREADS, T, S, kKeys, kCtas><<<grid, THREADS, C::smem(cap), stream>>>(
      q, rows, scales, cand, partial, B, N, ncols, d, k, cap);
}

}  // namespace
