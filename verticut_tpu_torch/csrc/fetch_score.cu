// Fetch + score of the radius step's candidate blocks for Hopper (sm_90a):
// the range engine's per-table candidate fetch (verticut_tpu_torch/
// kernels/fetch_score.py, called through ops/chunks.py), in one launch per
// table and radius step.
//
//   for chunk slot c of query q and row r of its block b = blk_id[q, c]:
//     id = the block's id lane r;
//     out[q, c*blk + r] = (sum_w popcount(code_w ^ queries[q, w]), id)
//                         where lo[q, c] <= r < hi[q, c] and id >= 0,
//                         (INF_DIST, INVALID_ID) = (0x7FFFFFFF, -1) else.
//
// Two row layouts, one entry each, templated on W = 1..8 code words:
//   * inline rows, int32[NB, blk*(W+1)], word-major lanes: lane w*blk + r
//     is word w of entry r, word 0 the id (vt_fetch_score_rows);
//   * compact id rows, int32[NBc, blk], and the id-ordered codes
//     int32[N, W]; an id past N - 1 reads row N - 1, as the plain twin
//     clamps it (vt_fetch_score_idrows).
// Block ids are clamped to the rows, as ops/chunks.chunk_descriptors
// already clamps them, so no descriptor reads outside the table.
//
// Replaces no TPU kernel. The reference does this in plain jnp
// (verticut_tpu/ops/chunks.py:71 fetch_score_blocks, and the compact
// branch of verticut_tpu/search/single.py:_table_candidates_range), which
// XLA fuses into one fusion per table. Run eagerly in PyTorch the same
// function was ~95 launches per table and step (a gather, then per code
// word an XOR and the 19-op SWAR popcount, then the masks), every
// intermediate in device memory, and in the compact layout a gathered
// [Q, slice, blk, W] code slab that included every pad and out-of-window
// slot.
//
// What bounds it on an H100: bytes. Per slot 8 B of output; per chunk 12 B
// of descriptors; per in-window slot 4 B of id, and per valid slot W words
// of code: 16 B coalesced from the inline row, or one 32-byte sector of
// the codes array (a scattered read) in the compact layout. At the cells'
// stage-1 shapes (Q 8192 x 52 chunks x 25 rows inline, 8192 x 132 x 32
// compact) the output alone is 85 and 277 MB, 25 and 83 us at 3.35 TB/s;
// valid slots are a minority (at most a quarter of the 100M cell's
// stage-1 slots). No arithmetic matters: W XOR + POPC per valid slot.
//
// Design: one warp per (query, chunk slot), lane = row in the block (a
// loop over rows where blk > 32, as at W = 1 and 2). The warp reads its
// chunk's blk_id / lo / hi once (one broadcast load each); a chunk with
// lo >= hi writes the sentinels and reads nothing else, so padding slots
// cost their stores alone. A valid lane reads its id, then its code words:
// inline, word w of the warp's lanes is one coalesced stretch of the row;
// compact, one 16-byte read-only load of codes[id] at W = 4 (8-byte or
// 4-byte loads where the base pointer or W does not allow 16). The query's
// words stay in registers. Both outputs are written with consecutive lanes
// on consecutive addresses. Out-of-window and pad slots load no code; no
// temporary of any kind exists, so the compact layout needs no slicing of
// the chunk axis.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int32_t kInfDist = 0x7FFFFFFF;  // ops/topk.INF_DIST
constexpr int32_t kInvalidId = -1;        // ops/topk.INVALID_ID

template <int W>
__device__ __forceinline__ void load_query(const uint32_t* __restrict__ q,
                                           uint32_t (&qw)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = __ldg(q + w);
}

// Distance of the code at p (W consecutive words) to the query words; vec
// is the widest load in words (4, 2 or 1) that p's alignment allows.
template <int W>
__device__ __forceinline__ int32_t score_row(const uint32_t* __restrict__ p,
                                             const uint32_t (&qw)[W],
                                             int vec) {
  uint32_t c[W];
  if constexpr (W % 4 == 0) {
    if (vec == 4) {
#pragma unroll
      for (int w = 0; w < W; w += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + w));
        c[w] = v.x; c[w + 1] = v.y; c[w + 2] = v.z; c[w + 3] = v.w;
      }
      vec = 0;
    }
  }
  if constexpr (W % 2 == 0) {
    if (vec >= 2) {
#pragma unroll
      for (int w = 0; w < W; w += 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + w));
        c[w] = v.x; c[w + 1] = v.y;
      }
      vec = 0;
    }
  }
  if (vec) {
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = __ldg(p + w);
  }
  int32_t s = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) s += __popc(c[w] ^ qw[w]);
  return s;
}

// Distance of the code whose word w is at p[w * stride] to the query
// words: the inline rows' word-major lanes.
template <int W>
__device__ __forceinline__ int32_t score_lanes(const uint32_t* __restrict__ p,
                                               int stride,
                                               const uint32_t (&qw)[W]) {
  int32_t s = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    s += __popc(__ldg(p + (long long)w * stride) ^ qw[w]);
  return s;
}

// kCompact: rows are id rows [n_rows, blk] and the codes come from
// codes[id]; else rows are inline [n_rows, blk * (W + 1)] and the codes
// follow the ids in the row. The rest is shared.
template <int W, bool kCompact>
__global__ void __launch_bounds__(kThreads)
fetch_score_kernel(const int32_t* __restrict__ rows, long long n_rows, int blk,
                   const uint32_t* __restrict__ codes, long long n_codes,
                   int vec, const int32_t* __restrict__ blk_id,
                   const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ hi,
                   const uint32_t* __restrict__ queries,
                   int32_t* __restrict__ dist, int32_t* __restrict__ ids,
                   long long n_chunks, int chb) {
  const long long chunk =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x & 31;
  const int l = __ldg(lo + chunk), h = __ldg(hi + chunk);
  int32_t* d_out = dist + chunk * blk;
  int32_t* i_out = ids + chunk * blk;
  if (l >= h) {
    for (int r = lane; r < blk; r += 32) {
      d_out[r] = kInfDist;
      i_out[r] = kInvalidId;
    }
    return;
  }
  uint32_t qw[W];
  load_query<W>(queries + chunk / chb * W, qw);
  int32_t b = __ldg(blk_id + chunk);
  b = b < 0 ? 0 : (b >= n_rows ? (int32_t)(n_rows - 1) : b);
  const int32_t* row = rows + b * (long long)blk * (kCompact ? 1 : W + 1);
  for (int r = lane; r < blk; r += 32) {
    int32_t d = kInfDist, id = kInvalidId;
    if (r >= l && r < h) {
      const int32_t e = __ldg(row + r);
      if (e >= 0) {
        if constexpr (kCompact)
          d = score_row<W>(codes + (e < n_codes ? e : n_codes - 1) * W, qw,
                           vec);
        else
          d = score_lanes<W>(reinterpret_cast<const uint32_t*>(row) + blk + r,
                             blk, qw);
        id = e;
      }
    }
    d_out[r] = d;
    i_out[r] = id;
  }
}

// The widest load in words (4, 2 or 1) that every row of a [N, w] int32
// array at p can take.
int vec_words(const void* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (w % 4 == 0 && a % 16 == 0) return 4;
  if (w % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

template <int W, bool kCompact>
int launch(const void* rows, long long n_rows, int blk, const void* codes,
           long long n_codes, const void* blk_id, const void* lo,
           const void* hi, const void* queries, void* dist, void* ids,
           long long n_chunks, int chb, cudaStream_t s) {
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fetch_score_kernel<W, kCompact><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(rows), n_rows, blk,
      static_cast<const uint32_t*>(codes), n_codes,
      kCompact ? vec_words(codes, W) : 1,
      static_cast<const int32_t*>(blk_id), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const uint32_t*>(queries),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(ids), n_chunks, chb);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, long long, int, const void*, long long,
                       const void*, const void*, const void*, const void*,
                       void*, void*, long long, int, cudaStream_t);

template <bool kCompact>
int launch_w(int w, const void* rows, long long n_rows, int blk,
             const void* codes, long long n_codes, const void* blk_id,
             const void* lo, const void* hi, const void* queries, void* dist,
             void* ids, int n_queries, int chb, void* stream) {
  static constexpr Launch by_w[8] = {
      launch<1, kCompact>, launch<2, kCompact>, launch<3, kCompact>,
      launch<4, kCompact>, launch<5, kCompact>, launch<6, kCompact>,
      launch<7, kCompact>, launch<8, kCompact>};
  if (w < 1 || w > 8 || blk <= 0 || n_rows <= 0 || n_queries < 0 || chb < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (long long)n_queries * chb;
  if (n_chunks == 0) return 0;
  return by_w[w - 1](rows, n_rows, blk, codes, n_codes, blk_id, lo, hi,
                     queries, dist, ids, n_chunks, chb,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entries for ctypes, one per row layout. Every array is int32,
// contiguous, on the current device: rows [n_rows, blk * (w + 1)], or id
// rows [n_idrows, blk] with codes [n_codes, w]; blk_id, lo, hi
// [n_queries, chb]; queries [n_queries, w]; dist and ids
// [n_queries, chb * blk], written whole. Each launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 = success); w
// outside 1..8 or an empty table is cudaErrorInvalidValue.
extern "C" int vt_fetch_score_rows(const void* rows, long long n_rows,
                                   int blk, const void* blk_id,
                                   const void* lo, const void* hi,
                                   const void* queries, void* dist, void* ids,
                                   int n_queries, int chb, int w,
                                   void* stream) {
  return launch_w<false>(w, rows, n_rows, blk, nullptr, 0, blk_id, lo, hi,
                         queries, dist, ids, n_queries, chb, stream);
}

extern "C" int vt_fetch_score_idrows(const void* idrows, long long n_idrows,
                                     int blk, const void* codes,
                                     long long n_codes, const void* blk_id,
                                     const void* lo, const void* hi,
                                     const void* queries, void* dist,
                                     void* ids, int n_queries, int chb, int w,
                                     void* stream) {
  if (n_codes <= 0) return (int)cudaErrorInvalidValue;
  return launch_w<true>(w, idrows, n_idrows, blk, codes, n_codes, blk_id, lo,
                        hi, queries, dist, ids, n_queries, chb, stream);
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
