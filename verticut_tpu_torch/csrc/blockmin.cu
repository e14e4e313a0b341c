// Block-min Hamming scan for Hopper (sm_90a): pass 1 of the exact
// block-min pre-selection scan (verticut_tpu_torch/ops/hamming.py).
//
//   out[q, b] = min over rows r in [b*block, (b+1)*block), r < n, of
//               popcount(queries[q] ^ db[r]);   32*W + 1 if no such row
//
// queries int32[Q, W], db int32[N, W] row-major (W words per code), out
// int32[Q, ceil(N / block)]; any W >= 1 (up to kMaxWords) and any block >= 1.
//
// Replaces the TPU kernels of verticut_tpu/ops/pallas/linear_scan.py:
//   K1 pallas_blockmin_t2 (body _blockmin_kernel_t2), Q in (2048, 8192];
//   K2 pallas_blockmin_t  (body _blockmin_kernel_t),  every other Q;
//   K3 pallas_blockmin    (body _blockmin_kernel), the row-major corpus.
// All three compute this function as a +-1 GEMM, (32W - max dot) / 2; K1
// and K2 over a transposed corpus copy (their split exists only for VMEM
// residency), K3 over the row-major corpus with the straddling block
// recomputed outside the kernel. Rows past n are excluded here, which is
// K3's contract, so callers need no tail fix-up.
//
// What bounds it on an H100: the integer pipe's POPC rate, not bytes. Each
// (query, code) pair costs W XOR, W POPC, W-1 IADD and 1 IMNMX; at Q = 8192
// every code read from memory feeds 8192 * W POPCs, and POPC issues at a
// quarter of the ALU rate.
//
// Two instances:
//   * the fast instance, 128-bit codes (W = 4) and blocks 32..512 (powers
//     of two), the main path's shapes: a thread block owns one code block
//     and a tile of kQTile queries; the code block is staged in shared
//     memory with coalesced 16-byte loads, then each lane keeps block/32
//     codes in registers for the whole query tile, so the inner loop
//     touches no memory but one broadcast 16-byte shared load per query;
//     lanes hold neighbouring codes, so a query's minimum over the block is
//     one warp reduction (__reduce_min_sync); full blocks take a loop
//     without the row-validity select;
//   * the generic instance, any W and any block, for correctness rather
//     than speed. Codes sit in shared memory as W words (a runtime W rules
//     out register arrays), queries are read through the read-only cache
//     (one broadcast load per word for a warp). A block of 32 rows or more
//     takes one thread block per code block: the rows pass through shared
//     memory in sub-tiles, every warp scans all of them for its own queries
//     and keeps per-query running minima in registers, then reduces them
//     across its lanes. A block under 32 rows takes a lane group of
//     pow2ceil(block) lanes per code block, one row per lane, and reduces
//     within the group (__shfl_xor_sync with the group as width).
// An int8 +-1 tensor-core (wgmma) or b1 mma version is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// ---------------------------------------------------------------- fast path

constexpr int kWords = 4;
constexpr int kBits = 32 * kWords;
constexpr int kQTile = 128;

__device__ __forceinline__ unsigned dist4(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

template <int BLOCK, bool FULL>
__device__ __forceinline__ void scan_tile(const uint4 (&c)[BLOCK / 32],
                                          const uint4* s_q, int q_count,
                                          int valid, int lane, int warp,
                                          int32_t* __restrict__ out_col,
                                          long long nb) {
  constexpr int C = BLOCK / 32;
  for (int qi = warp; qi < q_count; qi += kWarps) {
    const uint4 q = s_q[qi];
    unsigned m = kBits + 1;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const unsigned d = dist4(c[j], q);
      if (FULL || lane + 32 * j < valid) m = min(m, d);
    }
    m = __reduce_min_sync(0xffffffffu, m);
    if (lane == 0) out_col[qi * nb] = static_cast<int32_t>(m);
  }
}

template <int BLOCK>
__global__ void __launch_bounds__(kThreads)
blockmin_kernel(const uint4* __restrict__ queries, const uint4* __restrict__ db,
                int32_t* __restrict__ out, int n_queries, long long n,
                long long nb) {
  constexpr int C = BLOCK / 32;
  __shared__ uint4 s_codes[BLOCK];
  __shared__ uint4 s_q[kQTile];

  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = b * BLOCK;
  const long long left = n - row0;
  const int valid = left <= 0 ? 0 : (left >= BLOCK ? BLOCK : (int)left);
  const int q_count = min(kQTile, n_queries - q0);

  for (int i = threadIdx.x; i < BLOCK; i += kThreads)
    s_codes[i] = i < valid ? db[row0 + i] : make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < q_count; i += kThreads)
    s_q[i] = queries[q0 + i];
  __syncthreads();

  uint4 c[C];
#pragma unroll
  for (int j = 0; j < C; ++j) c[j] = s_codes[lane + 32 * j];

  int32_t* out_col = out + (long long)q0 * nb + b;
  if (valid == BLOCK)
    scan_tile<BLOCK, true>(c, s_q, q_count, valid, lane, warp, out_col, nb);
  else
    scan_tile<BLOCK, false>(c, s_q, q_count, valid, lane, warp, out_col, nb);
}

template <int BLOCK>
cudaError_t launch_fast(const void* queries, const void* db, void* out,
                        int n_queries, long long n, long long nb,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)nb, (unsigned)((n_queries + kQTile - 1) / kQTile));
  blockmin_kernel<BLOCK><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(queries), static_cast<const uint4*>(db),
      static_cast<int32_t*>(out), n_queries, n, nb);
  return cudaGetLastError();
}

// ------------------------------------------------------------- generic path

// queries per thread block of the generic instance (kSlots per warp)
constexpr int kGQTile = 64;
constexpr int kSlots = kGQTile / kWarps;
// the default dynamic shared memory of a block, and the most a block can
// opt in to on Hopper; the second bounds W at kMaxWords (one warp of codes)
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;
constexpr int kMaxWords = kSmemMax / (32 * 4);

__device__ __forceinline__ unsigned dist_w(const uint32_t* a,
                                           const uint32_t* __restrict__ q,
                                           int w) {
  unsigned d = 0;
  for (int j = 0; j < w; ++j) d += __popc(a[j] ^ __ldg(q + j));
  return d;
}

// block >= 32: one thread block per code block; sub_rows rows of it at a
// time in shared memory; warp `warp` owns queries warp + kWarps * s.
__global__ void __launch_bounds__(kThreads)
blockmin_wide_kernel(const uint32_t* __restrict__ queries,
                     const uint32_t* __restrict__ db,
                     int32_t* __restrict__ out, int n_queries, long long n,
                     long long nb, int w, long long block, int sub_rows) {
  extern __shared__ uint32_t s_codes[];   // [sub_rows, w]
  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * kGQTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = b * block;
  const long long left = n - row0;
  const long long valid = left <= 0 ? 0 : (left >= block ? block : left);
  const int q_count = min(kGQTile, n_queries - q0);

  unsigned m[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) m[s] = 32u * w + 1u;

  for (long long r = 0; r < valid; r += sub_rows) {
    const int cnt = (int)min((long long)sub_rows, valid - r);
    __syncthreads();
    const uint32_t* src = db + (row0 + r) * w;
    for (int i = threadIdx.x; i < cnt * w; i += kThreads) s_codes[i] = src[i];
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int qi = warp + kWarps * s;
      if (qi < q_count) {
        const uint32_t* q = queries + (long long)(q0 + qi) * w;
        for (int c = lane; c < cnt; c += 32)
          m[s] = min(m[s], dist_w(s_codes + c * w, q, w));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int qi = warp + kWarps * s;
    if (qi < q_count) {   // uniform across the warp
      const unsigned mm = __reduce_min_sync(0xffffffffu, m[s]);
      if (lane == 0) out[(long long)(q0 + qi) * nb + b] = (int32_t)mm;
    }
  }
}

// block < 32: lane groups of g = pow2ceil(block) lanes, one code block per
// group and one row per lane (lanes past the block idle at 32W + 1).
__global__ void blockmin_narrow_kernel(const uint32_t* __restrict__ queries,
                                       const uint32_t* __restrict__ db,
                                       int32_t* __restrict__ out,
                                       int n_queries, long long n,
                                       long long nb, int w, int block, int g) {
  extern __shared__ uint32_t s_codes[];   // [blockDim.x, w]
  const int t = threadIdx.x;
  const int lig = t & (g - 1);
  const long long b = (long long)blockIdx.x * (blockDim.x / g) + t / g;
  const long long row = b * block + lig;
  const bool active = lig < block && b < nb && row < n;
  uint32_t* mine = s_codes + t * w;
  for (int j = 0; j < w; ++j) mine[j] = active ? db[row * w + j] : 0u;
  const int q0 = blockIdx.y * kGQTile;
  const int q_count = min(kGQTile, n_queries - q0);
  for (int qi = 0; qi < q_count; ++qi) {
    const uint32_t* q = queries + (long long)(q0 + qi) * w;
    unsigned m = active ? dist_w(mine, q, w) : 32u * w + 1u;
    for (int off = g >> 1; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, off, g));
    if (lig == 0 && b < nb) out[(long long)(q0 + qi) * nb + b] = (int32_t)m;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

cudaError_t launch_generic(const void* queries, const void* db, void* out,
                           int n_queries, long long n, long long nb, int w,
                           long long block, cudaStream_t stream) {
  if (w > kMaxWords) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)((n_queries + kGQTile - 1) / kGQTile);
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  const uint32_t* d = static_cast<const uint32_t*>(db);
  int32_t* o = static_cast<int32_t*>(out);
  cudaError_t err;
  if (block >= 32) {
    // sub-tiles of up to 256 rows that fit the default shared memory, or
    // one warp's 32 rows with the opt-in limit for very wide codes
    int sub = (kSmemDefault / (4 * w)) / 32 * 32;
    sub = sub > 256 ? 256 : (sub < 32 ? 32 : sub);
    const size_t smem = (size_t)sub * w * 4;
    if ((err = set_smem(blockmin_wide_kernel, smem)) != cudaSuccess)
      return err;
    // grid.x = nb <= 2^31 - 1 is checked by the caller
    blockmin_wide_kernel<<<dim3((unsigned)nb, gy), kThreads, smem, stream>>>(
        q, d, o, n_queries, n, nb, w, block, sub);
    return cudaGetLastError();
  }
  int g = 1;
  while (g < block) g <<= 1;
  // whole warps, as many as fit the default shared memory (one at least)
  int warps = kSmemDefault / (32 * 4 * w);
  warps = warps > kWarps ? kWarps : (warps < 1 ? 1 : warps);
  const int threads = 32 * warps;
  const size_t smem = (size_t)threads * w * 4;
  if ((err = set_smem(blockmin_narrow_kernel, smem)) != cudaSuccess)
    return err;
  const long long per = threads / g;   // code blocks per thread block
  const long long gx = (nb + per - 1) / per;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blockmin_narrow_kernel<<<dim3((unsigned)gx, gy), threads, smem, stream>>>(
      q, d, o, n_queries, n, nb, w, (int)block, g);
  return cudaGetLastError();
}

bool fast_block(long long block) {
  return block == 32 || block == 64 || block == 128 || block == 256 ||
         block == 512;
}

}  // namespace

// Plain C entry for ctypes. queries int32[n_queries, w], db int32[n_rows, w]
// (n <= n_rows valid rows), out int32[n_queries, ceil(n_rows / block)]; all
// contiguous on the current device. W = 4 with a power-of-two block from 32
// to 512 takes the fast instance; everything else takes the generic
// instance. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = success).
//
// The grids: the fast and the wide generic instance launch nb x ceil(Q/128)
// (ceil(Q/64)) thread blocks and the narrow one ceil(nb / (threads / g)) x
// ceil(Q/64). nb must stay under 2^31 for the first two: at block 32 that is
// 68.7G rows; the narrow one takes block 1 at any n under 2^31 * 8.
extern "C" int vt_blockmin(const void* queries, const void* db, void* out,
                           int n_queries, long long n, long long n_rows,
                           int w, long long block, void* stream) {
  if (w <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n_rows + block - 1) / block;
  if (n_queries <= 0 || nb <= 0) return 0;
  if ((block >= 32 && nb > 0x7fffffffLL) ||
      (n_queries + kGQTile - 1) / kGQTile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != kWords || !fast_block(block))
    return (int)launch_generic(queries, db, out, n_queries, n, nb, w, block,
                               s);
  switch (block) {
    case 32: return (int)launch_fast<32>(queries, db, out, n_queries, n, nb, s);
    case 64: return (int)launch_fast<64>(queries, db, out, n_queries, n, nb, s);
    case 128:
      return (int)launch_fast<128>(queries, db, out, n_queries, n, nb, s);
    case 256:
      return (int)launch_fast<256>(queries, db, out, n_queries, n, nb, s);
    default:
      return (int)launch_fast<512>(queries, db, out, n_queries, n, nb, s);
  }
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
