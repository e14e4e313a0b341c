// Block-min Hamming scan for Hopper (sm_90a): pass 1 of the exact
// block-min pre-selection scan (verticut_tpu_torch/ops/hamming.py).
//
//   out[q, b] = min over rows r in [b*block, (b+1)*block), r < n, of
//               popcount(queries[q] ^ db[r]);   bits + 1 if no such row
//
// queries int32[Q, 4], db int32[N, 4] row-major (128-bit codes, one 16-byte
// load per code), out int32[Q, ceil(N / block)].
//
// Replaces the TPU kernels of verticut_tpu/ops/pallas/linear_scan.py:
//   K1 pallas_blockmin_t2 (body _blockmin_kernel_t2), Q in (2048, 8192];
//   K2 pallas_blockmin_t  (body _blockmin_kernel_t),  every other Q;
//   K3 pallas_blockmin    (body _blockmin_kernel), the row-major corpus.
// All three compute this function as a +-1 GEMM, (32W - max dot) / 2; K1
// and K2 over a transposed corpus copy (their split exists only for VMEM
// residency), K3 over the row-major corpus with the straddling block
// recomputed outside the kernel. Rows past n are excluded here, which is
// K3's contract, so callers need no tail fix-up. Blocks 32..512 (powers of
// two) are instantiated; K3 also takes 16, 1024 and 2048, which this
// kernel does not.
//
// What bounds it on an H100: the integer pipe's POPC rate, not bytes. Each
// (query, code) pair costs 4 XOR, 4 POPC, 3 IADD and 1 IMNMX; at Q = 8192
// every 16-byte code read from memory feeds 8192 * 4 = 32768 POPCs, and
// POPC issues at a quarter of the ALU rate. Design:
//   * a thread block owns one code block and a tile of kQTile queries;
//   * the code block is staged in shared memory with coalesced 16-byte
//     loads (neighbouring threads on neighbouring codes), then each lane
//     keeps block/32 codes in registers for the whole query tile, so the
//     inner loop touches no memory but one broadcast 16-byte shared load
//     per query;
//   * lanes hold neighbouring codes, so a query's minimum over the block is
//     one warp reduction (__reduce_min_sync) after the per-lane minima;
//   * full blocks take a loop without the row-validity select.
// An int8 +-1 tensor-core (wgmma) or b1 mma version is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 4;
constexpr int kBits = 32 * kWords;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
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
cudaError_t launch(const void* queries, const void* db, void* out,
                   int n_queries, long long n, long long nb,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)nb, (unsigned)((n_queries + kQTile - 1) / kQTile));
  blockmin_kernel<BLOCK><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(queries), static_cast<const uint4*>(db),
      static_cast<int32_t*>(out), n_queries, n, nb);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. queries int32[n_queries, 4], db int32[n_rows, 4]
// (n <= n_rows valid rows), out int32[n_queries, ceil(n_rows / block)];
// all contiguous on the current device. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 = success).
extern "C" int vt_blockmin(const void* queries, const void* db, void* out,
                           int n_queries, long long n, long long n_rows,
                           int block, void* stream) {
  const long long nb = (n_rows + block - 1) / block;
  if (n_queries <= 0 || nb <= 0) return 0;
  if (nb > 0x7fffffffLL || (n_queries + kQTile - 1) / kQTile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 32: return (int)launch<32>(queries, db, out, n_queries, n, nb, s);
    case 64: return (int)launch<64>(queries, db, out, n_queries, n, nb, s);
    case 128: return (int)launch<128>(queries, db, out, n_queries, n, nb, s);
    case 256: return (int)launch<256>(queries, db, out, n_queries, n, nb, s);
    case 512: return (int)launch<512>(queries, db, out, n_queries, n, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
