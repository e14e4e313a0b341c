// All-pairs Hamming distance for Hopper (sm_90a): the distance matrix of
// the brute-force scan behind linear_search(method="pallas")
// (verticut_tpu_torch/ops/hamming.py, scan_pallas).
//
//   out[q, j] = popcount(queries[q] ^ db[j])   (summed over the W words)
//
// queries int32[Q, W], db int32[N, W] row-major, out int32[Q, N]; any Q and
// N, no padding; any W >= 1 (up to kMaxWords).
//
// Replaces the TPU kernel K4 pallas_pairwise_hamming (body _kernel) of
// verticut_tpu/ops/pallas/linear_scan.py, which computes the same matrix as
// a +-1 bf16 MXU GEMM, (32W - dot) / 2, over (256, 512) tiles that the
// caller pads to.
//
// What bounds it on an H100: the store. Every pair writes 4 bytes and costs
// W XOR, W POPC and W - 1 IADD; at W = 4 and 3.35 TB/s the store is
// 1.19 ps per pair and the POPCs (16 per clock per SM, 132 SMs, 1.98 GHz)
// 0.96 ps. Two instances:
//   * the fast one, 128-bit codes (W = 4): a thread block owns kCodes
//     consecutive codes and a tile of kQTile queries; thread t keeps codes
//     t, t + 256, t + 512, t + 768 of the tile in registers, loaded with
//     coalesced 16-byte loads; the query tile is staged in shared memory,
//     so each query is one broadcast 16-byte shared load; per query a warp
//     stores 32 neighbouring int32 four times: every store instruction
//     writes 128 contiguous bytes. The stores are streaming (__stcs): the
//     matrix is far larger than the L2;
//   * the generic one, any W, for correctness rather than speed: a thread
//     owns one code, held in shared memory as W words (a runtime W rules
//     out register arrays), and reads the query words through the
//     read-only cache (one broadcast load per word for a warp); the stores
//     are the fast instance's, one 128-byte line per warp and query.
// Offsets into out are 64-bit: Q * N passes 2^31 at 8192 x 262144.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCodes = kThreads * kPerThread;
constexpr int kQTile = 64;
constexpr int kWords = 4;
// the default dynamic shared memory of a block, and the most a block can
// opt in to on Hopper; the second bounds W at kMaxWords (one warp of codes)
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;
constexpr int kMaxWords = kSmemMax / (32 * 4);

__device__ __forceinline__ int dist4(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const uint4* __restrict__ queries, const uint4* __restrict__ db,
                int32_t* __restrict__ out, int n_queries, long long n) {
  __shared__ uint4 s_q[kQTile];
  const long long j0 = (long long)blockIdx.x * kCodes + threadIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int q_count = min(kQTile, n_queries - q0);

  for (int i = threadIdx.x; i < q_count; i += kThreads)
    s_q[i] = queries[q0 + i];

  uint4 c[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = j0 + i * kThreads;
    c[i] = j < n ? db[j] : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  int32_t* row = out + (long long)q0 * n + j0;
  if (j0 + (kPerThread - 1) * kThreads < n) {
    for (int qi = 0; qi < q_count; ++qi, row += n) {
      const uint4 q = s_q[qi];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        __stcs(row + i * kThreads, dist4(c[i], q));
    }
  } else {
    for (int qi = 0; qi < q_count; ++qi, row += n) {
      const uint4 q = s_q[qi];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (j0 + i * kThreads < n) __stcs(row + i * kThreads, dist4(c[i], q));
    }
  }
}

__global__ void pairwise_generic_kernel(const uint32_t* __restrict__ queries,
                                        const uint32_t* __restrict__ db,
                                        int32_t* __restrict__ out,
                                        int n_queries, long long n, int w) {
  extern __shared__ uint32_t s_codes[];   // [blockDim.x, w]
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int q_count = min(kQTile, n_queries - q0);
  if (j >= n) return;   // no barrier below
  uint32_t* mine = s_codes + threadIdx.x * w;
  for (int k = 0; k < w; ++k) mine[k] = db[j * w + k];
  int32_t* row = out + (long long)q0 * n + j;
  for (int qi = 0; qi < q_count; ++qi, row += n) {
    const uint32_t* q = queries + (long long)(q0 + qi) * w;
    int d = 0;
    for (int k = 0; k < w; ++k) d += __popc(mine[k] ^ __ldg(q + k));
    __stcs(row, d);
  }
}

}  // namespace

// Plain C entry for ctypes. queries int32[n_queries, w], db int32[n, w],
// out int32[n_queries, n]; all contiguous on the current device. W = 4
// takes the fast instance, every other W the generic one. Launches on
// `stream` without synchronising and returns the launch's cudaError_t
// (0 = success).
extern "C" int vt_pairwise(const void* queries, const void* db, void* out,
                           int n_queries, long long n, int w, void* stream) {
  if (w <= 0 || w > kMaxWords) return (int)cudaErrorInvalidValue;
  if (n_queries <= 0 || n <= 0) return 0;
  const long long ny = (n_queries + kQTile - 1) / kQTile;
  if (ny > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == kWords) {
    const long long nx = (n + kCodes - 1) / kCodes;
    if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    pairwise_kernel<<<dim3((unsigned)nx, (unsigned)ny), kThreads, 0, s>>>(
        static_cast<const uint4*>(queries), static_cast<const uint4*>(db),
        static_cast<int32_t*>(out), n_queries, n);
    return (int)cudaGetLastError();
  }
  // whole warps, as many as fit the default shared memory (one at least)
  int warps = kSmemDefault / (32 * 4 * w);
  warps = warps > kThreads / 32 ? kThreads / 32 : (warps < 1 ? 1 : warps);
  const int threads = 32 * warps;
  const size_t smem = (size_t)threads * w * 4;
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairwise_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nx = (n + threads - 1) / threads;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pairwise_generic_kernel<<<dim3((unsigned)nx, (unsigned)ny), threads, smem,
                            s>>>(static_cast<const uint32_t*>(queries),
                                 static_cast<const uint32_t*>(db),
                                 static_cast<int32_t*>(out), n_queries, n, w);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
