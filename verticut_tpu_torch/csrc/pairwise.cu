// All-pairs Hamming distance for Hopper (sm_90a): the distance matrix of
// the brute-force scan behind linear_search(method="pallas")
// (verticut_tpu_torch/ops/hamming.py, scan_pallas).
//
//   out[q, j] = popcount(queries[q] ^ db[j])   (summed over the 4 words)
//
// queries int32[Q, 4], db int32[N, 4] row-major (128-bit codes, one 16-byte
// load per code), out int32[Q, N]; any Q and N, no padding.
//
// Replaces the TPU kernel K4 pallas_pairwise_hamming (body _kernel) of
// verticut_tpu/ops/pallas/linear_scan.py, which computes the same matrix as
// a +-1 bf16 MXU GEMM, (32W - dot) / 2, over (256, 512) tiles that the
// caller pads to.
//
// What bounds it on an H100: the store. Every pair writes 4 bytes and costs
// 4 XOR, 4 POPC and 3 IADD; at 3.35 TB/s the store is 1.19 ps per pair and
// the POPCs (16 per clock per SM, 132 SMs, 1.98 GHz) 0.96 ps. Design:
//   * a thread block owns kCodes consecutive codes and a tile of kQTile
//     queries; thread t keeps codes t, t + 256, t + 512, t + 768 of the
//     tile in registers, loaded with coalesced 16-byte loads;
//   * the query tile is staged in shared memory, so each query is one
//     broadcast 16-byte shared load;
//   * per query a warp stores 32 neighbouring int32 four times: every
//     store instruction writes 128 contiguous bytes. The stores are
//     streaming (__stcs): the matrix is far larger than the L2.
// Offsets into out are 64-bit: Q * N passes 2^31 at 8192 x 262144.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCodes = kThreads * kPerThread;
constexpr int kQTile = 64;

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

}  // namespace

// Plain C entry for ctypes. queries int32[n_queries, 4], db int32[n, 4],
// out int32[n_queries, n]; all contiguous on the current device. Launches
// on `stream` without synchronising and returns the launch's cudaError_t
// (0 = success).
extern "C" int vt_pairwise(const void* queries, const void* db, void* out,
                           int n_queries, long long n, void* stream) {
  if (n_queries <= 0 || n <= 0) return 0;
  const long long nx = (n + kCodes - 1) / kCodes;
  const long long ny = (n_queries + kQTile - 1) / kQTile;
  if (nx > 0x7fffffffLL || ny > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)nx, (unsigned)ny);
  pairwise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(queries), static_cast<const uint4*>(db),
      static_cast<int32_t*>(out), n_queries, n);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
