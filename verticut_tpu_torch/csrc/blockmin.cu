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
// Two instances. The caller names the one to run
// (verticut_tpu_torch/kernels/blockmin.py:instance, a function of W and
// the block alone); vt_blockmin refuses the tensor-core instance for a
// shape it cannot take (tc_fits below):
//
// * the tensor-core instance, W = 1..8 and power-of-two blocks 32..2048
//   (every shape of the search paths). It computes what the TPU kernels
//   compute, a GEMM over the code bits, on Hopper's int8 tensor cores, in
//   the form cheapest to feed: hamming(q, c) = popcount(q) - sum q_i * c_i
//   with q_i = +-1 and c_i in {0, 1}, exact in int32, so the block minimum
//   is popcount(q) - the block's maximum dot. Bound: the int8 tensor-core
//   rate, 2 * Q * N * 32W operations (1.06 ms at Q = 8192, N = 1M, W = 4
//   on an H100 at 1,979 TOP/s); bytes are ~1% of that.
//   Design:
//     - wgmma m64n128k32 s32.s8.s8, one k-step per code word. A (the
//       queries) lives in registers: each thread expands its fragment once
//       per work item straight from the packed queries. B (the codes) is
//       expanded in shared memory, in the no-swizzle K-major layout of 8
//       x 16-byte core matrices, from packed words prefetched into
//       registers a tile ahead; no unpacked copy of the corpus exists.
//     - the expansion is the integer pipe's work, which runs at half the
//       rate of the float pipe and also carries the epilogue, so it is made
//       as cheap as the order allows: byte j of 4-byte group t of word w's
//       32 bytes is bit t + 8j, and group t of a code is the word masked in
//       place (c * 2^t, one instruction per 4 bytes; code_group) while the
//       query side carries the inverse scale (query_group), so every
//       product is +-64 * c. Any order that is the same for queries and
//       codes gives the same dot; kernels/blockmin.py:expand_queries and
//       expand_codes mirror this one for the CPU tests.
//     - a CTA is two warpgroups, 128 queries, and walks 128-code tiles
//       through two shared-memory buffers: the tile's wgmma runs while the
//       threads expand the next tile, then the epilogue reduces the int32
//       accumulators in registers. Two CTAs per SM let one CTA's expansion
//       and epilogue overlap the other's MMA.
//     - the epilogue: in the m64nN fragment the four threads of a quad
//       share a row, so a block's maximum is a per-thread max over the
//       block's columns and two __shfl_xor_sync; blocks above 128 rows
//       carry a running max across tiles. Rows >= n are masked with
//       INT_MIN in the ragged last tile only; an all-masked block writes
//       32W + 1.
//     - the grid splits the corpus as well as the queries: a work item is
//       a 128-query tile and a 2048-row chunk (whole blocks), and a grid
//       of as many CTAs as fit the card walks the items, so a 128-query
//       straggler scan still fills every SM.
// * the generic instance, any W and any block, on the CUDA cores (XOR +
//   POPC), for the shapes the tensor-core instance does not take: blocks
//   under 32 or not a power of two, blocks above 2048, W above 8. Codes
//   sit in shared memory as W words (a runtime W rules out register
//   arrays), queries are read through the read-only cache (one broadcast
//   load per word for a warp). A block of 32 rows or more takes one thread
//   block per code block: the rows pass through shared memory in
//   sub-tiles, every warp scans all of them for its own queries and keeps
//   per-query running minima in registers, then reduces them across its
//   lanes. A block under 32 rows takes a lane group of pow2ceil(block)
//   lanes per code block, one row per lane, and reduces within the group
//   (__shfl_xor_sync with the group as width).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// the default dynamic shared memory of a block, and the most a block can
// opt in to on Hopper; the second bounds W at kMaxWords (one warp of codes)
// in the generic instance
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;
constexpr int kMaxWords = kSmemMax / (32 * 4);

// ------------------------------------------------------- tensor-core path

constexpr int kTcQ = 128;             // queries per CTA: two warpgroups x 64
constexpr int kTcN = 128;             // codes per tile: the wgmma N
constexpr long long kTcChunk = 2048;  // rows per work item (whole blocks)
constexpr int kTcMaxWords = 8;
constexpr long long kTcMaxBlock = 2048;

// The operands. hamming(q, c) = popcount(q) - sum_i q_i * c_i with q_i in
// {+1, -1} and c_i in {0, 1}, so the block minimum is popcount(q) - the
// block's maximum dot, and a code needs no +-1 conversion. Bit t + 8j of a
// word goes to byte j of its 4-byte group t (32 bytes per word); group t
// of a code holds c * 2^t (the word masked in place, one instruction; 64
// for t = 7) and group t of a query +-2^(6-t) (+-1 for t = 7), so every
// product is +-64 * c and dot = D / 64 exactly (|D| <= 2048 W).
__device__ __forceinline__ uint32_t code_group(uint32_t x, int t) {
  return t < 7 ? x & (0x01010101u << t) : (x >> 1) & 0x40404040u;
}
__device__ __forceinline__ uint32_t query_group(uint32_t nx, int t) {
  // +-1 per byte ((bit clear) * 0xFE + 1, nx = ~x), then times 2^s per
  // byte: the shift's carries into the next byte fall under the mask
  const uint32_t pm = ((nx >> t) & 0x01010101u) * 0xFEu + 0x01010101u;
  const int sh = t < 7 ? 6 - t : 0;
  return (pm << sh) & (0x01010101u * ((0xFFu << sh) & 0xFFu));
}

// Shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between the two 16-byte core-matrix columns of a k-step)
// and stride byte offset (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_operands(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T in int8 -> int32: A from
// registers (the four words of this thread's fragment), B from shared
// memory through its descriptor; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %69, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc_b));
}

__device__ __forceinline__ int32_t max3(int32_t a, int32_t b, int32_t c) {
  return max(a, max(b, c));
}

// Row maxima of chunks [c0, c0 + NC) of the accumulator (8 columns each),
// folded into lo (this thread's row) and hi (the row 8 below) through four
// independent partial maxima a row, so the max chains stay short. MASK:
// columns at global row >= n are -inf (the ragged last tile only).
template <int NC, bool MASK>
__device__ __forceinline__ void chunk_max(const int32_t (&d)[64], int c0,
                                          long long col0, long long n,
                                          int32_t& lo, int32_t& hi) {
  int32_t pl[4] = {lo, INT_MIN, INT_MIN, INT_MIN};
  int32_t ph[4] = {hi, INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    int32_t v0 = d[4 * (c0 + i)], v1 = d[4 * (c0 + i) + 1];
    int32_t v2 = d[4 * (c0 + i) + 2], v3 = d[4 * (c0 + i) + 3];
    if (MASK) {
      const long long r = col0 + 8 * i;
      if (r >= n) v0 = v2 = INT_MIN;
      if (r + 1 >= n) v1 = v3 = INT_MIN;
    }
    pl[i & 3] = max3(pl[i & 3], v0, v1);
    ph[i & 3] = max3(ph[i & 3], v2, v3);
  }
  lo = max3(pl[0], pl[1], max(pl[2], pl[3]));
  hi = max3(ph[0], ph[1], max(ph[2], ph[3]));
}

// The quad's two rows of block b, reduced across the quad in two
// shuffles: lanes with quad bit 0 clear keep the upper row and pass the
// lower one, the others the reverse, so quad lane 0 ends with the upper
// row's maximum and lane 1 with the lower one's, and each writes its row;
// pop is the row's popcount. A max of INT_MIN (every row masked) is an
// empty block.
template <int W>
__device__ __forceinline__ void write_rows(int32_t lo, int32_t hi, int quad,
                                           int pop_lo, int pop_hi, int q,
                                           int nq, long long b, long long nb,
                                           int32_t* out) {
  const bool odd = quad & 1;
  int32_t v = max(odd ? hi : lo,
                  __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1));
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
  const int row = odd ? q + 8 : q;
  if (quad < 2 && row < nq && b < nb)
    out[(long long)row * nb + b] =
        v == INT_MIN ? 32 * W + 1 : (odd ? pop_hi : pop_lo) - (v >> 6);
}

// W code words; BT = min(block, kTcN), the block's share of a tile.
template <int W, int BT>
__global__ void __launch_bounds__(kThreads, 2)
blockmin_tc_kernel(const int32_t* __restrict__ queries,
                   const int32_t* __restrict__ db, int32_t* __restrict__ out,
                   int nq, long long n, long long nb, int lb, int qtiles,
                   long long items) {
  constexpr int K = 32 * W;                    // bytes of an expanded code
  constexpr int kTile = kTcN * K;              // bytes of a B buffer
  constexpr int kUnits = kTcN * W;             // packed words of a tile
  constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
  constexpr int kSub = kTcN / BT;              // blocks in a tile
  constexpr int kChunks = BT / 8;              // 8-column chunks per block
  // two B buffers, each [kTcN / 8][W][2][8][16] bytes: 8-row groups, k-steps,
  // the two 16-byte core-matrix columns of a k-step, rows, bytes
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int quad = lane & 3;
  const int row_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const long long rows_end = nb << lb;                // block = 1 << lb

  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (int)(item % qtiles) * kTcQ;
    const long long c0 = (item / qtiles) * kTcChunk;
    const long long c1 = min(c0 + kTcChunk, rows_end);
    const long long rv = min(c1, n);

    // blocks of the chunk with no row < n: empty
    const long long b0 = c0 >> lb;             // the chunk's first block
    const long long bfirst = rv > c0 ? ((rv - 1) >> lb) + 1 : b0;
    const long long nfill = (c1 >> lb) - bfirst;
    for (long long i = tid; i < nfill * kTcQ; i += kThreads) {
      const int r = q0 + (int)(i / nfill);
      if (r < nq) out[(long long)r * nb + bfirst + i % nfill] = 32 * W + 1;
    }
    if (rv <= c0) continue;                    // uniform across the CTA

    // this thread's A fragment for every k-step: rows row_lo and
    // row_lo + 8, bytes 4 * quad.. (t = quad) and 16 + 4 * quad.. (t =
    // quad + 4) of each word's 32. ptxas serializes every wgmma of the
    // kernel if a wgmma sits under a branch or its A registers were set
    // under one, and injects a warpgroup.arrive before each k-step if it
    // may recompute them there: so rows past nq repeat the last query
    // (never written out), a warpgroup with no real row runs its wgmma all
    // the same, and the empty asm pins the fragment in its registers.
    uint32_t a[W][4];
    int pop_lo = 0, pop_hi = 0;            // popcount of the two rows
    {
      const int qa = q0 + row_lo, qb = qa + 8;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint32_t xa = queries[(long long)min(qa, nq - 1) * W + j];
        const uint32_t xb = queries[(long long)min(qb, nq - 1) * W + j];
        pop_lo += __popc(xa);
        pop_hi += __popc(xb);
        a[j][0] = query_group(~xa, quad);
        a[j][1] = query_group(~xb, quad);
        a[j][2] = query_group(~xa, quad + 4);
        a[j][3] = query_group(~xb, quad + 4);
        asm volatile("" : "+r"(a[j][0]), "+r"(a[j][1]), "+r"(a[j][2]),
                     "+r"(a[j][3]));
      }
    }

    // packed words of a tile: unit u is word u / kTcN of code u % kTcN, so
    // the 8 lanes of each phase of a 16-byte shared store write 128
    // contiguous bytes (one word of 8 neighbouring codes: no bank
    // conflict); rows >= n read as 0 (masked in the epilogue)
    uint32_t pre[kPer];
    auto load = [&](long long r0) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int u = tid + p * kThreads;
        const int c = u % kTcN, w = u / kTcN;
        pre[p] = (u < kUnits && r0 + c < n) ? (uint32_t)db[(r0 + c) * W + w]
                                            : 0u;
      }
    };
    // expand into buffer buf: code c's word w fills the core matrices of
    // k-step w, 16 bytes at (c / 8) * 8K + w * 256 + h * 128 + (c % 8) * 16
    auto expand = [&](int buf) {
      uint8_t* base = smem + buf * kTile;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int u = tid + p * kThreads;
        if (u < kUnits) {
          const int c = u % kTcN, w = u / kTcN;
          const uint32_t x = pre[p];
          uint4* dst = reinterpret_cast<uint4*>(base + (c >> 3) * (8 * K) +
                                                w * 256 + (c & 7) * 16);
          dst[0] = make_uint4(code_group(x, 0), code_group(x, 1),
                              code_group(x, 2), code_group(x, 3));
          dst[8] = make_uint4(code_group(x, 4), code_group(x, 5),
                              code_group(x, 6), code_group(x, 7));
        }
      }
    };

    const int ntiles = (int)((rv - c0 + kTcN - 1) / kTcN);
    load(c0);
    expand(0);
    if (ntiles > 1) load(c0 + kTcN);
    fence_async_smem();
    __syncthreads();

    int32_t run_lo = INT_MIN, run_hi = INT_MIN;   // blocks above kTcN rows
    for (int t = 0; t < ntiles; ++t) {
      const int buf = t & 1;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < W; ++j)
        wgmma_m64n128k32(
            acc, a[j], smem_desc(sbase + buf * kTile + j * 256, 128, 8 * K),
            j);
      wgmma_commit();
      if (t + 1 < ntiles) {          // overlaps the MMA
        expand(buf ^ 1);
        if (t + 2 < ntiles) load(c0 + (long long)(t + 2) * kTcN);
      }
      wgmma_wait_all();
      fence_operands(acc);
      const long long r0 = c0 + (long long)t * kTcN;
      const long long col0 = r0 + 2 * quad;
      const bool ragged = r0 + kTcN > n;
      if constexpr (kSub > 1) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          int32_t lo = INT_MIN, hi = INT_MIN;
          if (ragged)
            chunk_max<kChunks, true>(acc, s * kChunks, col0 + s * BT, n,
                                     lo, hi);
          else
            chunk_max<kChunks, false>(acc, s * kChunks, col0 + s * BT, n,
                                      lo, hi);
          write_rows<W>(lo, hi, quad, pop_lo, pop_hi, q0 + row_lo, nq,
                        b0 + t * kSub + s, nb, out);
        }
      } else {
        if (ragged)
          chunk_max<16, true>(acc, 0, col0, n, run_lo, run_hi);
        else
          chunk_max<16, false>(acc, 0, col0, n, run_lo, run_hi);
        if ((((t + 1) * kTcN) & ((1 << lb) - 1)) == 0 || t == ntiles - 1) {
          write_rows<W>(run_lo, run_hi, quad, pop_lo, pop_hi, q0 + row_lo,
                        nq, b0 + ((t * kTcN) >> lb), nb, out);
          run_lo = run_hi = INT_MIN;
        }
      }
      fence_async_smem();
      __syncthreads();
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int W, int BT>
cudaError_t launch_tc(const void* queries, const void* db, void* out,
                      int n_queries, long long n, long long nb,
                      long long block, cudaStream_t stream) {
  auto kernel = blockmin_tc_kernel<W, BT>;
  const size_t smem = 2 * (size_t)kTcN * 32 * W;
  cudaError_t err;
  if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int qtiles = (n_queries + kTcQ - 1) / kTcQ;
  const long long items =
      (long long)qtiles * ((nb * block + kTcChunk - 1) / kTcChunk);
  const long long fit = (long long)sms * per_sm;
  const long long grid = items < fit ? items : fit;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(db),
      static_cast<int32_t*>(out), n_queries, n, nb, __builtin_ctzll(block),
      qtiles, items);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_tc_w(const void* queries, const void* db, void* out,
                        int n_queries, long long n, long long nb,
                        long long block, cudaStream_t stream) {
  if (block == 32)
    return launch_tc<W, 32>(queries, db, out, n_queries, n, nb, block, stream);
  if (block == 64)
    return launch_tc<W, 64>(queries, db, out, n_queries, n, nb, block, stream);
  return launch_tc<W, 128>(queries, db, out, n_queries, n, nb, block, stream);
}

cudaError_t launch_tensor(const void* queries, const void* db, void* out,
                          int n_queries, long long n, long long nb, int w,
                          long long block, cudaStream_t s) {
  switch (w) {
    case 1: return launch_tc_w<1>(queries, db, out, n_queries, n, nb, block, s);
    case 2: return launch_tc_w<2>(queries, db, out, n_queries, n, nb, block, s);
    case 3: return launch_tc_w<3>(queries, db, out, n_queries, n, nb, block, s);
    case 4: return launch_tc_w<4>(queries, db, out, n_queries, n, nb, block, s);
    case 5: return launch_tc_w<5>(queries, db, out, n_queries, n, nb, block, s);
    case 6: return launch_tc_w<6>(queries, db, out, n_queries, n, nb, block, s);
    case 7: return launch_tc_w<7>(queries, db, out, n_queries, n, nb, block, s);
    default:
      return launch_tc_w<8>(queries, db, out, n_queries, n, nb, block, s);
  }
}

// Whether the tensor-core instance takes (W, block).
bool tc_fits(int w, long long block) {
  return w >= 1 && w <= kTcMaxWords && block >= 32 && block <= kTcMaxBlock &&
         (block & (block - 1)) == 0;
}

// ------------------------------------------------------------- generic path

// queries per thread block of the generic instance (kSlots per warp)
constexpr int kGQTile = 64;
constexpr int kSlots = kGQTile / kWarps;

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

}  // namespace

// Plain C entry for ctypes. queries int32[n_queries, w], db int32[n_rows, w]
// (n <= n_rows valid rows), out int32[n_queries, ceil(n_rows / block)]; all
// contiguous on the current device. `tensor` = 1 runs the tensor-core
// instance (cudaErrorInvalidValue for a shape it does not take), 0 the
// generic one. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = success).
//
// The grids: the tensor-core instance launches at most as many CTAs as fit
// the card, each walking (128-query tile, 2048-row chunk) items; the wide
// generic instance nb x ceil(Q/64) thread blocks and the narrow one
// ceil(nb / (threads / g)) x ceil(Q/64). nb must stay under 2^31 for the
// wide one: at block 32 that is 68.7G rows; the narrow one takes block 1
// at any n under 2^31 * 8.
extern "C" int vt_blockmin(const void* queries, const void* db, void* out,
                           int n_queries, long long n, long long n_rows,
                           int w, long long block, int tensor,
                           void* stream) {
  if (w <= 0 || block <= 0 || (tensor && !tc_fits(w, block)))
    return (int)cudaErrorInvalidValue;
  const long long nb = (n_rows + block - 1) / block;
  if (n_queries <= 0 || nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor)
    return (int)launch_tensor(queries, db, out, n_queries, n, nb, w, block,
                              s);
  if ((block >= 32 && nb > 0x7fffffffLL) ||
      (n_queries + kGQTile - 1) / kGQTile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return (int)launch_generic(queries, db, out, n_queries, n, nb, w, block, s);
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
