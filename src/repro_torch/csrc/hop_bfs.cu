// hop_bfs.cu — one matmul-BFS hop for the simulated-annealing warm start,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hop_bfs/kernel.py:hop_step_2d
// (body _hop_step_kernel): new = reach OR (reach @ adj) on 0/1 matrices,
// plus each row's reach count, fused into one pass. The reference calls it
// per restart under vmap; here the restart axis is explicit:
//   reach, adj: (R, n, n) 0/1 bytes (torch.bool or torch.uint8)
//   new:        (R, n, n) 0/1 bytes, the same type
//   counts:     (R, n) int32, counts[r, a] = number of b with new[r, a, b]
// It runs on every hop of every SA move's ASPL (warmstart._aspl_total).
//
// What bounds it on the H100: bytes 3 R n^2 + 4 R n, operations 2 R n^3 on
// 0/1 bytes, whose peak is the int8 tensor-core rate (1,979 TOP/s):
//   R = 1, n = 64:  12.5 KB -> 3.7 ns;  0.5 MOP -> 0.3 ns  (bytes).
//   R = 4, n = 64:  50.2 KB -> 15 ns;   2.1 MOP -> 1.1 ns  (bytes).
//   R = 4, n = 256: 790.5 KB -> 236 ns; 134 MOP -> 68 ns   (bytes).
// This kernel multiplies in fp32 on the CUDA cores (67 TFLOP/s), which puts
// its own floor at 2.0 us for R = 4, n = 256; int8 mma is the way to the
// bound there. At n = 64 the launch (~2-4 us) dwarfs both, so the design
// keeps the hop in ONE launch with no second pass for the counts: one block per
// (restart, band of 16 rows) computes the band of reach @ adj as a
// shared-memory tiled fp32 product (0/1 operands, sums <= n < 2^24, so
// exact), ORs it with the incoming band, thresholds, writes new, and sums
// each row's count across all column tiles inside the block (shared-memory
// integer atomics, which are order-free and so exact). Every output byte and
// every count is written exactly once; nothing is padded, the ragged edge
// is masked.
//
// Plain C interface for ctypes: the entry launches on the given stream,
// never synchronises, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                 // reach rows per block
constexpr int BN = 64;                 // output columns per tile
constexpr int BK = 64;                 // product depth per shared tile
constexpr int THREADS = 256;           // BN columns x 4 row groups
constexpr int GROUPS = THREADS / BN;   // 4
constexpr int RPT = BM / GROUPS;       // rows per thread: 4

__global__ void __launch_bounds__(THREADS)
hop_step_kernel(const uint8_t* __restrict__ reach, const uint8_t* __restrict__ adj,
                uint8_t* __restrict__ out, int32_t* __restrict__ counts, int n) {
  __shared__ float sR[BM][BK];
  __shared__ float sA[BK][BN + 1];
  __shared__ int sCnt[BM];

  const size_t nn = static_cast<size_t>(n) * n;
  const uint8_t* R = reach + blockIdx.y * nn;
  const uint8_t* A = adj + blockIdx.y * nn;
  uint8_t* O = out + blockIdx.y * nn;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;

  if (threadIdx.x < BM) sCnt[threadIdx.x] = 0;
  __syncthreads();

  int cnt[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) cnt[q] = 0;

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
    for (int k0 = 0; k0 < n; k0 += BK) {
      for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
        const int i = idx / BK, k = idx % BK;
        const int gi = row0 + i, gk = k0 + k;
        sR[i][k] = (gi < n && gk < n) ? static_cast<float>(R[static_cast<size_t>(gi) * n + gk] != 0)
                                      : 0.f;
      }
      for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
        const int k = idx / BN, j = idx % BN;
        const int gk = k0 + k, gj = col0 + j;
        sA[k][j] = (gk < n && gj < n) ? static_cast<float>(A[static_cast<size_t>(gk) * n + gj] != 0)
                                      : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float a = sA[k][tx];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] += sR[ty + q * GROUPS][k] * a;
      }
      __syncthreads();
    }
    const int gj = col0 + tx;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int gi = row0 + ty + q * GROUPS;
      if (gi < n && gj < n) {
        const size_t at = static_cast<size_t>(gi) * n + gj;
        const uint8_t v = (acc[q] > 0.f || R[at] != 0) ? 1 : 0;
        O[at] = v;
        cnt[q] += v;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (cnt[q] != 0) atomicAdd(&sCnt[ty + q * GROUPS], cnt[q]);
  }
  __syncthreads();
  if (threadIdx.x < BM && row0 + threadIdx.x < n) {
    counts[static_cast<size_t>(blockIdx.y) * n + row0 + threadIdx.x] = sCnt[threadIdx.x];
  }
}

}  // namespace

extern "C" {

int hop_step_u8(const void* reach, const void* adj, void* out, void* counts, int batch, int n,
                void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + BM - 1) / BM, batch);
    hop_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reach), static_cast<const uint8_t*>(adj),
        static_cast<uint8_t*>(out), static_cast<int32_t*>(counts), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
