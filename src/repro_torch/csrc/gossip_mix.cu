// gossip_mix.cu — Eq. 1 neighbour mixing of DSGD gossip, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/gossip_mix/kernel.py:
//   gossip_mix_batched_2d (_gossip_mix_batched_kernel): all n workers of one
//     stacked parameter leaf at once,
//       out[i] = w[i,0]·x[i] + Σ_d w[i,d+1]·x[nbr[i,d]]
//     x (n, M) contiguous, nbr (n, deg) int32, w (n, deg+1) fp32;
//   gossip_mix_2d (_gossip_mix_kernel): one worker,
//       out = w[0]·x + Σ_d w[d+1]·nbrs[d]
//     x (M,), nbrs (deg, M), w (deg+1,).
// Accumulation is fp32 in the TPU kernel's order: the self term first, then
// slots 0…deg−1, each product rounded and then added (__fmul_rn/__fadd_rn, no
// FMA contraction), and the sum is rounded once to x's dtype (fp32, bf16 or
// fp16). The batched kernel runs on every gossip of every DSGD train step,
// once per parameter leaf; the one-worker kernel under the row-loop oracle.
//
// What bounds it on the H100: bytes. It does (2·deg+1) flops per element
// against 2·size bytes at least, far under the card's ~20 flop/byte fp32
// balance. For the batched kernel the least traffic is x read once and the
// output written once, 2·n·M·size bytes: smollm-135m at n = 8 in bf16 is
// 4.30 GB per step, 1.28 ms at 3.35 TB/s. The one-worker kernel reads its
// neighbours from a separate (deg, M) buffer: (deg+2)·M·size bytes.
//
// Design. The TPU wrapper first materialises an (n, deg, R, 1024) gather of
// the neighbour tiles, (deg+1)× the bytes of x. Here each block reads its
// neighbours' rows through nbr_idx itself. The grid is (n, column blocks)
// with the worker on the fastest axis, so the blocks of all n workers over
// one column range are scheduled together: each x tile comes from device
// memory about once and the other deg reads of it hit the 50 MB L2. Loads
// and stores are 16 bytes per thread (8 bf16 or 4 fp32) where every row
// starts 16-byte aligned, else one element per thread; a scalar tail
// covers M mod 8 (or 4). Loops over columns are grid-stride, so M is not
// bounded by the grid (the 28 M-element embedding leaf fits). The block
// keeps its deg+1 weights and row pointers in shared memory. A simple kernel:
// TMA and warp specialisation are later work.
//
// Plain C interface for ctypes: each entry launches on the given stream,
// never synchronises, and returns cudaGetLastError(). A neighbour index
// outside [0, n) traps, which surfaces at the next synchronise.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_COL_BLOCKS = 65535;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// acc[k] (+)= w · row[k] for VEC consecutive elements starting at row.
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void accumulate(float (&acc)[VEC], const T* row, float w) {
  alignas(16) T v[VEC];
  if constexpr (VEC == 1) {
    v[0] = row[0];
  } else {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(row));
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float p = __fmul_rn(to_f(v[k]), w);
    if constexpr (FIRST) {
      acc[k] = p;
    } else {
      acc[k] = __fadd_rn(acc[k], p);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* dst, const float (&acc)[VEC]) {
  alignas(16) T v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = from_f<T>(acc[k]);
  if constexpr (VEC == 1) {
    dst[0] = v[0];
  } else {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// Mix rows[0] (self) and rows[1..deg] (neighbours) into out over the columns
// this block owns: vector units first (grid-stride over `blocks` column
// blocks), then the scalar tail, taken by column block 0.
template <typename T, int VEC>
__device__ __forceinline__ void mix_rows(const T* const* rows, const float* w, T* out,
                                         long long M, int deg, long long block,
                                         long long blocks) {
  const long long nvec = M / VEC;
  for (long long u = block * THREADS + threadIdx.x; u < nvec; u += blocks * THREADS) {
    const long long at = u * VEC;
    float acc[VEC];
    accumulate<T, VEC, true>(acc, rows[0] + at, w[0]);
    for (int d = 0; d < deg; ++d) accumulate<T, VEC, false>(acc, rows[d + 1] + at, w[d + 1]);
    store<T, VEC>(out + at, acc);
  }
  if (block == 0) {
    for (long long at = nvec * VEC + threadIdx.x; at < M; at += THREADS) {
      float acc[1];
      accumulate<T, 1, true>(acc, rows[0] + at, w[0]);
      for (int d = 0; d < deg; ++d) accumulate<T, 1, false>(acc, rows[d + 1] + at, w[d + 1]);
      store<T, 1>(out + at, acc);
    }
  }
}

// Shared memory: deg+1 row pointers, then deg+1 weights.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gossip_mix_batched_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                          const float* __restrict__ w, T* __restrict__ out, int n,
                          long long M, int deg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T** rows = reinterpret_cast<const T**>(smem);
  float* sw = reinterpret_cast<float*>(rows + deg + 1);
  const int i = blockIdx.x;
  for (int d = threadIdx.x; d <= deg; d += THREADS) {
    int j = i;
    if (d > 0) {
      j = nbr[static_cast<long long>(i) * deg + d - 1];
      if (j < 0 || j >= n) __trap();
    }
    rows[d] = x + static_cast<long long>(j) * M;
    sw[d] = w[static_cast<long long>(i) * (deg + 1) + d];
  }
  __syncthreads();
  mix_rows<T, VEC>(rows, sw, out + static_cast<long long>(i) * M, M, deg, blockIdx.y,
                   gridDim.y);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gossip_mix_kernel(const T* __restrict__ x, const T* __restrict__ nbrs,
                  const float* __restrict__ w, T* __restrict__ out, long long M, int deg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T** rows = reinterpret_cast<const T**>(smem);
  float* sw = reinterpret_cast<float*>(rows + deg + 1);
  for (int d = threadIdx.x; d <= deg; d += THREADS) {
    rows[d] = d == 0 ? x : nbrs + static_cast<long long>(d - 1) * M;
    sw[d] = w[d];
  }
  __syncthreads();
  mix_rows<T, VEC>(rows, sw, out, M, deg, blockIdx.x, gridDim.x);
}

long long column_blocks(long long M, int vec) {
  const long long units = M / vec;
  long long b = (units + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return b < MAX_COL_BLOCKS ? b : MAX_COL_BLOCKS;
}

size_t smem_bytes(int deg) {
  return static_cast<size_t>(deg + 1) * (sizeof(void*) + sizeof(float));
}

template <typename T>
void launch_batched(const void* x, const void* nbr, const void* w, void* out, int n,
                    long long M, int deg, int vector, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const size_t sm = smem_bytes(deg);
  if (vector) {
    const dim3 grid(n, static_cast<unsigned>(column_blocks(M, V)));
    gossip_mix_batched_kernel<T, V><<<grid, THREADS, sm, s>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(w), static_cast<T*>(out), n, M, deg);
  } else {
    const dim3 grid(n, static_cast<unsigned>(column_blocks(M, 1)));
    gossip_mix_batched_kernel<T, 1><<<grid, THREADS, sm, s>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(w), static_cast<T*>(out), n, M, deg);
  }
}

template <typename T>
void launch_single(const void* x, const void* nbrs, const void* w, void* out, long long M,
                   int deg, int vector, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const size_t sm = smem_bytes(deg);
  if (vector) {
    gossip_mix_kernel<T, V><<<static_cast<unsigned>(column_blocks(M, V)), THREADS, sm, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(nbrs), static_cast<const float*>(w),
        static_cast<T*>(out), M, deg);
  } else {
    gossip_mix_kernel<T, 1><<<static_cast<unsigned>(column_blocks(M, 1)), THREADS, sm, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(nbrs), static_cast<const float*>(w),
        static_cast<T*>(out), M, deg);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. vector: 1 when x, out (and nbrs)
// start 16-byte aligned and every row does too (M·size a multiple of 16).
int gossip_mix_batched(const void* x, const void* nbr_idx, const void* w, void* out, int n,
                       long long M, int deg, int dtype, int vector, void* stream) {
  if (n > 0 && M > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) launch_batched<float>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else if (dtype == 1) launch_batched<__nv_bfloat16>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else if (dtype == 2) launch_batched<__half>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int gossip_mix_single(const void* x, const void* nbrs, const void* w, void* out, long long M,
                      int deg, int dtype, int vector, void* stream) {
  if (M > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) launch_single<float>(x, nbrs, w, out, M, deg, vector, s);
    else if (dtype == 1) launch_single<__nv_bfloat16>(x, nbrs, w, out, M, deg, vector, s);
    else if (dtype == 2) launch_single<__half>(x, nbrs, w, out, M, deg, vector, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
