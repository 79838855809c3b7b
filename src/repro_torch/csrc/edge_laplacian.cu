// edge_laplacian.cu — the ADMM constraint-operator pair for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/edge_laplacian/kernel.py:
//   * edge_laplacian_2d (body _edge_laplacian_kernel): L(g), the Laplacian of
//     the complete candidate graph from the packed edge weights g,
//     m = n(n-1)/2, in all_edges(n) (lexicographic) order;
//   * edge_quadform_2d (body _edge_quadform_kernel): per edge l = {i, j},
//     <dL/dg_l, P> = P_ii + P_jj - P_ij - P_ji.
// and, as a second form of the first, edge_laplacian_blocks: A_op's three
// dense blocks (L - lam*I + S, L + lam*I + T, diag(L) + y) straight from g
// into the flat constraint-space vector. The quadratic form runs on every
// CG matvec of the ADMM X-step (engine._edge_quadform), the blocks form on
// every A_op (engine.A_op), L alone in engine._L_of_g and init_state; in
// float32 (the pipeline default) and float64.
//
// What bounds them on the H100: bytes. Each reads its inputs once and
// writes its output once, with no arithmetic worth counting.
//   edge_laplacian: 4 or 8 bytes x (m + n^2).
//     n = 64:  24.4 KB fp32, 48.9 KB fp64  ->  7 ns / 15 ns at 3.35 TB/s.
//     n = 256: 392.7 KB fp32, 785.4 KB fp64 -> 117 ns / 234 ns.
//   edge_laplacian_blocks: 4 or 8 bytes x (m + 1 + 4n^2 + 2n): g, lam, S,
//     T and y read once, 2n^2 + n outputs written once; 22 ns at n = 64
//     fp32. A_op composed from L and eight torch ops takes nine launches;
//     this form takes one.
//   edge_quadform: 4 or 8 bytes x (n^2 + m): P read once, the form written
//     once, the same figures as edge_laplacian. The endpoints are not part
//     of the bound: on the ADMM path the edge list is the complete
//     lexicographic one, so they follow from l. This kernel still reads them
//     as int64 (16 B per edge, 57 % more bytes at n = 64); deriving them
//     from l, as edge_laplacian does, is left to a later change.
// Those bounds are far below the ~2-4 us a launch costs, so at the paper's
// sizes the launch count, not the kernel body, sets the time. The design
// therefore does each function in ONE launch, with no padding pass, no
// scatter, no atomics and no second kernel:
//   * edge_laplacian: one block per row a; threads stride over the columns
//     b, compute the packed index l = lo*n - lo(lo+1)/2 + (hi-lo-1)
//     analytically (as kernel.py:49-56 does) and gather g[l]. Off-diagonals
//     are written as 0 - g (so they are bit-equal to the plain version's
//     diag(G.1) - G); the row degree is a block reduction written to L[a,a].
//     Every entry of L is written exactly once.
//   * edge_quadform: one thread per edge does the four gathers in the order
//     of kernel.py:83. The ragged tail is masked by the bounds test, not
//     padded. The sum is of adds only, rounded by __fadd_rn/__dadd_rn, so
//     nothing can be contracted and the result is bit-equal to the plain
//     version's ((P_ii + P_jj) - P_ij) - P_ji.
//
// Plain C interface for ctypes: every entry launches on the given stream,
// never synchronises, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Sum over the block; the result is valid in thread 0. blockDim.x must be a
// multiple of 32.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ __align__(8) unsigned char buf[32 * sizeof(double)];
  T* partial = reinterpret_cast<T*>(buf);
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? partial[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void edge_laplacian_kernel(const T* __restrict__ g, T* __restrict__ L, int n) {
  const int a = blockIdx.x;
  T* row = L + static_cast<size_t>(a) * n;
  T deg = T(0);
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (b == a) continue;
    const long long lo = a < b ? a : b;
    const long long hi = a < b ? b : a;
    const long long l = lo * n - lo * (lo + 1) / 2 + (hi - lo - 1);
    const T v = g[l];
    row[b] = sub_rn(T(0), v);
    deg += v;
  }
  deg = block_sum(deg);
  if (threadIdx.x == 0) row[a] = deg;
}

// A_op's dense blocks straight from g, one block per row a, into the flat
// constraint-space output: out[a·n + b] = (L − λI + S)_ab, out[n² + a·n + b]
// = (L + λI + T)_ab, out[2n² + a] = L_aa + y_a. Each entry rounds as the
// plain composition does: L_ab as above, λI_ab = λ·(1 or 0) (so ±0 or NaN
// off the diagonal, as λ·I gives), then one rounded subtract or add at a
// time in the composition's order, and the degree by the same block_sum
// with the same block size, so the output is bit-equal to edge_laplacian
// followed by the torch ops.
template <typename T>
__global__ void edge_laplacian_blocks_kernel(const T* __restrict__ g, const T* __restrict__ lam,
                                             const T* __restrict__ S, const T* __restrict__ Tm,
                                             const T* __restrict__ y, T* __restrict__ out,
                                             int n) {
  const int a = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t row = static_cast<size_t>(a) * n;
  const T lv = *lam;
  const T lam_off = mul_rn(lv, T(0));
  T deg = T(0);
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (b == a) continue;
    const long long lo = a < b ? a : b;
    const long long hi = a < b ? b : a;
    const long long l = lo * n - lo * (lo + 1) / 2 + (hi - lo - 1);
    const T v = g[l];
    const T L = sub_rn(T(0), v);
    out[row + b] = add_rn(sub_rn(L, lam_off), S[row + b]);
    out[nn + row + b] = add_rn(add_rn(L, lam_off), Tm[row + b]);
    deg += v;
  }
  deg = block_sum(deg);
  if (threadIdx.x == 0) {
    const T lam_on = mul_rn(lv, T(1));
    out[row + a] = add_rn(sub_rn(deg, lam_on), S[row + a]);
    out[nn + row + a] = add_rn(add_rn(deg, lam_on), Tm[row + a]);
    out[2 * nn + a] = add_rn(deg, y[a]);
  }
}

template <typename T>
__global__ void edge_quadform_kernel(const T* __restrict__ P, const int64_t* __restrict__ ei,
                                     const int64_t* __restrict__ ej, T* __restrict__ out,
                                     long long m, long long n) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= m) return;
  const long long i = ei[l];
  const long long j = ej[l];
  const T pii = P[i * n + i];
  const T pjj = P[j * n + j];
  const T pij = P[i * n + j];
  const T pji = P[j * n + i];
  out[l] = sub_rn(sub_rn(add_rn(pii, pjj), pij), pji);
}

int laplacian_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

template <typename T>
int launch_edge_laplacian(const void* g, void* L, int n, void* stream) {
  if (n > 0) {
    edge_laplacian_kernel<T><<<n, laplacian_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<T*>(L), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_laplacian_blocks(const void* g, const void* lam, const void* S, const void* Tm,
                                 const void* y, void* out, int n, void* stream) {
  if (n > 0) {
    edge_laplacian_blocks_kernel<T>
        <<<n, laplacian_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(g), static_cast<const T*>(lam), static_cast<const T*>(S),
            static_cast<const T*>(Tm), static_cast<const T*>(y), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_quadform(const void* P, const void* ei, const void* ej, void* out, long long m,
                         int n, void* stream) {
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    edge_quadform_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(P), static_cast<const int64_t*>(ei),
        static_cast<const int64_t*>(ej), static_cast<T*>(out), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int edge_laplacian_f32(const void* g, void* L, int n, void* stream) {
  return launch_edge_laplacian<float>(g, L, n, stream);
}

int edge_laplacian_f64(const void* g, void* L, int n, void* stream) {
  return launch_edge_laplacian<double>(g, L, n, stream);
}

int edge_laplacian_blocks_f32(const void* g, const void* lam, const void* S, const void* Tm,
                              const void* y, void* out, int n, void* stream) {
  return launch_edge_laplacian_blocks<float>(g, lam, S, Tm, y, out, n, stream);
}

int edge_laplacian_blocks_f64(const void* g, const void* lam, const void* S, const void* Tm,
                              const void* y, void* out, int n, void* stream) {
  return launch_edge_laplacian_blocks<double>(g, lam, S, Tm, y, out, n, stream);
}

int edge_quadform_f32(const void* P, const void* ei, const void* ej, void* out, long long m,
                      int n, void* stream) {
  return launch_edge_quadform<float>(P, ei, ej, out, m, n, stream);
}

int edge_quadform_f64(const void* P, const void* ei, const void* ej, void* out, long long m,
                      int n, void* stream) {
  return launch_edge_quadform<double>(P, ei, ej, out, m, n, stream);
}

}  // extern "C"
