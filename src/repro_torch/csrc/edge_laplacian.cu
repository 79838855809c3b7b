// edge_laplacian.cu — the ADMM constraint-operator pair for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/edge_laplacian/kernel.py:
//   * edge_laplacian_2d (body _edge_laplacian_kernel): L(g), the Laplacian of
//     the complete candidate graph from the packed edge weights g,
//     m = n(n-1)/2, in all_edges(n) (lexicographic) order;
//   * edge_quadform_2d (body _edge_quadform_kernel): per edge l = {i, j},
//     <dL/dg_l, P> = P_ii + P_jj - P_ij - P_ji.
// Each has a second form on the ADMM path, where the edge list is the
// complete lexicographic one and the endpoints follow from l:
//   * edge_laplacian_blocks: A_op's three dense blocks (L - lam*I + S,
//     L + lam*I + T, diag(L) + y) straight from g into the flat
//     constraint-space vector (engine.A_op: the CG's right-hand side);
//   * edge_adjoint: AT_op's x-part, x = [quadform(P + Q)_l + (w_i + w_j)
//     (+ v_l), -tr P + tr Q], from the flat constraint-space vector's P, Q,
//     w (and v) blocks (engine.AT_op: the CG's last adjoint);
//   * edge_schur_matvec: the CG matvec A·Aᵀλ's three dense blocks, L(xg) -
//     xl*I + P, L(xg) + xl*I + Q, diag L(xg) + w, with (xg, xl) the adjoint
//     above built on the fly (engine.schur_matvec), and the adjoint itself
//     written on request (the heterogeneous rows need it).
// The standalone edge_quadform keeps its any-edge-list form (int64
// endpoints); edge_laplacian runs in engine._L_of_g and init_state. All in
// float32 (the pipeline default) and float64.
//
// Windows. edge_laplacian and edge_adjoint also take one contiguous window
// [first, first + count) of the lexicographic list: one rank's share in the
// edge-partitioned ADMM (core/shard.py). edge_laplacian then writes the
// window's additive contribution to L (the rank all-reduces it), the port
// of src/repro/kernels/edge_laplacian/ref.py:21 (edge_laplacian_window, a
// plain gather: the reference refuses its Pallas pair on a window);
// edge_adjoint writes the window's x entries, then xl at x[count]. The
// complete list is the window first = 0, count = m, and runs exactly the
// operations it ran before windows existed. Their bounds, in bytes:
//   edge_laplacian window: 4 or 8 x (count + n^2);
//   edge_adjoint window: 4 or 8 x (4 count + 3n + count + 1) (+ count for
//     v): P and Q at (i, j) and (j, i) of each edge, both diagonals, w, the
//     output. n = 1,024, two windows, fp32: 5.2 MB and 5.2 MB, ~1.6 us each.
//
// What bounds them on the H100: bytes. Each reads its inputs once and
// writes its output once, with no arithmetic worth counting.
//   edge_laplacian: 4 or 8 bytes x (m + n^2).
//     n = 64:  24.4 KB fp32, 48.9 KB fp64  ->  7 ns / 15 ns at 3.35 TB/s.
//   edge_laplacian_blocks: 4 or 8 bytes x (m + 1 + 4n^2 + 2n); 22 ns at
//     n = 64 fp32.
//   edge_quadform: 4 or 8 bytes x (n^2 + m) (P and the form; the endpoints
//     are not counted), the same figures as edge_laplacian.
//   edge_adjoint: 4 or 8 bytes x (2n^2 + n + m + 1) (+ m for v); 12 ns at
//     n = 64 fp32.
//   edge_schur_matvec: 4 or 8 bytes x (4n^2 + 2n) (+ 2m + 1 for v and the
//     adjoint); 20 ns at n = 64 fp32.
// Those bounds are far below the ~2-4 us a launch costs, so at the paper's
// sizes the launch count, not the kernel body, sets the time. The design
// therefore does each function in ONE launch, with no padding pass, no
// scatter, no atomics and no second kernel. The CG matvec composed from
// the pair and torch ops took 12 launches (AT_op 11, A_op 1); it takes one.
//   * edge_laplacian and the row forms: one block per row a; threads stride
//     over the columns b, compute the packed index l = lo*n - lo(lo+1)/2 +
//     (hi-lo-1) analytically (as kernel.py:49-56 does). Off-diagonals are
//     written as 0 - g (so they are bit-equal to the plain version's
//     diag(G.1) - G); the row degree is a block reduction written to L[a,a].
//     Every entry is written exactly once.
//   * edge_adjoint and edge_schur_matvec read no endpoint array: row a's
//     entry b needs the diagonals of P and Q, row a and column a of P and Q,
//     and w, so each block is independent and no grid-wide sync is needed;
//     xg_ab is computed by both row a and row b, in the same order. Column a
//     is a strided read (n^2 floats of P and Q, 8 MB at n = 1,024 fp32) that
//     stays in the 50 MB L2; staging it through shared memory would add a
//     barrier and buy nothing at these sizes.
//   * xg rounds as the torch composition does, one add at a time with
//     __fadd_rn/__fsub_rn (nothing contracted): ((((R_ii + R_jj) - R_ij) -
//     R_ji) + (w_i + w_j)) (+ v_l), with R = P + Q entrywise and i the lower
//     endpoint, so it is bit-equal to the composition on the card. xl =
//     -tr P + tr Q comes from one fixed-order block reduction of the two
//     diagonals (trace_diff), the same device function and block size in
//     both forms and in every block; it differs from torch.trace's order
//     within 2n*u*(sum|P_ii| + sum|Q_ii|). The L rows and the degree use
//     edge_laplacian_blocks_kernel's block_sum and thread count, so
//     edge_schur_matvec is bit-equal to edge_laplacian_blocks fed
//     edge_adjoint's output.
//   * edge_quadform: one thread per edge does the four gathers in the order
//     of kernel.py:83, bit-equal to the plain version.
//   * Batches: every form but edge_quadform serves B instances of one n
//     (the batched ADMM's restarts or budgets) in one launch. blockIdx.y is
//     the instance, and each operand's pointer advances by its own instance
//     stride, so the lambda blocks can be views of one (B, K) constraint-
//     space matrix (stride K, not n^2). Inside an instance the order of
//     operations is the one above, so instance b of a batched launch is
//     bitwise the unbatched launch on instance b. The bounds above scale
//     by B; at B = 4, n = 64 fp32 they stay below 0.1 us, under a launch.
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
// multiple of 32. It starts with a barrier, so that two calls in a row do not
// race on the partials.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ __align__(8) unsigned char buf[32 * sizeof(double)];
  T* partial = reinterpret_cast<T*>(buf);
  __syncthreads();
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

// L(g) of the packed window [first, first + count) of the edge list: g holds
// the window's weights (g[l - first] is edge l's), every edge outside it
// counts as weight 0 (its entry is written as 0 - 0 = +0). The complete list
// is first = 0, count = m, the same operations as before windows existed.
template <typename T>
__global__ void edge_laplacian_kernel(const T* __restrict__ g, long long gs, T* __restrict__ L,
                                      long long Ls, int n, long long first, long long count) {
  const int a = blockIdx.x;
  const long long inst = blockIdx.y;
  g += inst * gs;
  T* row = L + inst * Ls + static_cast<size_t>(a) * n;
  T deg = T(0);
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (b == a) continue;
    const long long lo = a < b ? a : b;
    const long long hi = a < b ? b : a;
    const long long l = lo * n - lo * (lo + 1) / 2 + (hi - lo - 1) - first;
    const T v = (l >= 0 && l < count) ? g[l] : T(0);
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
__global__ void edge_laplacian_blocks_kernel(const T* __restrict__ g, long long gs,
                                             const T* __restrict__ lam, long long lams,
                                             const T* __restrict__ S, long long Ss,
                                             const T* __restrict__ Tm, long long Ts,
                                             const T* __restrict__ y, long long ys,
                                             T* __restrict__ out, long long outs, int n) {
  const int a = blockIdx.x;
  const long long inst = blockIdx.y;
  g += inst * gs;
  lam += inst * lams;
  S += inst * Ss;
  Tm += inst * Ts;
  y += inst * ys;
  out += inst * outs;
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

// -tr P + tr Q as the torch composition writes it, by one fixed-order
// reduction: each thread sums its strided share of the diagonals, then
// block_sum. Every thread gets the result. The same blockDim gives the same
// bits in every block and in both forms.
template <typename T>
__device__ T trace_diff(const T* __restrict__ P, const T* __restrict__ Q, int n) {
  __shared__ T xl_shared;
  T tp = T(0), tq = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t d = static_cast<size_t>(i) * n + i;
    tp = add_rn(tp, P[d]);
    tq = add_rn(tq, Q[d]);
  }
  tp = block_sum(tp);
  tq = block_sum(tq);
  if (threadIdx.x == 0) xl_shared = add_rn(-tp, tq);
  __syncthreads();
  return xl_shared;
}

// AT_op's edge entry for i < j: quadform(P + Q)_l + (w_i + w_j) (+ v[l]), one
// rounding at a time in the composition's order (l: the edge's slot in v).
template <typename T>
__device__ __forceinline__ T edge_xg(const T* __restrict__ P, const T* __restrict__ Q,
                                     const T* __restrict__ w, const T* __restrict__ v,
                                     int i, int j, long long l, int n) {
  const size_t ii = static_cast<size_t>(i) * n + i, jj = static_cast<size_t>(j) * n + j;
  const size_t ij = static_cast<size_t>(i) * n + j, ji = static_cast<size_t>(j) * n + i;
  const T rii = add_rn(P[ii], Q[ii]);
  const T rjj = add_rn(P[jj], Q[jj]);
  const T rij = add_rn(P[ij], Q[ij]);
  const T rji = add_rn(P[ji], Q[ji]);
  T xg = add_rn(sub_rn(sub_rn(add_rn(rii, rjj), rij), rji), add_rn(w[i], w[j]));
  if (v != nullptr) xg = add_rn(xg, v[l]);
  return xg;
}

__device__ __forceinline__ long long packed_index(long long lo, long long hi, long long n) {
  return lo * n - lo * (lo + 1) / 2 + (hi - lo - 1);
}

// x[l - first] for the edges {a, b}, b > a, of row a (block a) whose packed
// index l lies in the window [first, first + count), and x[count] = xl
// (block 0). v, when given, holds the window's entries (v[l - first]). Row
// a's edges are the contiguous indices packed_index(a, a+1) + (b - a - 1),
// so the window is a range of b; a row outside it writes nothing. The
// complete list is first = 0, count = m: every b in (a, n), as before.
template <typename T>
__global__ void edge_adjoint_kernel(const T* __restrict__ P, long long Ps,
                                    const T* __restrict__ Q, long long Qs,
                                    const T* __restrict__ w, long long ws,
                                    const T* __restrict__ v, long long vs,
                                    T* __restrict__ x, long long xs, int n, long long first,
                                    long long count) {
  const int a = blockIdx.x;
  const long long inst = blockIdx.y;
  P += inst * Ps;
  Q += inst * Qs;
  w += inst * ws;
  if (v != nullptr) v += inst * vs;
  x += inst * xs;
  if (a == 0) {
    const T xl = trace_diff(P, Q, n);
    if (threadIdx.x == 0) x[count] = xl;
  }
  // edge {a, b} has packed index base + b; its slot in the window is
  // base + b - first
  const long long base = packed_index(a, a + 1, n) - (a + 1);
  const long long b_lo = first - base > a + 1 ? first - base : a + 1;
  const long long b_hi = first + count - base < n ? first + count - base : n;
  for (long long b = b_lo + threadIdx.x; b < b_hi; b += blockDim.x) {
    const long long k = base + b - first;
    x[k] = edge_xg(P, Q, w, v, a, static_cast<int>(b), k, n);
  }
}

// A·Aᵀλ's dense blocks, row a per block: edge_laplacian_blocks_kernel with
// g[l] replaced by xg of edge {a, b} and lam by xl, S = P, T = Q, y = w. With
// x non-null the adjoint is written too: each edge by its lower endpoint's
// row, xl by block 0.
template <typename T>
__global__ void edge_schur_matvec_kernel(const T* __restrict__ P, long long Ps,
                                         const T* __restrict__ Q, long long Qs,
                                         const T* __restrict__ w, long long ws,
                                         const T* __restrict__ v, long long vs,
                                         T* __restrict__ out, long long outs,
                                         T* __restrict__ x, long long xs, int n) {
  const int a = blockIdx.x;
  const long long inst = blockIdx.y;
  P += inst * Ps;
  Q += inst * Qs;
  w += inst * ws;
  if (v != nullptr) v += inst * vs;
  out += inst * outs;
  if (x != nullptr) x += inst * xs;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t row = static_cast<size_t>(a) * n;
  const T xl = trace_diff(P, Q, n);
  const T lam_off = mul_rn(xl, T(0));
  T deg = T(0);
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (b == a) continue;
    const int lo = a < b ? a : b;
    const int hi = a < b ? b : a;
    const long long l = packed_index(lo, hi, n);
    const T xg = edge_xg(P, Q, w, v, lo, hi, l, n);
    if (x != nullptr && a < b) x[l] = xg;
    const T L = sub_rn(T(0), xg);
    out[row + b] = add_rn(sub_rn(L, lam_off), P[row + b]);
    out[nn + row + b] = add_rn(add_rn(L, lam_off), Q[row + b]);
    deg += xg;
  }
  deg = block_sum(deg);
  if (threadIdx.x == 0) {
    const T lam_on = mul_rn(xl, T(1));
    out[row + a] = add_rn(sub_rn(deg, lam_on), P[row + a]);
    out[nn + row + a] = add_rn(add_rn(deg, lam_on), Q[row + a]);
    out[2 * nn + a] = add_rn(deg, w[a]);
    if (x != nullptr && a == 0) x[static_cast<long long>(n) * (n - 1) / 2] = xl;
  }
}

int laplacian_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

// The grid of the batched forms: blockIdx.x a row, blockIdx.y an instance.
dim3 row_grid(int n, int batch) { return dim3(static_cast<unsigned>(n), static_cast<unsigned>(batch)); }

template <typename T>
int launch_edge_laplacian(const void* g, long long gs, void* L, long long Ls, int n, int batch,
                          long long first, long long count, void* stream) {
  if (n > 0 && batch > 0) {
    edge_laplacian_kernel<T><<<row_grid(n, batch), laplacian_threads(n), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), gs, static_cast<T*>(L), Ls, n, first, count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_laplacian_blocks(const void* g, long long gs, const void* lam, long long lams,
                                 const void* S, long long Ss, const void* Tm, long long Ts,
                                 const void* y, long long ys, void* out, long long outs, int n,
                                 int batch, void* stream) {
  if (n > 0 && batch > 0) {
    edge_laplacian_blocks_kernel<T>
        <<<row_grid(n, batch), laplacian_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(g), gs, static_cast<const T*>(lam), lams,
            static_cast<const T*>(S), Ss, static_cast<const T*>(Tm), Ts,
            static_cast<const T*>(y), ys, static_cast<T*>(out), outs, n);
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

template <typename T>
int launch_edge_adjoint(const void* P, long long Ps, const void* Q, long long Qs, const void* w,
                        long long ws, const void* v, long long vs, void* x, long long xs, int n,
                        int batch, long long first, long long count, void* stream) {
  if (n > 0 && batch > 0) {
    edge_adjoint_kernel<T><<<row_grid(n, batch), laplacian_threads(n), 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(P), Ps, static_cast<const T*>(Q), Qs, static_cast<const T*>(w), ws,
        static_cast<const T*>(v), vs, static_cast<T*>(x), xs, n, first, count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_schur_matvec(const void* P, long long Ps, const void* Q, long long Qs,
                             const void* w, long long ws, const void* v, long long vs, void* out,
                             long long outs, void* x, long long xs, int n, int batch,
                             void* stream) {
  if (n > 0 && batch > 0) {
    edge_schur_matvec_kernel<T>
        <<<row_grid(n, batch), laplacian_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(P), Ps, static_cast<const T*>(Q), Qs,
            static_cast<const T*>(w), ws, static_cast<const T*>(v), vs, static_cast<T*>(out),
            outs, static_cast<T*>(x), xs, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each batched entry takes every operand's pointer followed by its instance
// stride in elements (instance b of an operand starts at ptr + b * stride),
// then n, the batch count and the stream.
extern "C" {

#define EDGE_ENTRIES(SUFFIX, T)                                                                  \
  int edge_laplacian_##SUFFIX(const void* g, long long gs, void* L, long long Ls, int n,        \
                              int batch, long long first, long long count, void* stream) {      \
    return launch_edge_laplacian<T>(g, gs, L, Ls, n, batch, first, count, stream);              \
  }                                                                                             \
  int edge_laplacian_blocks_##SUFFIX(const void* g, long long gs, const void* lam,              \
                                     long long lams, const void* S, long long Ss,               \
                                     const void* Tm, long long Ts, const void* y, long long ys, \
                                     void* out, long long outs, int n, int batch,               \
                                     void* stream) {                                            \
    return launch_edge_laplacian_blocks<T>(g, gs, lam, lams, S, Ss, Tm, Ts, y, ys, out, outs,  \
                                           n, batch, stream);                                   \
  }                                                                                             \
  int edge_quadform_##SUFFIX(const void* P, const void* ei, const void* ej, void* out,          \
                             long long m, int n, void* stream) {                                \
    return launch_edge_quadform<T>(P, ei, ej, out, m, n, stream);                               \
  }                                                                                             \
  int edge_adjoint_##SUFFIX(const void* P, long long Ps, const void* Q, long long Qs,           \
                            const void* w, long long ws, const void* v, long long vs, void* x,  \
                            long long xs, int n, int batch, long long first, long long count,   \
                            void* stream) {                                                     \
    return launch_edge_adjoint<T>(P, Ps, Q, Qs, w, ws, v, vs, x, xs, n, batch, first, count,   \
                                  stream);                                                      \
  }                                                                                             \
  int edge_schur_matvec_##SUFFIX(const void* P, long long Ps, const void* Q, long long Qs,      \
                                 const void* w, long long ws, const void* v, long long vs,      \
                                 void* out, long long outs, void* x, long long xs, int n,       \
                                 int batch, void* stream) {                                     \
    return launch_edge_schur_matvec<T>(P, Ps, Q, Qs, w, ws, v, vs, out, outs, x, xs, n, batch, \
                                       stream);                                                 \
  }

EDGE_ENTRIES(f32, float)
EDGE_ENTRIES(f64, double)

#undef EDGE_ENTRIES

}  // extern "C"
