// ssd_scan.cu — the Mamba-2 SSD intra-chunk dual form, for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_intra_chunk_kernel (body _ssd_intra_kernel) of
// src/repro/kernels/ssd_scan/kernel.py. For every (batch, chunk) and head h,
// with chunk length Q, state N and head dim P:
//   G    = C · Bᵀ                                  (Q×Q; one B/C group, so
//                                                    the same for every head)
//   M    = causal(G ⊙ exp(la_t − la_s) ⊙ dt_s)      (s ≤ t, else 0)
//   y    = M · x                                   (Q×P)  → y_intra, float32
//   st   = (B ⊙ exp(la_{Q−1} − la) ⊙ dt)ᵀ · x       (P×N)  → chunk state, float32
// x (B, nc, Q, H, P) and B, C (B, nc, Q, N) of one dtype (float32, bfloat16
// or float16); dt, la (B, nc, Q, H) float32. Dimensions 0, 1 and 2 of
// every input are taken through their strides (a chunk's slice of a column
// slice of the conv output, as the model holds x, B and C); the rest must be
// contiguous. All arithmetic is float32 FMA on the CUDA
// cores, as the TPU kernel's float32 dots; no TF32.
//
// What bounds it on the H100: operations. At mamba2-780m's prefill shape
// (B 8, one chunk of Q 256, H 48, P 64, N 128, bf16 x) one call reads about
// 14 MB and writes 38 MB (16 µs at 3.35 TB/s) but does about 3.3 GFLOP of
// float32 work once G is shared across heads and the causal half skipped
// (49 µs at 67 TFLOP/s).
//
// Design. Blocks run in no order on 132 SMs, with at most 227 KB of shared
// memory each, so the TPU's one (batch·chunk, head) grid cell with a whole
// Q×Q block becomes two kinds of block in one launch:
// - y blocks, one per (batch·chunk, tile of TT rows t, group of HG heads):
//   G for the tile's rows and the columns s < t0+TT (the causal half only) is
//   computed once into shared memory, N in slices staged through the space
//   the head loop uses later; then, for each head, the tile's M rows are
//   built in shared memory from G, la and dt, and y = M·x is taken in 4×4
//   register tiles. At Q 256 the Q×Q float32 G alone would be 256 KB; a
//   64-row tile keeps G, M and x in 194 KB. G is shared by the HG heads.
// - state blocks, one per (batch·chunk, group of HS heads): for each head,
//   the weighted B ⊙ w (w = exp(la_{Q−1} − la)·dt) and x are staged in
//   slices of s and st is accumulated in 4×4 register tiles.
// Shared-memory reads are 16-byte (float4) and conflict-free along the
// register tiles' fast axis. A simple kernel: wgmma (which has no float32
// form; TF32 would lose digits) and TMA are for later work.
//
// Plain C interface for ctypes: launches on the given stream, never
// synchronises, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 4;        // register tiles of the state a thread keeps at once
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a Hopper block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

struct Dims {
  int nc, Q, H, P, N;
  long long x_s0, x_s1, x_s2, dt_s0, dt_s1, dt_s2, la_s0, la_s1, la_s2;
  long long b_s0, b_s1, b_s2, c_s0, c_s1, c_s2;
  int TT, HG, HS, n_tiles, n_hg, SK, NK;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <typename T>
__device__ void y_block(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ la, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, float* __restrict__ y, const Dims& d,
                        int bc, int role, float* smem) {
  const int tile = role / d.n_hg, hg = role % d.n_hg;
  const int TT = d.TT, Q = d.Q, P = d.P, N = d.N, H = d.H;
  const int SP = round4(Q), P4 = round4(P);
  const int t0 = tile * TT, tn = min(TT, Q - t0);
  const int S = t0 + tn;                 // columns s < S are needed
  const int S4 = round4(S);
  const int b = bc / d.nc, c = bc % d.nc;
  const T* xb = x + b * d.x_s0 + c * d.x_s1;
  const float* dtb = dt + b * d.dt_s0 + c * d.dt_s1;
  const float* lab = la + b * d.la_s0 + c * d.la_s1;
  const T* Bb = Bm + b * d.b_s0 + c * d.b_s1;
  const T* Cb = Cm + b * d.c_s0 + c * d.c_s1;

  float* Gs = smem;                      // [TT][SP]
  float* Ms = Gs + TT * SP;              // [TT][SP]
  float* Xs = Ms + TT * SP;              // [SP][P4]
  float* las = Xs + SP * P4;             // [SP]
  float* dts = las + SP;                 // [SP]
  float* Cst = Ms;                       // staging while G is built: [NK][TT]
  float* Bst = Ms + d.NK * TT;           //                           [NK][SP]

  // G = C·Bᵀ over the tile's rows and the causal columns, N in slices of NK
  const int n_rt = TT / 4, n_ct = S4 / 4;
  for (int n0 = 0; n0 < N; n0 += d.NK) {
    const int nk = min(d.NK, N - n0);
    for (int i = threadIdx.x; i < nk * TT; i += THREADS) {
      const int j = i / TT, t = i % TT;
      Cst[j * TT + t] = t < tn ? to_f(Cb[(t0 + t) * d.c_s2 + n0 + j]) : 0.f;
    }
    for (int i = threadIdx.x; i < nk * S4; i += THREADS) {
      const int j = i / S4, s = i % S4;
      Bst[j * SP + s] = s < S ? to_f(Bb[s * d.b_s2 + n0 + j]) : 0.f;
    }
    __syncthreads();
    for (int mt = threadIdx.x; mt < n_rt * n_ct; mt += THREADS) {
      const int ti = mt / n_ct, ci = mt % n_ct;
      if (4 * ci > t0 + 4 * ti + 3) continue;          // wholly above the diagonal
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 g = n0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : ld4(Gs + (4 * ti + i) * SP + 4 * ci);
        acc[i][0] = g.x; acc[i][1] = g.y; acc[i][2] = g.z; acc[i][3] = g.w;
      }
      for (int j = 0; j < nk; ++j) {
        const float4 cv = ld4(Cst + j * TT + 4 * ti);
        const float4 bv = ld4(Bst + j * SP + 4 * ci);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(cr[i], br[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(Gs + (4 * ti + i) * SP + 4 * ci) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
  }

  const int h_end = min(H, (hg + 1) * d.HG);
  const int n_pt = P4 / 4;
  for (int h = hg * d.HG; h < h_end; ++h) {
    for (int s = threadIdx.x; s < S4; s += THREADS) {
      las[s] = s < S ? lab[s * d.la_s2 + h] : 0.f;
      dts[s] = s < S ? dtb[s * d.dt_s2 + h] : 0.f;
    }
    for (int i = threadIdx.x; i < S4 * P4; i += THREADS) {
      const int s = i / P4, p = i % P4;
      Xs[s * P4 + p] = (s < S && p < P) ? to_f(xb[s * d.x_s2 + h * P + p]) : 0.f;
    }
    __syncthreads();
    // M rows of the tile: G ⊙ exp(la_t − la_s) ⊙ dt_s for s ≤ t, else 0
    for (int i = threadIdx.x; i < TT * S4; i += THREADS) {
      const int t = i / S4, s = i % S4;
      float mv = 0.f;
      if (t < tn && s <= t0 + t) mv = Gs[t * SP + s] * expf(las[t0 + t] - las[s]) * dts[s];
      Ms[t * SP + s] = mv;
    }
    __syncthreads();
    // y = M·x in 4×4 register tiles; s stops at the tile rows' last t
    for (int mt = threadIdx.x; mt < n_rt * n_pt; mt += THREADS) {
      const int ti = mt / n_pt, pi = mt % n_pt;
      if (4 * ti >= tn) continue;
      const int s_hi = min(S4, round4(t0 + 4 * ti + 4));
      float acc[4][4] = {};
      for (int s = 0; s < s_hi; s += 4) {
        float mr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 mv = ld4(Ms + (4 * ti + i) * SP + s);
          mr[i][0] = mv.x; mr[i][1] = mv.y; mr[i][2] = mv.z; mr[i][3] = mv.w;
        }
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) {
          const float4 xv = ld4(Xs + (s + ss) * P4 + 4 * pi);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(mr[i][ss], xr[jj], acc[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ti + i;
        if (t >= tn) continue;
        float* yr = y + ((static_cast<long long>(bc) * Q + t0 + t) * H + h) * P;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (4 * pi + jj < P) yr[4 * pi + jj] = acc[i][jj];
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void state_block(const T* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ la, const T* __restrict__ Bm,
                            float* __restrict__ st, const Dims& d, int bc, int role,
                            float* smem) {
  const int Q = d.Q, P = d.P, N = d.N, H = d.H, SK = d.SK;
  const int P4 = round4(P), N4 = round4(N);
  const int b = bc / d.nc, c = bc % d.nc;
  const T* xb = x + b * d.x_s0 + c * d.x_s1;
  const float* dtb = dt + b * d.dt_s0 + c * d.dt_s1;
  const float* lab = la + b * d.la_s0 + c * d.la_s1;
  const T* Bb = Bm + b * d.b_s0 + c * d.b_s1;

  float* Xs = smem;                      // [SK][P4]
  float* Bw = Xs + SK * P4;              // [SK][N4]
  float* ws = Bw + SK * N4;              // [SK]
  const int n_pt = P4 / 4, n_nt = N4 / 4, n_mt = n_pt * n_nt;
  const int h_end = min(H, (role + 1) * d.HS);
  for (int h = role * d.HS; h < h_end; ++h) {
    const float la_last = lab[(Q - 1) * d.la_s2 + h];
    for (int r0 = 0; r0 < n_mt; r0 += THREADS * RMAX) {
      float acc[RMAX][4][4] = {};
      for (int s0 = 0; s0 < Q; s0 += SK) {
        const int sk = min(SK, Q - s0);
        for (int s = threadIdx.x; s < sk; s += THREADS) {
          ws[s] = expf(la_last - lab[(s0 + s) * d.la_s2 + h]) * dtb[(s0 + s) * d.dt_s2 + h];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < sk * P4; i += THREADS) {
          const int s = i / P4, p = i % P4;
          Xs[s * P4 + p] = p < P ? to_f(xb[(s0 + s) * d.x_s2 + h * P + p]) : 0.f;
        }
        for (int i = threadIdx.x; i < sk * N4; i += THREADS) {
          const int s = i / N4, n = i % N4;
          Bw[s * N4 + n] = n < N ? to_f(Bb[(s0 + s) * d.b_s2 + n]) * ws[s] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const int mt = r0 + r * THREADS + threadIdx.x;
          if (mt >= n_mt) continue;
          const int pi = mt / n_nt, ni = mt % n_nt;
          for (int s = 0; s < sk; ++s) {
            const float4 xv = ld4(Xs + s * P4 + 4 * pi);
            const float4 bv = ld4(Bw + s * N4 + 4 * ni);
            const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[r][i][jj] = fmaf(xr[i], br[jj], acc[r][i][jj]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const int mt = r0 + r * THREADS + threadIdx.x;
        if (mt >= n_mt) continue;
        const int pi = mt / n_nt, ni = mt % n_nt;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * pi + i;
          if (p >= P) continue;
          float* sr = st + ((static_cast<long long>(bc) * H + h) * P + p) * N;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * ni + jj < N) sr[4 * ni + jj] = acc[r][i][jj];
        }
      }
    }
  }
}

// Grid (B·nc, n_tiles·n_hg + n_hs): y blocks first along y, state blocks after.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ la, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int bc = blockIdx.x, role = blockIdx.y;
  const int n_y = d.n_tiles * d.n_hg;
  if (role < n_y) {
    y_block<T>(x, dt, la, Bm, Cm, y, d, bc, role, smem);
  } else {
    state_block<T>(x, dt, la, Bm, st, d, bc, role - n_y, smem);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* la, const void* Bm, const void* Cm,
           void* y, void* st, int BC, const Dims& d, int smem_bytes, cudaStream_t s) {
  // raise the dynamic shared-memory limit once, to what any call may ask; a
  // call made later, inside a CUDA graph capture, then sets nothing
  static int allowed = 0;
  if (smem_bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = SMEM_MAX;
  }
  if (smem_bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_hs = (d.H + d.HS - 1) / d.HS;
  const dim3 grid(BC, d.n_tiles * d.n_hg + n_hs);
  ssd_intra_chunk_kernel<T><<<grid, THREADS, smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(la),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), d);
  return 0;
}

}  // namespace

extern "C" {

// dtype (of x, B and C): 0 float32, 1 bfloat16, 2 float16. Strides of
// dimensions 0, 1 and 2 in elements. TT (a multiple of 4), HG, HS, SK and NK are chosen by the caller
// so that both kinds of block fit in smem_bytes.
int ssd_intra_chunk(const void* x, const void* dt, const void* la, const void* Bm,
                    const void* Cm, void* y, void* st, int Bsz, int nc, int Q, int H, int P,
                    int N, long long x_s0, long long x_s1, long long x_s2, long long dt_s0,
                    long long dt_s1, long long dt_s2, long long la_s0, long long la_s1,
                    long long la_s2, long long b_s0, long long b_s1, long long b_s2,
                    long long c_s0, long long c_s1, long long c_s2, int TT, int HG, int HS,
                    int SK, int NK,
                    int smem_bytes, int dtype, void* stream) {
  if (Bsz <= 0 || nc <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (TT <= 0 || TT % 4 || HG <= 0 || HS <= 0 || SK <= 0 || NK <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d{nc,    Q,     H,     P,     N,     x_s0,  x_s1,  x_s2,  dt_s0, dt_s1, dt_s2,
         la_s0, la_s1, la_s2, b_s0,  b_s1,  b_s2,  c_s0,  c_s1,  c_s2,  TT,    HG,
         HS,    (Q + TT - 1) / TT, (H + HG - 1) / HG, SK, NK};
  if (static_cast<long long>(d.n_tiles) * d.n_hg + (H + HS - 1) / HS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BC = Bsz * nc;
  int err;
  if (dtype == 0) {
    err = launch<float>(x, dt, la, Bm, Cm, y, st, BC, d, smem_bytes, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, dt, la, Bm, Cm, y, st, BC, d, smem_bytes, s);
  } else if (dtype == 2) {
    err = launch<__half>(x, dt, la, Bm, Cm, y, st, BC, d, smem_bytes, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
