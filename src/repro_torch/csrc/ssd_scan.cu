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
// every input are taken through their strides (the chunks of a column
// slice of the conv output, as the model holds x, B and C); the rest must
// be contiguous. One launch covers every chunk of the call (the model
// hands a layer's chunks over at once).
//
// Two routes, picked by the dtype of x, B and C (kernels/ssd_scan/ops.py
// kernel_plan names it):
//
// bfloat16: tensor cores (ssd_intra_chunk_tc). What bounds it on the H100
// is bytes. At mamba2-780m's prefill shape (B 8, one chunk of Q 256, H 48,
// P 64, N 128) a chunk reads 14.4 MB (x, dt, la, B, C once) and writes
// 25.2 MB of float32 y and 12.6 MB of float32 states: 15.6 µs at
// 3.35 TB/s. Its tensor-core work — G's causal half once, y and the states
// three times each (below) — is 9.75 GFLOP: 9.9 µs at the 989 TFLOP/s bf16
// dense rate. (The CUDA-core design's yardstick was 3.36 GFLOP of float32
// FMA, 50.1 µs at 67 TFLOP/s.)
//   G = C·Bᵀ is exact on bf16 mma.sync.m16n8k16 with float32 accumulation
//   (bf16 × bf16 products are exact in float32). M is formed in registers
//   from G's accumulator fragment — the decay, dt and the causal mask
//   applied element by element — and fed straight back as the A operand of
//   y = M·x, FlashAttention-2's S→P register reuse; M never goes to shared
//   memory (G does, shared by the warps of a head pair, below). M is
//   float32, so it is split into THREE bf16 terms, hi = rn(M),
//   mid = rn(M − hi), lo = rn(M − hi − mid), each difference
//   exact; the three add back to M exactly (8 + 8 + 8 significant bits
//   cover float32's 24), so every product M·x is exact and y keeps float32
//   accuracy. Two terms would leave up to 2⁻¹⁶ of each product, about 2/3
//   of the (N + Q + 8)·2⁻²⁴ bound before any summation error, so in the
//   worst case two no longer fit; three do. The states take the same
//   split of w ⊙ x (w = exp(la_{Q−1} − la)·dt, one float32 rounding) as
//   the A operand, against B exact, both through ldmatrix.trans.
//   Blocks of 256 threads (8 warps, two a scheduler; ≤ 128 registers so
//   two blocks fit an SM), two kinds in one launch:
//   - y blocks, one per (batch·chunk, tile of 64 rows t, pair of heads,
//     64 columns of P). Warp w owns rows 16(w mod 4) of the tile for head
//     w/4. For each 64-column s tile up to the diagonal, the warps take G
//     once for both heads — warp w the columns 32(w/4) to 32(w/4)+31 of its
//     rows — and exchange it through shared memory in the accumulator's own
//     layout (one float4 a lane and n-tile, no bank conflicts). Below the
//     diagonal tile the decay factors as exp(la_t − la_r)·exp(la_r − la_s)
//     with r the s tile's last row (both ≤ 1): two exps a row and one a
//     column instead of one an element; the diagonal tile takes exp(la_t −
//     la_s) directly and the warps stop at their own last row. C's tile
//     stays in shared memory; B's and x's s tiles come in by cp.async, two
//     stages.
//   - state blocks, one per (batch·chunk, pair of heads, 128 columns of N):
//     B's s tiles serve both heads; warp w owns head w/4 and rows 16(w mod
//     4) of P (looping past 64), all 128 columns, over every s tile.
//   Shared-memory rows are padded to an odd number of 16-byte units, so
//   ldmatrix is free of bank conflicts. Products that follow each other go
//   to different accumulators. State blocks come first in the grid, then y
//   tiles from the last rows down (the heavy blocks first).
//   What holds it back (probes on the H100, PERF.md §6): every row tile
//   re-reads x and B, ~100 MB from L2 a call at the main shape, and the
//   tiles arrive at ~1.5–2 TB/s. Timestamped, a block waits ~6.5 µs for its
//   first tiles and ~1.7 µs between s tiles against ~4.2 µs of arithmetic a
//   step (two blocks an SM). Holding a chunk's B, C and x in shared memory
//   (one block an SM) or 128-row tiles (one block of 16 warps) read less
//   and were slower: the barriers of one block leave the SM idle.
//
// float32 and float16: CUDA cores (ssd_intra_chunk), the design below,
// in float32 FMA as the TPU kernel's float32 dots; no TF32.
//   Blocks run in no order on 132 SMs, with at most 227 KB of shared
//   memory each, so the TPU's one (batch·chunk, head) grid cell with a
//   whole Q×Q block becomes two kinds of block in one launch:
//   - y blocks, one per (batch·chunk, tile of TT rows t, group of HG heads):
//     G for the tile's rows and the columns s < t0+TT (the causal half only)
//     is computed once into shared memory, N in slices staged through the
//     space the head loop uses later; then, for each head, the tile's M rows
//     are built in shared memory from G, la and dt, and y = M·x is taken in
//     4×4 register tiles. At Q 256 the Q×Q float32 G alone would be 256 KB;
//     a 64-row tile keeps G, M and x in 194 KB. G is shared by the HG heads.
//   - state blocks, one per (batch·chunk, group of HS heads): for each head,
//     the weighted B ⊙ w (w = exp(la_{Q−1} − la)·dt) and x are staged in
//     slices of s and st is accumulated in 4×4 register tiles.
//   Shared-memory reads are 16-byte (float4) and conflict-free along the
//   register tiles' fast axis.
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


// ---------------------------------------------------------------------------
// The bfloat16 route: mma.sync.m16n8k16 bf16 → float32, three-term split
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;      // 8 warps
constexpr int TC_TILE = 64;          // rows t of a y block, and the s tile
constexpr int TC_HG = 2;             // heads of a y block (G shared)
constexpr int TC_PC = 64;            // columns of P a y block takes
constexpr int TC_NC = 128;           // columns of N a state block takes

struct TcDims {
  int nc, Q, H, P, N;
  long long x_s0, x_s1, x_s2, dt_s0, dt_s1, dt_s2, la_s0, la_s1, la_s2;
  long long b_s0, b_s1, b_s2, c_s0, c_s1, c_s2;
  int n_tiles, n_hg, n_pc, n_nch, n_state, stages, vec;
};

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }
// a shared-memory row of `cols` bf16 (a multiple of 16) padded by 16 bytes
// to an odd number of 16-byte units, so the 8 rows an ldmatrix reads fall
// in different banks
__host__ __device__ __forceinline__ int tc_ld(int cols) { return cols + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a·b on the tensor cores: a 16×16 (row), b 16×8 (col), bf16; d float32.
// Not volatile: a register-only operation the compiler may schedule freely.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[0..8) += a · b over the 16-column groups np < cols/16 (b[np] holds
// the fragments of n-tiles 2np and 2np+1)
__device__ __forceinline__ void mma_terms(float (&acc)[8][4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[4][4], int cols) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (16 * np < cols) {
      mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
      mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
    }
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// a packed bf16 pair (first element in the low half) as two floats, exactly
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// (v0, v1) → three bf16 pairs that add back to them exactly: hi = rn(v),
// mid = rn(v − hi), lo = rn(v − hi − mid). The differences are exact in
// float32 and written with __fsub_rn so nothing is contracted.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(v0, hf.x), r1 = __fsub_rn(v1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// rows × cols16 bf16 (cols16 a multiple of 8) from global rows `stride`
// elements apart into shared rows `ld` apart; rows ≥ rows_ok and columns
// ≥ cols_ok are zero. 16-byte cp.async where `vec` says the source is
// aligned for it, else plain loads and stores.
__device__ __forceinline__ void tc_load(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                        long long stride, int rows, int rows_ok, int cols16,
                                        int cols_ok, bool vec) {
  const int cpr = cols16 >> 3;
  for (int i = threadIdx.x; i < rows * cpr; i += TC_THREADS) {
    const int r = i / cpr, k = (i - r * cpr) << 3;
    __nv_bfloat16* dp = dst + r * ld + k;
    if (vec && r < rows_ok && k + 8 <= cols_ok) {
      cp_async16(dp, src + r * stride + k);
    } else {
      alignas(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (r < rows_ok && k + e < cols_ok) ? src[r * stride + k + e]
                                                 : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool two, bool pair_ok) {
  if (pair_ok) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

// y for rows [t0, t0+64) of one chunk, heads [h0, h0+nh), columns [pc0,
// pc0+pw) of P. Shared memory: C's tile, `stages` × (B's s tile, x's s tile
// per head), then la and dt of the heads for every s the tile needs.
__device__ void tc_y_block(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ la, const __nv_bfloat16* __restrict__ Bm,
                           const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
                           const TcDims& d, int bc, int role, unsigned char* smem) {
  const int per_tile = d.n_hg * d.n_pc;
  const int tile = d.n_tiles - 1 - role / per_tile;
  const int hg = (role % per_tile) / d.n_pc, pc = role % d.n_pc;
  const int Q = d.Q, H = d.H, P = d.P, N = d.N;
  const int t0 = tile * TC_TILE, h0 = hg * TC_HG, pc0 = pc * TC_PC;
  const int nh = min(TC_HG, H - h0), pw = min(TC_PC, P - pc0);
  const int NK = round16(N), PW = round16(pw);
  const int ldN = tc_ld(NK), ldP = tc_ld(PW);
  const int S_end = min(Q, t0 + TC_TILE);           // s < S_end are needed
  const int S_pad = (tile + 1) * TC_TILE;
  const int b = bc / d.nc, c = bc % d.nc;
  const __nv_bfloat16* xb = x + b * d.x_s0 + c * d.x_s1;
  const float* dtb = dt + b * d.dt_s0 + c * d.dt_s1;
  const float* lab = la + b * d.la_s0 + c * d.la_s1;
  const __nv_bfloat16* Bb = Bm + b * d.b_s0 + c * d.b_s1;
  const __nv_bfloat16* Cb = Cm + b * d.c_s0 + c * d.c_s1;
  const bool vec = d.vec != 0;

  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);          // [64][ldN]
  __nv_bfloat16* st0 = Cs + TC_TILE * ldN;
  const int stage_elems = TC_TILE * ldN + TC_HG * TC_TILE * ldP;        // B, then x per head
  float* las = reinterpret_cast<float*>(st0 + d.stages * stage_elems);  // [TC_HG][S_pad]
  float* dts = las + TC_HG * S_pad;                                     // [TC_HG][S_pad]
  float4* Gs = reinterpret_cast<float4*>(dts + TC_HG * S_pad);          // [4][8][32]
  float* fs = reinterpret_cast<float*>(Gs + 4 * 8 * 32);                // [TC_HG][64]

  auto fetch = [&](int j, int buf) {
    __nv_bfloat16* Bs = st0 + buf * stage_elems;
    const int s0 = j * TC_TILE;
    tc_load(Bs, ldN, Bb + s0 * d.b_s2, d.b_s2, TC_TILE, S_end - s0, NK, N, vec);
    for (int hh = 0; hh < nh; ++hh) {
      tc_load(Bs + TC_TILE * ldN + hh * TC_TILE * ldP, ldP,
              xb + s0 * d.x_s2 + (h0 + hh) * P + pc0, d.x_s2, TC_TILE, S_end - s0, PW, pw,
              vec);
    }
  };

  tc_load(Cs, ldN, Cb + t0 * d.c_s2, d.c_s2, TC_TILE, S_end - t0, NK, N, vec);
  fetch(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < TC_HG * S_pad; i += TC_THREADS) {
    const int hh = i / S_pad, s = i - hh * S_pad;
    const bool ok = hh < nh && s < S_end;
    las[i] = ok ? lab[s * d.la_s2 + h0 + hh] : 0.f;
    dts[i] = ok ? dtb[s * d.dt_s2 + h0 + hh] : 0.f;
  }

  // warp w: rows 16(w mod 4) of the tile and head h0 + w/4; for G, the same
  // rows and the columns 32(w/4) to 32(w/4) + 31 of the s tile, shared with
  // the other warp group through Gs in the accumulator's own layout
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp & 3, hh = warp >> 2;
  const int g = lane >> 2, q4 = lane & 3;
  const int tr0 = t0 + 16 * rg + g, tr1 = tr0 + 8;      // this thread's two rows
  const bool ok0 = tr0 < Q, ok1 = tr1 < Q, busy = hh < nh;
  const float* lh = las + hh * S_pad;
  const float* dh = dts + hh * S_pad;
  float yacc[8][4];
#pragma unroll
  for (int pt = 0; pt < 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;

  for (int j = 0; j <= tile; ++j) {
    if (d.stages == 2 && j < tile) {
      fetch(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Bs = st0 + (d.stages == 2 ? (j & 1) : 0) * stage_elems;
    const __nv_bfloat16* Xh = Bs + TC_TILE * ldN + hh * TC_TILE * ldP;
    // on the diagonal tile, row group r needs the columns s < t0 + 16(r+1) only
    const int pairs = j == tile ? rg + 1 : 4;
    {
      float gpart[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) gpart[nt][e] = 0.f;
      if (2 * hh < pairs) {
#pragma unroll 8
        for (int kk = 0; kk < NK; kk += 16) {
          uint32_t a[4], bb[2][4];
          ldsm_x4(a, Cs + (16 * rg + (lane & 15)) * ldN + kk + ((lane >> 4) << 3));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (2 * hh + q < pairs) {
              ldsm_x4(bb[q], Bs + (32 * hh + 16 * q + (lane & 7) + ((lane >> 4) << 3)) * ldN +
                                 kk + (((lane >> 3) & 1) << 3));
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (2 * hh + q < pairs) {
              mma_bf16(gpart[2 * q], a, bb[q][0], bb[q][1]);
              mma_bf16(gpart[2 * q + 1], a, bb[q][2], bb[q][3]);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        Gs[(rg * 8 + 4 * hh + nt) * 32 + lane] =
            make_float4(gpart[nt][0], gpart[nt][1], gpart[nt][2], gpart[nt][3]);
      }
    }
    // below the diagonal, exp(la_t − la_s) = exp(la_t − la_r)·exp(la_r − la_s)
    // with r the s tile's last column: both factors ≤ 1, so M = (G·e_t)·f_s
    // with f_s = exp(la_r − la_s)·dt_s, one per column, and two exps a row
    if (j < tile && threadIdx.x < TC_HG * TC_TILE) {
      const int fh = threadIdx.x / TC_TILE, col = threadIdx.x % TC_TILE;
      const float* l = las + fh * S_pad + j * TC_TILE;
      fs[threadIdx.x] = fh < nh ? __fmul_rn(expf(__fsub_rn(l[TC_TILE - 1], l[col])),
                                            dts[fh * S_pad + j * TC_TILE + col])
                                : 0.f;
    }
    __syncthreads();
    if (busy) {
      const float la0 = ok0 ? lh[tr0] : 0.f, la1 = ok1 ? lh[tr1] : 0.f;
      const bool diag = j == tile;
      const float la_r = lh[j * TC_TILE + TC_TILE - 1];
      const float e0 = !diag && ok0 ? expf(__fsub_rn(la0, la_r)) : 0.f;
      const float e1 = !diag && ok1 ? expf(__fsub_rn(la1, la_r)) : 0.f;
      const float* fh = fs + hh * TC_TILE;
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {          // 16 columns s: G's n-tiles 2kp, 2kp+1
        if (kp >= pairs) continue;
        uint32_t bx[4][4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {          // 16 columns p: y's n-tiles 2pp, 2pp+1
          if (16 * pp < PW) {
            ldsm_x4_t(bx[pp], Xh + (16 * kp + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldP +
                                  16 * pp + ((lane >> 4) << 3));
          }
        }
        float m[8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 gv = Gs[(rg * 8 + 2 * kp + half) * 32 + lane];   // G's n-tile 2kp+half
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * kp + 8 * half + 2 * q4 + e, s = j * TC_TILE + col;
            const float g0 = e ? gv.y : gv.x, g1 = e ? gv.w : gv.z;
            if (diag) {
              const float la_s = lh[s], dt_s = dh[s];
              m[4 * half + e] = (ok0 && s <= tr0)
                  ? __fmul_rn(__fmul_rn(g0, expf(__fsub_rn(la0, la_s))), dt_s) : 0.f;
              m[4 * half + 2 + e] = (ok1 && s <= tr1)
                  ? __fmul_rn(__fmul_rn(g1, expf(__fsub_rn(la1, la_s))), dt_s) : 0.f;
            } else {
              m[4 * half + e] = __fmul_rn(__fmul_rn(g0, e0), fh[col]);
              m[4 * half + 2 + e] = __fmul_rn(__fmul_rn(g1, e1), fh[col]);
            }
          }
        }
        uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split3(m[2 * r], m[2 * r + 1], ahi[r], amid[r], alo[r]);
        // small terms first; consecutive products go to different accumulators
        mma_terms(yacc, alo, bx, PW);
        mma_terms(yacc, amid, bx, PW);
        mma_terms(yacc, ahi, bx, PW);
      }
    }
    __syncthreads();
    if (d.stages == 1 && j < tile) {
      fetch(j + 1, 0);
      cp_async_commit();
    }
  }

  if (!busy) return;
  const bool pairs_ok = (P & 1) == 0;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    const int p = pc0 + 8 * pt + 2 * q4;
    if (p >= pc0 + pw) continue;
    const bool two = p + 1 < pc0 + pw;
    if (ok0) {
      float* yr = y + ((static_cast<long long>(bc) * Q + tr0) * H + h0 + hh) * P + p;
      store2(yr, yacc[pt][0], yacc[pt][1], two, two && pairs_ok);
    }
    if (ok1) {
      float* yr = y + ((static_cast<long long>(bc) * Q + tr1) * H + h0 + hh) * P + p;
      store2(yr, yacc[pt][2], yacc[pt][3], two, two && pairs_ok);
    }
  }
}

// The chunk states of heads [h0, h0+nh) (a pair: B's tiles serve both),
// columns [n0, n0+nw) of N, every row of P. Shared memory: `stages` × (x's
// s tile per head, B's s tile), then w of the heads for every s.
__device__ void tc_state_block(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ dt, const float* __restrict__ la,
                               const __nv_bfloat16* __restrict__ Bm, float* __restrict__ st,
                               const TcDims& d, int bc, int role, unsigned char* smem) {
  const int h0 = (role / d.n_nch) * TC_HG, n0 = (role % d.n_nch) * TC_NC;
  const int Q = d.Q, H = d.H, P = d.P, N = d.N;
  const int nh = min(TC_HG, H - h0);
  const int nw = min(TC_NC, N - n0), NW = round16(nw), PP = round16(P);
  const int ldX = tc_ld(PP), ldB = tc_ld(NW);
  const int n_s = (Q + TC_TILE - 1) / TC_TILE, S_pad = n_s * TC_TILE;
  const int b = bc / d.nc, c = bc % d.nc;
  const __nv_bfloat16* xb = x + b * d.x_s0 + c * d.x_s1 + h0 * P;
  const float* dtb = dt + b * d.dt_s0 + c * d.dt_s1;
  const float* lab = la + b * d.la_s0 + c * d.la_s1;
  const __nv_bfloat16* Bb = Bm + b * d.b_s0 + c * d.b_s1 + n0;
  const bool vec = d.vec != 0;

  __nv_bfloat16* st0 = reinterpret_cast<__nv_bfloat16*>(smem);
  const int stage_elems = TC_HG * TC_TILE * ldX + TC_TILE * ldB;       // x per head, then B
  float* ws = reinterpret_cast<float*>(st0 + d.stages * stage_elems);  // [TC_HG][S_pad]

  auto fetch = [&](int j, int buf) {
    __nv_bfloat16* Xs = st0 + buf * stage_elems;
    const int s0 = j * TC_TILE;
    for (int hh = 0; hh < nh; ++hh) {
      tc_load(Xs + hh * TC_TILE * ldX, ldX, xb + s0 * d.x_s2 + hh * P, d.x_s2, TC_TILE, Q - s0,
              PP, P, vec);
    }
    tc_load(Xs + TC_HG * TC_TILE * ldX, ldB, Bb + s0 * d.b_s2, d.b_s2, TC_TILE, Q - s0, NW, nw,
            vec);
  };

  for (int i = threadIdx.x; i < TC_HG * S_pad; i += TC_THREADS) {
    const int hh = i / S_pad, s = i - hh * S_pad, h = h0 + hh;
    ws[i] = hh < nh && s < Q
        ? __fmul_rn(expf(__fsub_rn(lab[(Q - 1) * d.la_s2 + h], lab[s * d.la_s2 + h])),
                    dtb[s * d.dt_s2 + h])
        : 0.f;
  }

  // warp w: head h0 + w/4, 16 rows of P (w mod 4; 64 rows a round), every
  // column of the block's N
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3, hh = warp >> 2;
  const int m_tiles = PP / 16;
  const bool pairs_ok = (N & 1) == 0;
  for (int mg = 0; mg < m_tiles; mg += 4) {
    const int mt = mg + (warp & 3);
    const bool active = mt < m_tiles && hh < nh;
    float acc[2][8][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hf][nt][e] = 0.f;
    __syncthreads();                               // w is written; the last round is read
    fetch(0, 0);
    cp_async_commit();
    for (int j = 0; j < n_s; ++j) {
      if (d.stages == 2 && j + 1 < n_s) {
        fetch(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* Xs = st0 + (d.stages == 2 ? (j & 1) : 0) * stage_elems;
      const __nv_bfloat16* Xh = Xs + hh * TC_TILE * ldX;
      const __nv_bfloat16* Bs = Xs + TC_HG * TC_TILE * ldX;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {           // 16 rows s
          uint32_t a[4];
          ldsm_x4_t(a, Xh + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * ldX + 16 * mt +
                           (((lane >> 3) & 1) << 3));
          const float* w = ws + hh * S_pad + j * TC_TILE + 16 * kk + 2 * q4;
          const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
          uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 xv = unpack_bf16x2(a[r]);
            const float wa = r < 2 ? w0 : w8, wb = r < 2 ? w1 : w9;
            split3(__fmul_rn(xv.x, wa), __fmul_rn(xv.y, wb), ahi[r], amid[r], alo[r]);
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {         // 64 columns n at a time
            uint32_t bb[4][4];
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (64 * hf + 16 * np < NW) {
                ldsm_x4_t(bb[np], Bs + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldB +
                                      64 * hf + 16 * np + ((lane >> 4) << 3));
              }
            }
            mma_terms(acc[hf], alo, bb, NW - 64 * hf);
            mma_terms(acc[hf], amid, bb, NW - 64 * hf);
            mma_terms(acc[hf], ahi, bb, NW - 64 * hf);
          }
        }
      }
      __syncthreads();
      if (d.stages == 1 && j + 1 < n_s) {
        fetch(j + 1, 0);
        cp_async_commit();
      }
    }
    if (!active) continue;
    const int p0 = 16 * mt + g, p1 = p0 + 8;
    float* sb = st + (static_cast<long long>(bc) * H + h0 + hh) * P * N;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + 64 * hf + 8 * nt + 2 * q4;
        if (n >= n0 + nw) continue;
        const bool two = n + 1 < n0 + nw;
        if (p0 < P) {
          store2(sb + static_cast<long long>(p0) * N + n, acc[hf][nt][0], acc[hf][nt][1], two,
                 two && pairs_ok);
        }
        if (p1 < P) {
          store2(sb + static_cast<long long>(p1) * N + n, acc[hf][nt][2], acc[hf][nt][3], two,
                 two && pairs_ok);
        }
      }
    }
  }
}

// Grid (B·nc, n_state + n_tiles·n_hg·n_pc): state blocks first along y, then
// y blocks from the last row tile down.
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_intra_chunk_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ la, const __nv_bfloat16* __restrict__ Bm,
                          const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
                          float* __restrict__ st, TcDims d) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int bc = blockIdx.x, role = blockIdx.y;
  if (role < d.n_state) {
    tc_state_block(x, dt, la, Bm, st, d, bc, role, tc_smem);
  } else {
    tc_y_block(x, dt, la, Bm, Cm, y, d, bc, role - d.n_state, tc_smem);
  }
}

int tc_smem_bytes(int Q, int P, int N, int stages) {
  const int S_pad = (Q + TC_TILE - 1) / TC_TILE * TC_TILE;
  const int PW = round16(P) < TC_PC ? round16(P) : TC_PC;
  const int NW = round16(N) < TC_NC ? round16(N) : TC_NC;
  const int ldN = tc_ld(round16(N)), ldP = tc_ld(PW);
  const int y_bytes = 2 * (TC_TILE * ldN + stages * (TC_TILE * ldN + TC_HG * TC_TILE * ldP)) +
                      4 * 2 * TC_HG * S_pad + 16 * 4 * 8 * 32 + 4 * TC_HG * TC_TILE;
  const int ldX = tc_ld(round16(P)), ldB = tc_ld(NW);
  const int st_bytes = 2 * stages * (TC_HG * TC_TILE * ldX + TC_TILE * ldB) +
                       4 * TC_HG * S_pad;
  return y_bytes > st_bytes ? y_bytes : st_bytes;
}

int launch_tc(const void* x, const void* dt, const void* la, const void* Bm, const void* Cm,
              void* y, void* st, int BC, const TcDims& d, int smem_bytes, cudaStream_t s) {
  static int allowed = 0;
  if (smem_bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = SMEM_MAX;
  }
  if (smem_bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BC, d.n_state + d.n_tiles * d.n_hg * d.n_pc);
  ssd_intra_chunk_tc_kernel<<<grid, TC_THREADS, smem_bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(la), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<float*>(y), static_cast<float*>(st), d);
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

// bfloat16 x, B and C on the tensor cores. Strides as above. stages (1 or
// 2) and vec (1 where every base pointer is 16-byte aligned and every
// stride, P and N a multiple of 8 elements, so tiles come in by 16-byte
// cp.async) are chosen by the caller; smem_bytes must be what the plan of
// kernels/ssd_scan/ops.py gives for them, or the call is refused.
int ssd_intra_chunk_tc(const void* x, const void* dt, const void* la, const void* Bm,
                       const void* Cm, void* y, void* st, int Bsz, int nc, int Q, int H, int P,
                       int N, long long x_s0, long long x_s1, long long x_s2, long long dt_s0,
                       long long dt_s1, long long dt_s2, long long la_s0, long long la_s1,
                       long long la_s2, long long b_s0, long long b_s1, long long b_s2,
                       long long c_s0, long long c_s1, long long c_s2, int stages, int vec,
                       int smem_bytes, void* stream) {
  if (Bsz <= 0 || nc <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if ((stages != 1 && stages != 2) || smem_bytes != tc_smem_bytes(Q, P, N, stages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (Q + TC_TILE - 1) / TC_TILE, n_hg = (H + TC_HG - 1) / TC_HG;
  const int n_pc = (P + TC_PC - 1) / TC_PC, n_nch = (N + TC_NC - 1) / TC_NC;
  TcDims d{nc,    Q,     H,     P,     N,     x_s0,    x_s1,   x_s2,    dt_s0, dt_s1,
           dt_s2, la_s0, la_s1, la_s2, b_s0,  b_s1,    b_s2,   c_s0,    c_s1,  c_s2,
           n_tiles, n_hg, n_pc,  n_nch, n_hg * n_nch, stages, vec};
  if (static_cast<long long>(d.n_state) + static_cast<long long>(n_tiles) * n_hg * n_pc >
      65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = launch_tc(x, dt, la, Bm, Cm, y, st, Bsz * nc, d, smem_bytes,
                            static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
