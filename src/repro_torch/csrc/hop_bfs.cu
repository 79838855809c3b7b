// hop_bfs.cu — one matmul-BFS hop for the simulated-annealing warm start,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hop_bfs/kernel.py:hop_step_2d
// (body _hop_step_kernel): new = reach OR (reach @ adj) on 0/1 matrices,
// plus each row's reach count, fused into one pass. The reference calls it
// per restart under vmap; here the restart axis is explicit:
//   reach, adj: (R, n, n) bytes (torch.bool or torch.uint8; any nonzero
//               byte is a 1)
//   new:        (R, n, n) 0/1 bytes, the same type
//   counts:     (R, n) int32, counts[r, a] = number of b with new[r, a, b]
// It runs on every hop of every SA move's ASPL (warmstart._aspl_total).
// adj is not assumed symmetric.
//
// What bounds it on the H100: bytes, 3 R n^2 + 4 R n (reach and adj read
// once, new and the counts written once) against 2 R n^3 operations on
// 0/1 values at the int8 tensor-core rate (1,979 TOP/s):
//   R = 1, n = 64 (main_n64's SA, one restart per hop): 12.5 KB -> 3.7 ns.
//   R = 4, n = 256:                                     790.5 KB -> 236 ns.
// At these sizes a launch costs microseconds, so the design aims at few
// dependent memory round trips, enough blocks, and no wasted lanes.
//
// Design: bits, and OR of rows. Row a of the new reach is
//   new[a] = reach[a] | OR over k with reach[a, k] of adj[k],
// taken 32 columns at a time on packed words (n/8 bytes of operand a row
// in place of the 4n of float32). A block owns `bm` rows of one restart
// (a band) and `cw` 32-column words of the output (a chunk):
//  1. It packs its band of reach rows (full width, nw = ceil(n/32) words a
//     row) and the chunk's columns of every adj row into shared memory as
//     bits, both in one pass, with 16-byte loads (ld.global.nc, up to eight
//     a thread in flight) turned into masks by __vcmpne4 and one multiply
//     per four bytes. When every row starts on a 16-byte boundary (n a
//     multiple of 16: the SA's shapes) a thread takes whole 32-column words
//     and stores them. Otherwise a thread takes aligned 16-byte pieces and
//     ORs them into the words with shared atomics, so any n and any row
//     alignment work: an aligned 16-byte piece that holds a byte of the
//     tensor lies in the same page as that byte, and bytes outside a row's
//     range are masked off. adj's packed rows are padded to 32·nw (zero),
//     so the product below reads in bounds without a test.
//  2. A warp takes one row and up to 8 output words: lane l takes k = 32w + l
//     for every reach word w and ORs adj's packed words at (k, c) in where
//     reach has bit k (a mask, not a branch: every lane runs the same nw
//     steps), then the warp ORs its lanes together (__reduce_or_sync). The
//     adj reads have an odd word stride (no bank conflicts), the reach word
//     is a broadcast.
//  3. The warp ORs the incoming reach word, writes each word's 32 output
//     bytes (one coalesced store) and adds the popcounts to the row's count
//     in shared memory.
//  4. Counts: with one chunk (cw = nw) the block writes its rows' counts.
//     With several chunks each block adds its partial counts to an int32
//     workspace with atomics (exact, order-free), and the last block of
//     the band to finish (a ticket taken with atomicAdd after a
//     __threadfence) reads the totals out with atomicExch(…, 0) and resets
//     the ticket: the kernel leaves the workspace zeroed for the next call,
//     so there is no memset launch.
//
// The plan (bm, cw) comes from the wrapper (kernels/hop_bfs/ops.py,
// hop_plan). Every block packs all the adj columns it needs, so a block is
// not free: where all of adj's columns fit one block (n up to about 1,300)
// there is no column split and the band is sized for half a wave of the
// 132 SMs (bm = max(4, floor(R·n / 66))); past that the columns are split,
// for a full wave, into the chunks that load the fewest bytes a block:
//   R = 1, n = 16:    bm = 4,   cw = 1:  4 blocks.
//   R = 1, n = 64:    bm = 4,   cw = 2:  16 blocks (main_n64's SA).
//   R = 4, n = 256:   bm = 15,  cw = 8:  18 bands x 4 = 72 blocks.
//   R = 1, n = 1,000: bm = 15,  cw = 32: 67 blocks, 134 KB of adj bits each.
//   R = 1, n = 2,000: bm = 181, cw = 5:  12 bands x 13 chunks = 156 blocks.
// Shared memory is 4·(bm·nw + 32·nw·(cw|1) + bm) bytes, so n up to about
// 50,000 fits with bm = cw = 1; the wrapper raises above what fits.
//
// Plain C interface for ctypes: the entry checks that the current device
// is the one the tensors lie on, launches on the given stream, never
// synchronises, and returns a CUDA error code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CG = 8;                  // output words a warp takes at once

// Bits 0..3: which of the four bytes of x are nonzero.
__device__ __forceinline__ uint32_t nz4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Bits e of the 16 bytes at offset pos + e (pos ≥ −15) that lie in [0, seg).
__device__ __forceinline__ uint32_t byte_range(int pos, int seg) {
  const int lo = pos < 0 ? -pos : 0;
  const int hi = seg - pos < 16 ? seg - pos : 16;
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// Bytes [c0, c0 + seg) of `rows` rows (row i at base + i·n), to be packed
// into bits: S[i·sstride + (col − c0)/32] bit (col − c0)%32 for a nonzero
// byte. c0 is a multiple of 32; S must be zeroed.
struct Region {
  const uint8_t* base;
  int c0, seg, per_row, total, sstride;
  float inv;                                        // 1 / per_row
  uint32_t* S;
  bool aligned;                                     // every row starts 16-byte aligned
};

__device__ __forceinline__ Region region(const uint8_t* base, int rows, int n, int c0, int c1,
                                         uint32_t* S, int sstride) {
  Region g;
  g.base = base;
  g.c0 = c0;
  g.seg = c1 - c0;
  // aligned 16-byte pieces a row touches: one more when rows do not start
  // on a 16-byte boundary
  g.aligned = n % 16 == 0 && (reinterpret_cast<uintptr_t>(base) + c0) % 16 == 0;
  g.per_row = (g.seg + 15) / 16 + (g.aligned ? 0 : 1);
  g.total = rows * g.per_row;
  g.sstride = sstride;
  g.inv = 1.f / static_cast<float>(g.per_row);
  g.S = S;
  return g;
}

// Packs two regions (the band of reach and adj's chunk) in one pass over
// their 16-byte pieces, LOADS a thread at a time: all of a thread's loads
// are issued before any is used, so a block waits for one round trip per
// LOADS·THREADS pieces, for both regions together.
template <int LOADS>
__device__ __forceinline__ void pack(const Region& g0, const Region& g1, int n) {
  const int total = g0.total + g1.total;
  for (int first = threadIdx.x; first < total; first += THREADS * LOADS) {
    uint4 v[LOADS];
    int pos[LOADS], seg[LOADS];
    uint32_t* at[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      int idx = first + u * THREADS;
      const bool second = idx >= g0.total;
      const Region& g = second ? g1 : g0;
      if (second) idx -= g0.total;
      // idx / per_row by a float reciprocal, corrected to the exact quotient
      int i = __float2int_rz(static_cast<float>(idx) * g.inv);
      int j = idx - i * g.per_row;
      if (j < 0) { --i; j += g.per_row; }
      if (j >= g.per_row) { ++i; j -= g.per_row; }
      const uintptr_t start = reinterpret_cast<uintptr_t>(g.base) + static_cast<size_t>(i) * n + g.c0;
      const uintptr_t p = (start & ~static_cast<uintptr_t>(15)) + 16 * static_cast<uintptr_t>(j);
      at[u] = g.S + i * g.sstride;
      seg[u] = g.seg;
      pos[u] = first + u * THREADS < total ? static_cast<int>(static_cast<intptr_t>(p - start)) : g.seg;
      v[u] = pos[u] < seg[u] ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (pos[u] >= seg[u]) continue;
      // bit e of m: byte e is nonzero (four bytes at a time: 0x01 per
      // nonzero byte, gathered into bits 24..27 by one multiply)
      const uint32_t m = (nz4(v[u].x) | nz4(v[u].y) << 4 | nz4(v[u].z) << 8 |
                          nz4(v[u].w) << 12) & byte_range(pos[u], seg[u]);
      if (m == 0) continue;
      const int wi = pos[u] >> 5, sh = pos[u] & 31;  // floor(pos / 32), pos ≥ −15
      const uint64_t bits = static_cast<uint64_t>(m) << sh;
      const uint32_t lo = static_cast<uint32_t>(bits), hi = static_cast<uint32_t>(bits >> 32);
      if (lo != 0 && wi >= 0) atomicOr(&at[u][wi], lo);
      if (hi != 0) atomicOr(&at[u][wi + 1], hi);
    }
  }
}

// The same for rows that start on a 16-byte boundary (n a multiple of 16,
// aligned tensors: every shape on the SA's path): a thread takes one packed
// word, the two 16-byte pieces of its 32 columns, and stores it whole — no
// masks, no atomics, no piece that straddles two words.
template <int LOADS>
__device__ __forceinline__ void pack_aligned(const Region& g0, const Region& g1, int n) {
  const int w0n = (g0.seg + 31) / 32, w1n = (g1.seg + 31) / 32;
  const int t0 = g0.total / g0.per_row * w0n;       // rows x words of each region
  const int total = t0 + g1.total / g1.per_row * w1n;
  const float inv0 = 1.f / static_cast<float>(w0n), inv1 = 1.f / static_cast<float>(w1n);
  for (int first = threadIdx.x; first < total; first += THREADS * LOADS) {
    uint4 lo[LOADS], hi[LOADS];
    uint32_t* at[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      int idx = first + u * THREADS;
      const bool second = idx >= t0;
      const Region& g = second ? g1 : g0;
      const int wn = second ? w1n : w0n;
      if (second) idx -= t0;
      int i = __float2int_rz(static_cast<float>(idx) * (second ? inv1 : inv0));
      int w = idx - i * wn;
      if (w < 0) { --i; w += wn; }
      if (w >= wn) { ++i; w -= wn; }
      const uint4* p = reinterpret_cast<const uint4*>(g.base + static_cast<size_t>(i) * n + g.c0 + 32 * w);
      const bool live = first + u * THREADS < total;
      at[u] = live ? g.S + i * g.sstride + w : nullptr;
      lo[u] = live ? __ldg(p) : make_uint4(0, 0, 0, 0);
      hi[u] = live && 32 * w + 16 < g.seg ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (at[u] == nullptr) continue;
      *at[u] = nz4(lo[u].x) | nz4(lo[u].y) << 4 | nz4(lo[u].z) << 8 | nz4(lo[u].w) << 12 |
               nz4(hi[u].x) << 16 | nz4(hi[u].y) << 20 | nz4(hi[u].z) << 24 | nz4(hi[u].w) << 28;
    }
  }
}

// Grid (chunks, bands, R); dynamic shared memory 4·(bm·nw + 32·nw·cwp + bm).
__global__ void __launch_bounds__(THREADS)
hop_step_kernel(const uint8_t* __restrict__ reach, const uint8_t* __restrict__ adj,
                uint8_t* __restrict__ out, int32_t* __restrict__ counts,
                int32_t* __restrict__ part, int32_t* __restrict__ tickets, int n, int bm,
                int cw) {
  extern __shared__ uint32_t smem[];
  const int nw = (n + 31) / 32;
  const int cwp = cw | 1;                         // odd stride: no bank conflicts
  uint32_t* sR = smem;                            // bm x nw: the band of reach, packed
  uint32_t* sA = sR + bm * nw;                    // 32·nw x cwp: adj's chunk columns, packed
  int* sCnt = reinterpret_cast<int*>(sA + 32 * nw * cwp);
  __shared__ int s_last;

  const int chunks = gridDim.x, bands = gridDim.y;
  const int chunk = blockIdx.x, band = blockIdx.y, r = blockIdx.z;
  const size_t nn = static_cast<size_t>(n) * n;
  const int a0 = band * bm, rows = min(bm, n - a0);
  const int w0 = chunk * cw, wn = min(cw, nw - w0);
  const int c0 = 32 * w0, c1 = min(n, 32 * (w0 + wn));

  for (int i = threadIdx.x; i < bm * nw + 32 * nw * cwp + bm; i += THREADS) smem[i] = 0;
  __syncthreads();
  const Region gr = region(reach + r * nn + static_cast<size_t>(a0) * n, rows, n, 0, n, sR, nw);
  const Region ga = region(adj + r * nn, n, n, c0, c1, sA, cwp);
  if (gr.aligned && ga.aligned) {
    if (gr.total + ga.total <= 2 * THREADS) {
      pack_aligned<1>(gr, ga, n);                   // one word a thread: no batching
    } else {
      pack_aligned<8>(gr, ga, n);
    }
  } else if (gr.total + ga.total <= THREADS) {
    pack<1>(gr, ga, n);                             // one piece a thread: no batching
  } else {
    pack<8>(gr, ga, n);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* O = out + r * nn;
  // a warp takes one row and up to CG output words of the chunk; lane l
  // takes k = 32w + l for every reach word w
  const int groups = (wn + CG - 1) / CG;
  for (int task = warp; task < rows * groups; task += WARPS) {
    const int a = task / groups, cb = (task % groups) * CG;
    const int cn = min(CG, wn - cb);
    const uint32_t* rrow = sR + a * nw;
    uint32_t acc[CG];
#pragma unroll
    for (int x = 0; x < CG; ++x) acc[x] = 0;
    // sA has 32·nw rows (those past n zero), so every row read is in bounds
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      const uint32_t mask = 0u - ((rrow[w] >> lane) & 1u);
      const uint32_t* arow = sA + (32 * w + lane) * cwp + cb;
#pragma unroll
      for (int x = 0; x < CG; ++x) {
        if (x < cn) acc[x] |= arow[x] & mask;
      }
    }
    int cnt = 0;
#pragma unroll
    for (int x = 0; x < CG; ++x) {
      if (x < cn) {
        const int c = cb + x;
        const uint32_t word = __reduce_or_sync(0xffffffffu, acc[x]) | rrow[w0 + c];
        const int col = 32 * (w0 + c) + lane;
        if (col < n) {
          O[static_cast<size_t>(a0 + a) * n + col] = static_cast<uint8_t>((word >> lane) & 1u);
        }
        cnt += __popc(word);
      }
    }
    if (lane == 0 && cnt != 0) atomicAdd(&sCnt[a], cnt);
  }
  __syncthreads();

  int32_t* cnt_out = counts + static_cast<size_t>(r) * n + a0;
  if (chunks == 1) {
    for (int a = threadIdx.x; a < rows; a += THREADS) cnt_out[a] = sCnt[a];
    return;
  }
  int32_t* cnt_part = part + static_cast<size_t>(r) * n + a0;
  for (int a = threadIdx.x; a < rows; a += THREADS) {
    if (sCnt[a] != 0) atomicAdd(&cnt_part[a], sCnt[a]);
  }
  // the barrier puts every thread's partial atomics before thread 0's
  // __threadfence, which orders them (cumulatively) before its ticket
  __syncthreads();
  int32_t* ticket = tickets + static_cast<size_t>(r) * bands + band;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1) == chunks - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  for (int a = threadIdx.x; a < rows; a += THREADS) cnt_out[a] = atomicExch(&cnt_part[a], 0);
  if (threadIdx.x == 0) atomicExch(ticket, 0);
}

}  // namespace

extern "C" {

// part: (R, n) int32 and tickets: (R, bands) int32, zero on entry and left
// zero; read only when the columns are split (cw < nw).
int hop_step_u8(const void* reach, const void* adj, void* out, void* counts, void* part,
                void* tickets, int batch, int n, int bm, int cw, int device, void* stream) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  if (batch <= 0 || n <= 0) return 0;
  const int nw = (n + 31) / 32;
  if (bm < 1 || cw < 1 || cw > nw) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * (static_cast<size_t>(bm) * nw + 32 * static_cast<size_t>(nw) * (cw | 1) + bm);
  static size_t opted[64] = {};                 // shared memory opted in, per device
  if (smem > 48 * 1024 && current < 64 && smem > opted[current]) {
    e = cudaFuncSetAttribute(hop_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[current] = smem;
  }
  const dim3 grid((nw + cw - 1) / cw, (n + bm - 1) / bm, batch);
  hop_step_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reach), static_cast<const uint8_t*>(adj),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(counts), static_cast<int32_t*>(part),
      static_cast<int32_t*>(tickets), n, bm, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
