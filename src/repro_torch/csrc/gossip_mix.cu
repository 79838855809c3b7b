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
// fp16). Every kernel here adds the same products in that order, so all of
// them give the same bits. The batched kernel runs on every gossip of every
// DSGD train step and of the §VI-B sim, once for all leaves of a step that
// share a neighbour table; the one-worker kernel under the row-loop oracle.
//
// What bounds it on the H100: bytes. It does (2·deg+1) flops per element
// against 2·size bytes at least, far under the card's ~20 flop/byte fp32
// balance. For the batched kernel the least traffic is x read once and the
// output written once, 2·n·M·size bytes: smollm-135m at n = 8 in bf16 is
// 4.30 GB per step, 1.28 ms at 3.35 TB/s. The one-worker kernel reads its
// neighbours from a separate (deg, M) buffer: (deg+2)·M·size bytes.
//
// What the first design lost (gossip_mix_batched_witness below). A block
// owned one worker's row and asked for deg+1 rows through the table, so
// each element of x was requested deg+1 times (5× at deg 4, 8× at the
// elastic step's deg_cap = 7): only the 50 MB L2 kept the repeats off
// device memory, and not all of them (at the same bytes its time grows
// with deg). Its slot loop ran over a runtime deg, so each thread had one
// 16-byte load in flight at a time.
//
// The design (gossip_mix_tiles_kernel). A persistent grid walks over column
// tiles: tile [c0, c0+T) of ALL n rows of a leaf, the tiles of every leaf
// of the call in one numbering (the leaves' pointers, row lengths and tile
// prefix sums travel by value in the kernel's parameters). A producer warp
// copies a tile's n row segments into a ring of 2–4 stages in shared
// memory with the bulk-copy engine (cp.async.bulk, the TMA's 1-D form: no
// tensor map to encode on the host), completing on the stage's
// `full` mbarrier; its lanes share the n copies. Eight consumer warps
// compute all n outputs of the tile from shared memory — every neighbour's
// segment at the same column, 16 bytes a thread, so no bank conflicts —
// and write them with 16-byte stores, then free the stage on its `empty`
// mbarrier. x is read from device memory once whatever deg is; a padded
// slot (weight 0, the row itself) costs arithmetic only. The slot loop is
// unrolled for deg ≤ 7 (the paths' largest), so a thread's deg+1 shared
// loads are in flight together; a runtime loop covers larger degrees.
// Tiles whose rows are narrower than 1 KB come in by 16-byte cp.async over
// the producer's lanes instead (n bulk copies a tile cost more than their
// bytes there). A leaf whose rows do not all start 16-byte aligned in x
// (M·size % 16 ≠ 0, or x itself misaligned) comes in element by element:
// 4-byte cp.async for fp32 (the plain loads took 4× as long there), batched
// plain loads for 2-byte types, whose elements no cp.async can copy (PERF.md
// times both routes and the alternatives tried). A leaf
// whose output rows are misaligned is stored element by element. The
// neighbour table and weights sit in shared memory beside the ring,
// loaded by the consumers (each index checked) while the first tile comes
// in. A 2-stage ring of about 20 KB a stage and 4 blocks an SM (the launch
// bound; ops.py's gossip_plan) gave the best of the plans tried on the
// card at the training and the sim's shapes (tools/gossip_tune.py varies
// each of the plan's constants there).
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

// The tiled kernel: eight consumer warps and one producer warp.
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int MIX_THREADS = CONSUMERS + 32;
constexpr int MAX_LEAVES = 128;        // leaves of one launch (the parameters' 4 KB)
constexpr int MIN_BLOCKS = 4;          // resident blocks an SM the registers must allow
constexpr int SMEM_MAX = 232448;       // a block's shared memory on the H100

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// acc[k] (+)= w · v[k] for VEC values already loaded.
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void add_products(float (&acc)[VEC], const T (&v)[VEC], float w) {
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

// acc[k] (+)= w · row[k] for VEC consecutive elements of global memory.
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void accumulate(float (&acc)[VEC], const T* row, float w) {
  alignas(16) T v[VEC];
  if constexpr (VEC == 1) {
    v[0] = row[0];
  } else {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(row));
  }
  add_products<T, VEC, FIRST>(acc, v, w);
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

// ---------------------------------------------------------------------------
// The first-cut batched kernel, kept only as the tiled kernel's timing
// witness and bitwise reference on the card: no path launches it. It mixes
// rows[0] (self) and rows[1..deg] (neighbours) into out over the columns
// this block owns: vector units first (grid-stride over `blocks` column
// blocks), then the scalar tail, taken by column block 0. The one-worker
// kernel shares it.
// ---------------------------------------------------------------------------
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
gossip_mix_batched_witness_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
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

// ---------------------------------------------------------------------------
// The tiled batched kernel: every leaf of a call, one launch.
// ---------------------------------------------------------------------------

// The leaves of one launch, by value in the kernel's parameters. Leaf l's
// tiles are [tile_end[l-1], tile_end[l]) of the launch's numbering; the
// unused entries repeat the last tile_end, so no tile maps to them.
struct Leaves {
  const void* x[MAX_LEAVES];
  void* out[MAX_LEAVES];
  long long M[MAX_LEAVES];              // a row's elements
  int tile_end[MAX_LEAVES];
  unsigned char bulk[MAX_LEAVES];       // 1: every row of x starts 16-byte aligned
  unsigned char vstore[MAX_LEAVES];     // 1: every row of out starts 16-byte aligned
};
static_assert(sizeof(Leaves) + 64 <= 4096, "the kernel's parameters must fit in 4 KB");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Where tile t lies: its leaf (a cursor that only moves forward, since a
// block walks its tiles in increasing order), first column and width.
struct Tile {
  int leaf;
  long long c0;
  int width;
};

__device__ __forceinline__ Tile locate(const Leaves& L, int t, int& leaf, int tile_elems) {
  while (t >= L.tile_end[leaf]) ++leaf;
  const int first = leaf > 0 ? L.tile_end[leaf - 1] : 0;
  const long long c0 = static_cast<long long>(t - first) * tile_elems;
  const long long left = L.M[leaf] - c0;
  return {leaf, c0, static_cast<int>(left < tile_elems ? left : tile_elems)};
}

// Shared memory: the ring (stages × n × tile_bytes), the full and empty
// mbarriers, the weights (n, deg+1) fp32, the neighbours' byte offsets in a
// stage (n, deg) int32. tile_bytes is a power of two, at least 16. `bulk`:
// leaves whose rows are 16-byte aligned come in by cp.async.bulk (1) or by
// 16-byte cp.async (0, for narrow tiles).
template <typename T, int DEG>
__global__ void __launch_bounds__(MIX_THREADS, MIN_BLOCKS)
gossip_mix_tiles_kernel(const __grid_constant__ Leaves L, const int32_t* __restrict__ nbr,
                        const float* __restrict__ w, int n, int deg_rt, int tile_bytes,
                        int stages, int tiles, int bulk) {
  constexpr int VEC = 16 / sizeof(T);
  const int deg = DEG >= 0 ? DEG : deg_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = n * tile_bytes;
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  float* sw = reinterpret_cast<float*>(empty + stages);
  int* soff = reinterpret_cast<int*>(sw + n * (deg + 1));

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" :: "r"(smem_addr(&full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(&empty[s])),
                   "r"(CONSUMER_WARPS) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                                    // the barriers are set

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile_elems = tile_bytes / static_cast<int>(sizeof(T));
  int leaf = 0;
  if (warp == CONSUMER_WARPS) {                       // the producer warp: all 32 lanes arrive
    for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      const int s = i % stages;
      if (i >= stages) {
        bar_wait(&empty[s], (i / stages - 1) & 1);
        // the consumers read the stage (and plain loads wrote it) through
        // the generic proxy before the copies of this tile write it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      const Tile tl = locate(L, t, leaf, tile_elems);
      const T* x = static_cast<const T*>(L.x[tl.leaf]) + tl.c0;
      const long long M = L.M[tl.leaf];
      unsigned char* dst = ring + s * stage_bytes;
      const uint32_t row = static_cast<uint32_t>(tl.width) * sizeof(T);  // aligned: a multiple of 16
      if (L.bulk[tl.leaf] && bulk) {
        if (lane == 0) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       :: "r"(smem_addr(&full[s])), "r"(row * n) : "memory");
        }
        __syncwarp();
        if (lane != 0) bar_arrive(&full[s]);
        for (int r = lane; r < n; r += 32) {
          bulk_copy(dst + r * tile_bytes, x + r * M, row, &full[s]);
        }
      } else if (L.bulk[tl.leaf]) {
        const int units = static_cast<int>(row / 16);
        for (int q = lane; q < n * units; q += 32) {
          const int r = q / units, v = q - r * units;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(smem_addr(dst + r * tile_bytes + v * 16)), "l"(x + r * M + v * VEC)
                       : "memory");
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(smem_addr(&full[s])) : "memory");
      } else if constexpr (sizeof(T) == 4) {          // misaligned rows: 4-byte cp.async
        for (int q = lane; q < n * tl.width; q += 32) {
          const int r = q / tl.width, e = q - r * tl.width;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                       :: "r"(smem_addr(dst + r * tile_bytes + e * 4)), "l"(x + r * M + e)
                       : "memory");
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(smem_addr(&full[s])) : "memory");
      } else {                                        // misaligned 2-byte rows: plain loads,
        constexpr int BATCH = 8;                      // BATCH in flight a lane
        const int total = n * tl.width;
        for (int q0 = lane; q0 < total; q0 += 32 * BATCH) {
          T v[BATCH];
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            const int q = q0 + 32 * k;
            if (q < total) {
              const int r = q / tl.width;
              v[k] = x[r * M + (q - r * tl.width)];
            }
          }
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            const int q = q0 + 32 * k;
            if (q < total) {
              const int r = q / tl.width;
              reinterpret_cast<T*>(dst + r * tile_bytes)[q - r * tl.width] = v[k];
            }
          }
        }
        bar_arrive(&full[s]);                         // releases this lane's stores
      }
    }
    return;
  }

  // the consumers load the table while the first tiles come in
  for (int e = threadIdx.x; e < n * (deg + 1); e += CONSUMERS) sw[e] = w[e];
  for (int e = threadIdx.x; e < n * deg; e += CONSUMERS) {
    const int j = nbr[e];
    if (j < 0 || j >= n) __trap();
    soff[e] = j * tile_bytes;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");

  const int upr = tile_bytes / 16;                    // 16-byte units a row of a stage
  const int ushift = __ffs(upr) - 1;
  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int s = i % stages;
    const Tile tl = locate(L, t, leaf, tile_elems);
    T* out = static_cast<T*>(L.out[tl.leaf]) + tl.c0;
    const long long M = L.M[tl.leaf];
    const bool vstore = L.vstore[tl.leaf] != 0;
    const int valid = (tl.width + VEC - 1) / VEC;
    bar_wait(&full[s], (i / stages) & 1);
    const unsigned char* stage = ring + s * stage_bytes;
    for (int u = threadIdx.x; u < n * upr; u += CONSUMERS) {
      const int r = u >> ushift, v = u & (upr - 1);
      if (v >= valid) continue;
      const unsigned char* col = stage + v * 16;
      const float* wr = sw + r * (deg + 1);
      const int* off = soff + r * deg;
      float acc[VEC];
      alignas(16) T val[VEC];
      *reinterpret_cast<uint4*>(val) = *reinterpret_cast<const uint4*>(col + r * tile_bytes);
      add_products<T, VEC, true>(acc, val, wr[0]);
      if constexpr (DEG >= 0) {
        alignas(16) T nb[DEG > 0 ? DEG : 1][VEC];
#pragma unroll
        for (int d = 0; d < DEG; ++d) {
          *reinterpret_cast<uint4*>(nb[d]) = *reinterpret_cast<const uint4*>(col + off[d]);
        }
#pragma unroll
        for (int d = 0; d < DEG; ++d) add_products<T, VEC, false>(acc, nb[d], wr[d + 1]);
      } else {
        for (int d = 0; d < deg; ++d) {
          *reinterpret_cast<uint4*>(val) = *reinterpret_cast<const uint4*>(col + off[d]);
          add_products<T, VEC, false>(acc, val, wr[d + 1]);
        }
      }
      T* dst = out + r * M + v * VEC;
      const int left = tl.width - v * VEC;
      if (vstore && left >= VEC) {
        store<T, VEC>(dst, acc);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (k < left) dst[k] = from_f<T>(acc[k]);
        }
      }
    }
    __syncwarp();                                     // the warp is done reading `stage`
    if (lane == 0) bar_arrive(&empty[s]);
  }
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
void launch_witness(const void* x, const void* nbr, const void* w, void* out, int n,
                    long long M, int deg, int vector, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const size_t sm = smem_bytes(deg);
  if (vector) {
    const dim3 grid(n, static_cast<unsigned>(column_blocks(M, V)));
    gossip_mix_batched_witness_kernel<T, V><<<grid, THREADS, sm, s>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(w), static_cast<T*>(out), n, M, deg);
  } else {
    const dim3 grid(n, static_cast<unsigned>(column_blocks(M, 1)));
    gossip_mix_batched_witness_kernel<T, 1><<<grid, THREADS, sm, s>>>(
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

// The tiled kernel's shared memory; ops.py's gossip_plan counts the same.
long long tiles_smem(int n, int deg, int tile_bytes, int stages) {
  return static_cast<long long>(stages) * n * tile_bytes + 16LL * stages +
         4LL * n * (deg + 1) + 4LL * n * deg;
}

template <typename T, int DEG>
int launch_tiles_deg(const Leaves& L, const void* nbr, const void* w, int n, int deg,
                     int tile_bytes, int stages, int tiles, int blocks, int smem, int bulk,
                     cudaStream_t s) {
  // raise the dynamic shared-memory limit once a device, to what any call
  // may ask; a call made later, inside a CUDA graph capture, then sets nothing
  static bool opted[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = gossip_mix_tiles_kernel<T, DEG>;
  if (device < 0 || device >= 64 || !opted[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= 0 && device < 64) opted[device] = true;
  }
  kern<<<blocks, MIX_THREADS, smem, s>>>(L, static_cast<const int32_t*>(nbr),
                                         static_cast<const float*>(w), n, deg, tile_bytes,
                                         stages, tiles, bulk);
  return static_cast<int>(cudaGetLastError());
}

// deg 0…7 unrolled (the paths' degrees go up to the elastic deg_cap = 7),
// a runtime slot loop above.
template <typename T>
int launch_tiles(const Leaves& L, const void* nbr, const void* w, int n, int deg,
                 int tile_bytes, int stages, int tiles, int blocks, int smem, int bulk,
                 cudaStream_t s) {
  switch (deg) {
#define GOSSIP_DEG(D) \
    case D: return launch_tiles_deg<T, D>(L, nbr, w, n, deg, tile_bytes, stages, tiles, \
                                          blocks, smem, bulk, s);
    GOSSIP_DEG(0) GOSSIP_DEG(1) GOSSIP_DEG(2) GOSSIP_DEG(3)
    GOSSIP_DEG(4) GOSSIP_DEG(5) GOSSIP_DEG(6) GOSSIP_DEG(7)
#undef GOSSIP_DEG
    default:
      return launch_tiles_deg<T, -1>(L, nbr, w, n, deg, tile_bytes, stages, tiles, blocks,
                                     smem, bulk, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. vector: 1 when x, out (and nbrs)
// start 16-byte aligned and every row does too (M·size a multiple of 16).
int gossip_mix_batched_witness(const void* x, const void* nbr_idx, const void* w, void* out,
                               int n, long long M, int deg, int dtype, int vector,
                               void* stream) {
  if (n > 0 && M > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) launch_witness<float>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else if (dtype == 1) launch_witness<__nv_bfloat16>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else if (dtype == 2) launch_witness<__half>(x, nbr_idx, w, out, n, M, deg, vector, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `count` leaves of one dtype, each (n, Ms[l]) contiguous at xs[l] → outs[l],
// mixed over one table in one launch of `blocks` blocks. tile_end holds the
// prefix sums of the leaves' tiles of tile_bytes a row; bulk[l] and
// vstore[l] say whether leaf l's rows start 16-byte aligned in x and in out;
// bulk_route whether aligned rows come in by cp.async.bulk (1) or cp.async (0).
int gossip_mix_batched_leaves(const void* const* xs, void* const* outs, const long long* Ms,
                              const int* tile_end, const unsigned char* bulk,
                              const unsigned char* vstore, int count, const void* nbr_idx,
                              const void* w, int n, int deg, int tile_bytes, int stages,
                              int blocks, int bulk_route, int dtype, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (count < 1 || count > MAX_LEAVES || n < 1 || deg < 0 || blocks < 1 || stages < 2 ||
      tile_bytes < 16 || (tile_bytes & (tile_bytes - 1)) != 0 || dtype < 0 || dtype > 2 ||
      tiles_smem(n, deg, tile_bytes, stages) > SMEM_MAX || tile_bytes % size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Leaves L;
  for (int l = 0; l < MAX_LEAVES; ++l) {
    const bool in = l < count;
    L.x[l] = in ? xs[l] : nullptr;
    L.out[l] = in ? outs[l] : nullptr;
    L.M[l] = in ? Ms[l] : 0;
    L.tile_end[l] = tile_end[in ? l : count - 1];
    L.bulk[l] = in ? bulk[l] : 0;
    L.vstore[l] = in ? vstore[l] : 0;
  }
  const int tiles = tile_end[count - 1];
  if (tiles < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(tiles_smem(n, deg, tile_bytes, stages));
  if (dtype == 0) {
    return launch_tiles<float>(L, nbr_idx, w, n, deg, tile_bytes, stages, tiles, blocks, sm,
                               bulk_route, s);
  }
  if (dtype == 1) {
    return launch_tiles<__nv_bfloat16>(L, nbr_idx, w, n, deg, tile_bytes, stages, tiles,
                                       blocks, sm, bulk_route, s);
  }
  return launch_tiles<__half>(L, nbr_idx, w, n, deg, tile_bytes, stages, tiles, blocks, sm,
                              bulk_route, s);
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
