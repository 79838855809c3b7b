// decode_attention.cu — single-token GQA attention over a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_kernel (body _decode_attn_kernel)
// of src/repro/kernels/decode_attention/kernel.py. For every sequence b and
// query head hq (KV head h = hq / group):
//   s_t = q·k_t / √hd in float32, optionally softcap·tanh(s_t / softcap),
//   s_t = −1e30 where valid[t] is false,
//   out = Σ_t softmax(s)_t · v_t, divided by max(l, 1e-30), cast to q's dtype.
// The rank form (a rank's slice of a KV cache whose sequence is sharded over
// several ranks, merged across them afterwards) is a mode of the same
// kernel: given an `lse` pointer, the final combine writes the float32
// output and the row's log-sum-exp m + log l (natural units) instead of q's
// dtype's output, and the caller merges the ranks' rows.
// q (B, Hq, hd) contiguous; k, v (B, C, Hkv, hd) read as they lie through
// their strides (the head dimension contiguous, 16-byte aligned); valid (C,)
// bytes. f32, bf16 and f16; hd 32, 64, 80, 128, 256; any group Hq / Hkv.
//
// What bounds it on the H100: bytes. Each key costs 2·hd·size bytes of K and
// V against 4·group·hd flops, far under the card's balance, so the least
// time is the cache read once (valid keys only, q and the output once):
//   smollm-135m serving (B 16, C 2,184 with 2,113 valid, 9/3 heads, hd 64,
//   bf16): 26.0 MB -> 7.76 us at 3.35 TB/s;
//   gemma2-9b (B 4, C 4,224, ~4,096 valid in the window, 16/8 heads, hd 256,
//   bf16): 134 MB -> 40.1 us.
// The design keeps enough bytes in flight to cover HBM latency (~25 KB per
// SM at 3.35 TB/s), computes no padded head, and does it in one launch.
//
// Design.
// - A block serves one sequence b, `hb` KV heads and, of each, `qpb` chunks
//   of `GN` query heads (GN the largest divisor of the group up to 4, so a
//   group of 3 is 3 heads, of 6 two chunks of 3: no padding), for one key
//   range (a split). Every query head of the block reads the same K/V tile
//   from shared memory, so K/V come from device memory once per block.
// - Warp specialisation: the last warp is the producer, the others the
//   consumers. K/V tiles of KT keys x hb heads x hd stream through a ring
//   of `stages` shared-memory buffers (3 to 8), which the producer fills
//   with the bulk-copy engine (cp.async.bulk, the TMA's 1-D form) on a
//   `full` mbarrier per stage (expect_tx bytes); each consumer warp
//   arrives on the stage's `empty` mbarrier once its K/V are in registers,
//   and the producer waits for that before it refills the buffer. For one
//   b, a layer's (C, Hkv, hd) slice of the stacked cache is contiguous, so
//   when the block takes every KV head a tile is ONE copy for K and one
//   for V (mode 0); otherwise one copy per key (mode 1: heads contiguous)
//   or per key and head (mode 2), spread over the producer's 32 lanes.
// - q and the split's mask bytes are loaded before the first copy is
//   issued (loads behind the ring's megabytes would wait for them), the
//   mask into shared memory.
// - A consumer lane group of LPK lanes owns one key at a time (16 bytes of
//   K and V a lane), KPL = 4 keys a tile, reduces the q·k partials by
//   shuffles and keeps its own online softmax state (m, l, acc) for the GN
//   heads of its unit, rescaled once a tile. LPK is a power of two, so the
//   shuffles tile a warp: at a head dim of hd / (16 / size) 16-byte vectors
//   that is not one (hd 80: 10 in bf16, 20 in f32), LPK rounds up to the
//   next power of two (16, 32) and the lanes past the last vector hold
//   zeros for q, K and V and write nothing (the 160-byte bf16 row still
//   moves by 16-byte bulk copies). Scores are kept in log2 units
//   (q is scaled by log2(e)/√hd once), so each weight is one exp2f and no
//   score needs a division. The block merges its lane groups through
//   shared memory, a warp a row for the weights.
// - One launch: with several splits each block writes its partial (m, l,
//   acc) rows to a float32 workspace, and the last block of the (b, head
//   block) to finish — a ticket taken with atomicAdd after __threadfence —
//   merges every split's rows and writes the output (a warp a row, every
//   split's partials in flight at once, so the merge costs one round trip),
//   then resets the ticket to 0, so the next call and a CUDA-graph replay
//   find it zeroed.
// - Masking follows the TPU kernel's rule, which gives ref.py's answer: m
//   starts at −1e30 and masked scores are −1e30, so masked keys seen before
//   the first valid one add terms with p = 1 that the first valid key
//   multiplies by exp2(−1e30 − s) = 0; a row with no valid key averages its
//   C values with equal weights, as the reference's softmax of an all
//   −1e30 row does. Keys past the end of a tile score −inf and add nothing.
//
// The plan (kernels/decode_attention/ops.py, decode_plan) takes the head
// split whose busiest SM moves the fewest bytes, up to 320 consumer threads
// (128 at hd 256, where two blocks share an SM), stages to fill ~192 KB of
// shared memory (half the SM at hd 256), and splits for one full wave:
//   smollm-135m bf16 hd 64: GN 3, hb 3, LPK 8, 12 lane groups a head (288
//     consumers + the producer), KT 48 keys = 36.9 KB a stage, 5 stages,
//     8 splits x 16 = 128 blocks, one copy each for K and V a tile.
//   gemma2-9b bf16 hd 256: GN 2, hb 2, LPK 32, 2 lane groups a head (128
//     consumers), KT 8 keys = 16.4 KB a stage, 7 stages, 16 splits x 16
//     head blocks = 256 blocks, two an SM, one copy a key. f32: 32.8 KB a
//     stage, 3 stages.
//
// Plain C interface for ctypes: the entry checks that the current device is
// the tensors', launches on the given stream, never synchronises, and
// returns a CUDA error code (0 on success).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 320;       // consumer threads a block at most (hd ≤ 128)
constexpr int MAX_THREADS_256 = 128;   // at hd 256, where two blocks share an SM
__host__ __device__ constexpr int max_consumers(int hd) {
  return hd >= 256 ? MAX_THREADS_256 : MAX_THREADS;
}
constexpr int KPL = 4;                 // keys a lane group takes from each tile
constexpr int BAR_BYTES = 128;         // the full and empty mbarriers, before the mask
constexpr int MAX_STAGES = 8;
constexpr int SPLIT_LOADS = 8;        // partial rows a thread loads at once in the merge
constexpr int MASK_LOADS = 4;         // mask bytes a thread loads at once
constexpr float MASKED = -1e30f;

struct Params {
  int B, Hq, Hkv, C;
  long long k_sb, k_sc, k_sh, v_sb, v_sc, v_sh;   // strides in elements
  int qpb, hb, lgu, stages, splits, span, mode;
  float softcap;
  bool partial;                                   // the rank form: float32 out and lse
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// One output element: q's dtype, or float32 in the rank form.
template <typename T>
__device__ __forceinline__ void store_out(void* out, long long at, float val, bool partial) {
  if (partial) {
    static_cast<float*>(out)[at] = val;
  } else {
    static_cast<T*>(out)[at] = from_f<T>(val);
  }
}

// A row's log-sum-exp in natural units from its max M (log2 units) and its
// sum L of exp2(s - M). A row with no valid key keeps M = MASKED and sums
// its keys' equal weights: MASKED + log L, which is MASKED in float32, as
// the plain version's logsumexp of an all -1e30 row.
__device__ __forceinline__ float row_lse(float M, float L) {
  return M <= MASKED ? MASKED + logf(L) : M * 0.6931471805599453f + logf(L);
}

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

template <typename T, int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);                       // elements per 16 bytes
  static constexpr int NV = HD / VEC;                              // 16-byte vectors a row
  static constexpr int LPK = pow2_ceil(NV) < 32 ? pow2_ceil(NV) : 32;   // lanes per key
  static constexpr int EPL = (NV + LPK - 1) / LPK * VEC;           // elements per lane
  static constexpr int ACTIVE = HD / EPL;                          // lanes that hold elements
  static_assert(HD % VEC == 0 && HD % EPL == 0, "a row must split into whole lanes");
};

// N elements from 16-byte aligned memory (global through the read-only
// path, or shared) into float32 registers.
template <typename T, int N, bool GLOBAL>
__device__ __forceinline__ void load_vec(float (&dst)[N], const T* src) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < N / VEC; ++j) {
    alignas(16) T tmp[VEC];
    const uint4* p = reinterpret_cast<const uint4*>(src) + j;
    *reinterpret_cast<uint4*>(tmp) = GLOBAL ? __ldg(p) : *p;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[j * VEC + e] = to_f(tmp[e]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Shared memory the split's mask takes before the ring (128-byte aligned).
__host__ __device__ __forceinline__ int valid_bytes(int span) { return (span + 127) / 128 * 128; }

// The producer warp (all 32 lanes) fills ring buffer `stage` with the K and V of keys
// [t0, t0 + nk) for heads [h0, h0 + hb) of sequence b.
template <typename T, int HD>
__device__ __forceinline__ void issue_tile(const Params& P, const T* k, const T* v, T* sk, T* sv,
                                           uint64_t* bar, int b, int h0, int t0, int nk,
                                           int lane, bool refill) {
  const uint32_t row = static_cast<uint32_t>(P.hb) * HD * sizeof(T);   // one key's heads
  if (lane == 0) {
    // the consumers read the buffer through the generic proxy before this
    // async-proxy write into it
    if (refill) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(2u * nk * row) : "memory");
  }
  __syncwarp();
  const T* kb = k + b * P.k_sb + h0 * P.k_sh;
  const T* vb = v + b * P.v_sb + h0 * P.v_sh;
  if (P.mode == 0) {
    if (lane == 0) {
      bulk_copy(sk, kb + t0 * P.k_sc, nk * row, bar);
      bulk_copy(sv, vb + t0 * P.v_sc, nk * row, bar);
    }
  } else if (P.mode == 1) {
    for (int j = lane; j < nk; j += 32) {
      bulk_copy(sk + j * P.hb * HD, kb + (t0 + j) * P.k_sc, row, bar);
      bulk_copy(sv + j * P.hb * HD, vb + (t0 + j) * P.v_sc, row, bar);
    }
  } else {
    for (int i = lane; i < nk * P.hb; i += 32) {
      const int j = i / P.hb, h = i % P.hb;
      bulk_copy(sk + i * HD, kb + (t0 + j) * P.k_sc + h * P.k_sh, HD * sizeof(T), bar);
      bulk_copy(sv + i * HD, vb + (t0 + j) * P.v_sc + h * P.v_sh, HD * sizeof(T), bar);
    }
  }
}

// Grid (splits, B·HC): HC = (Hkv / hb)·(qcn / qpb) head blocks, qcn = group
// / GN. Dynamic shared memory: BAR_BYTES, the split's mask, then the ring
// (which the merges reuse as scratch).
template <typename T, int HD, int GN>
__global__ void __launch_bounds__(max_consumers(HD) + 32, HD >= 256 ? 2 : 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        void* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int* __restrict__ tickets,
                        const Params P) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* s_valid = smem + BAR_BYTES;               // the split's mask, span bytes
  T* ring = reinterpret_cast<T*>(smem + BAR_BYTES + valid_bytes(P.span));
  float* scratch = reinterpret_cast<float*>(ring);
  __shared__ int s_last;

  const int group = P.Hq / P.Hkv, qcn = group / GN;
  const int qblocks = qcn / P.qpb, HC = (P.Hkv / P.hb) * qblocks;
  const int split = blockIdx.x;
  const int b = blockIdx.y / HC, hc = blockIdx.y % HC;
  const int h0 = (hc / qblocks) * P.hb, qc0 = (hc % qblocks) * P.qpb;
  const int KT = KPL * P.lgu;
  const int tile_elems = KT * P.hb * HD;
  const int c_begin = split * P.span, c_end = min(P.C, c_begin + P.span);
  const int ntiles = c_begin < c_end ? (c_end - c_begin + KT - 1) / KT : 0;

  const int lane = threadIdx.x & 31;
  const int G = threadIdx.x / L::LPK, li = threadIdx.x % L::LPK;
  const int unit = G / P.lgu, lg = G % P.lgu;
  const int hl = unit / P.qpb;                       // KV head within the block
  const int qc = qc0 + unit % P.qpb;                 // query-head chunk within the group
  const int hq0 = (h0 + hl) * group + qc * GN;       // first query head of the unit
  const int e0 = li * L::EPL;
  const bool active = L::ACTIVE == L::LPK || li < L::ACTIVE;   // lanes past the row: zeros
  // scores in log2 units: q·k·log2(e)/√hd, so that p = exp2(s − m)
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  const float cap2 = P.softcap * 1.4426950408889634f;

  // Warp specialisation: the last warp of the block is the producer, which
  // only issues the ring's copies; the others (the consumers) compute.
  const int consumers = blockDim.x - 32;
  const bool producer = threadIdx.x >= consumers;
  uint64_t* full = bars;                              // a tile has landed: count 1 + bytes
  uint64_t* empty = bars + MAX_STAGES;                // every consumer warp is done with it

  // q and the split's mask first: loads issued after the ring's copies
  // would queue behind them and hold the first tile's compute back
  float qr[GN][L::EPL];
  if (!producer) {
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      if (active) {
        load_vec<T, L::EPL, true>(qr[g], q + (static_cast<long long>(b) * P.Hq + hq0 + g) * HD + e0);
      } else {
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) qr[g][e] = 0.f;
      }
    }
  }
  for (int t0 = 0; t0 < c_end - c_begin; t0 += MASK_LOADS * blockDim.x) {
    uint8_t vb[MASK_LOADS];
#pragma unroll
    for (int u = 0; u < MASK_LOADS; ++u) {
      const int t = t0 + u * blockDim.x + threadIdx.x;
      vb[u] = t < c_end - c_begin ? __ldg(valid + c_begin + t) : 0;
    }
#pragma unroll
    for (int u = 0; u < MASK_LOADS; ++u) {
      const int t = t0 + u * blockDim.x + threadIdx.x;
      if (t < c_end - c_begin) s_valid[t] = vb[u];
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(&empty[s])),
                   "r"(consumers / 32) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                                    // the barriers and s_valid are set

  float m[GN], l[GN], acc[GN][L::EPL];
  if (producer) {
    for (int i = 0; i < ntiles; ++i) {
      const int stage = i % P.stages;
      if (i >= P.stages) bar_wait(&empty[stage], (i / P.stages - 1) & 1);
      const int t0 = c_begin + i * KT;
      issue_tile<T, HD>(P, k, v, ring + 2 * stage * tile_elems,
                        ring + (2 * stage + 1) * tile_elems, &full[stage], b, h0, t0,
                        min(KT, c_end - t0), lane, i >= P.stages);
    }
  } else {
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      m[g] = MASKED;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        qr[g][e] *= qscale;
        acc[g][e] = 0.f;
      }
    }
    // the trip count is the same for every consumer, so the shuffles stay convergent
    for (int i = 0; i < ntiles; ++i) {
      const int stage = i % P.stages;
      const int t0 = c_begin + i * KT, nk = min(KT, c_end - t0);
      bool in[KPL], vis[KPL];
#pragma unroll
      for (int x = 0; x < KPL; ++x) {
        const int j = x * P.lgu + lg;
        in[x] = j < nk;
        vis[x] = in[x] && s_valid[t0 - c_begin + j] != 0;
      }
      bar_wait(&full[stage], (i / P.stages) & 1);
      const T* sk = ring + 2 * stage * tile_elems;
      const T* sv = sk + tile_elems;
      float kr[KPL][L::EPL], vr[KPL][L::EPL];
#pragma unroll
      for (int x = 0; x < KPL; ++x) {
        const int at = ((x * P.lgu + lg) * P.hb + hl) * HD + e0;
        if (in[x] && active) {
          load_vec<T, L::EPL, false>(kr[x], sk + at);
          load_vec<T, L::EPL, false>(vr[x], sv + at);
        } else {
#pragma unroll
          for (int e = 0; e < L::EPL; ++e) kr[x][e] = vr[x][e] = 0.f;
        }
      }
      __syncwarp();                                   // the warp is done reading `stage`
      if (lane == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(&empty[stage]))
                     : "memory");
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        float s[KPL];
        float smax = -INFINITY;
#pragma unroll
        for (int x = 0; x < KPL; ++x) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < L::EPL; ++e) dot = fmaf(qr[g][e], kr[x][e], dot);
#pragma unroll
          for (int off = L::LPK / 2; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          float sc = dot;
          if (cap2 != 0.f) sc = cap2 * tanhf(sc / cap2);
          if (!vis[x]) sc = MASKED;
          if (!in[x]) sc = -INFINITY;
          s[x] = sc;
          smax = fmaxf(smax, sc);
        }
        const float m_new = fmaxf(m[g], smax);
        const float corr = exp2f(m[g] - m_new);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int x = 0; x < KPL; ++x) {
          const float p = exp2f(s[x] - m_new);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < L::EPL; ++e) acc[g][e] = fmaf(p, vr[x][e], acc[g][e]);
        }
        m[g] = m_new;
      }
    }
  }
  __syncthreads();                                    // every tile is consumed: the ring is free

  // merge the lane groups of each unit
  const int nlg = consumers / L::LPK;
  float* sm_m = scratch;
  float* sm_l = sm_m + nlg * GN;
  float* sm_acc = sm_l + nlg * GN;
  if (!producer) {
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      if (li == 0) {
        sm_m[G * GN + g] = m[g];
        sm_l[G * GN + g] = l[g];
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) sm_acc[(G * GN + g) * HD + e0 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  // each row's max and its lane groups' weights once, then every output
  // element as a weighted sum of independent loads
  const int units = P.hb * P.qpb;
  const int rows = units * GN;
  float* sm_w = sm_acc + nlg * GN * HD;               // rows x lgu weights
  float* sm_M = sm_w + rows * P.lgu;                  // rows: max m
  float* sm_L = sm_M + rows;                          // rows: Σ l·w
  for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {   // a warp a row
    const int u = r / GN, g = r % GN;
    float M = MASKED;
    for (int j = lane; j < P.lgu; j += 32) M = fmaxf(M, sm_m[(u * P.lgu + j) * GN + g]);
    M = warp_max(M);
    float Ls = 0.f;
    for (int j = lane; j < P.lgu; j += 32) {
      const int at = (u * P.lgu + j) * GN + g;
      const float w = exp2f(sm_m[at] - M);
      sm_w[r * P.lgu + j] = w;
      Ls += sm_l[at] * w;
    }
    Ls = warp_sum(Ls);
    if (lane == 0) {
      sm_M[r] = M;
      sm_L[r] = Ls;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD;
    const int u = r / GN, g = r % GN;
    const float M = sm_M[r], Ls = sm_L[r];
    float A = 0.f;
    for (int j = 0; j < P.lgu; ++j) {
      A += sm_acc[((u * P.lgu + j) * GN + g) * HD + d] * sm_w[r * P.lgu + j];
    }
    const int hq = (h0 + u / P.qpb) * group + (qc0 + u % P.qpb) * GN + g;
    const long long row = static_cast<long long>(b) * P.Hq + hq;
    if (P.splits == 1) {
      store_out<T>(out, row * HD + d, A / fmaxf(Ls, 1e-30f), P.partial);
      if (P.partial && d == 0) lse[row] = row_lse(M, Ls);
    } else {
      const long long prow = row * P.splits + split;
      part_acc[prow * HD + d] = A;
      if (d == 0) {
        part_ml[2 * prow] = M;
        part_ml[2 * prow + 1] = Ls;
      }
    }
  }
  if (P.splits == 1) return;

  // The last split block of this (b, head block) to finish merges every
  // split. The barrier puts every thread's partial stores before thread 0's
  // __threadfence, which orders them (cumulatively) before its ticket; the
  // last ticket's holder fences again before the block reads the partials
  // (through L2, __ldcg).
  __syncthreads();
  int* ticket = tickets + blockIdx.y;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1) == P.splits - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  // A warp a row, a lane HD/32 of its elements: every split's (m, l) and
  // acc in flight at once (SPLIT_LOADS splits at a time, rescaled as they
  // come), so the merge costs one round trip for ≤ SPLIT_LOADS splits.
  constexpr int DPL = (HD + 31) / 32;                 // elements a lane (the last ones masked)
  const int ns = P.splits;
  for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {
    const int u = r / GN, g = r % GN;
    const long long row = static_cast<long long>(b) * P.Hq + (h0 + u / P.qpb) * group +
                          (qc0 + u % P.qpb) * GN + g;
    const float* ml = part_ml + 2 * row * ns;
    const float* pa = part_acc + row * ns * HD + lane;
    float M = MASKED, Ls = 0.f, A[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) A[t] = 0.f;
    for (int i0 = 0; i0 < ns; i0 += SPLIT_LOADS) {
      float pm[SPLIT_LOADS], pl[SPLIT_LOADS], pacc[SPLIT_LOADS][DPL];
#pragma unroll
      for (int x = 0; x < SPLIT_LOADS; ++x) {
        const bool ok = i0 + x < ns;
        pm[x] = ok ? __ldcg(ml + 2 * (i0 + x)) : MASKED;
        pl[x] = ok ? __ldcg(ml + 2 * (i0 + x) + 1) : 0.f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          pacc[x][t] = ok && lane + 32 * t < HD
                           ? __ldcg(pa + static_cast<long long>(i0 + x) * HD + 32 * t) : 0.f;
        }
      }
      float M_new = M;
#pragma unroll
      for (int x = 0; x < SPLIT_LOADS; ++x) M_new = fmaxf(M_new, pm[x]);
      const float corr = exp2f(M - M_new);
      Ls *= corr;
#pragma unroll
      for (int t = 0; t < DPL; ++t) A[t] *= corr;
#pragma unroll
      for (int x = 0; x < SPLIT_LOADS; ++x) {
        if (i0 + x < ns) {
          const float w = exp2f(pm[x] - M_new);
          Ls += pl[x] * w;
#pragma unroll
          for (int t = 0; t < DPL; ++t) A[t] += pacc[x][t] * w;
        }
      }
      M = M_new;
    }
    const float den = fmaxf(Ls, 1e-30f);
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      if (lane + 32 * t < HD) store_out<T>(out, row * HD + lane + 32 * t, A[t] / den, P.partial);
    }
    if (P.partial && lane == 0) lse[row] = row_lse(M, Ls);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <typename T, int HD, int GN>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           void* lse, void* part_ml, void* part_acc, void* tickets, const Params& P, int threads,
           int smem, int device, cudaStream_t s) {
  static int opted[64] = {};                    // shared memory opted in, per device
  auto kern = decode_attention_kernel<T, HD, GN>;
  if (smem > 48 * 1024 && device < 64 && smem > opted[device]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[device] = smem;
  }
  const int group = P.Hq / P.Hkv;
  const int HC = (P.Hkv / P.hb) * (group / GN / P.qpb);
  const dim3 grid(P.splits, P.B * HC);
  kern<<<grid, threads + 32, smem, s>>>(             // + the producer warp
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), out, static_cast<float*>(lse),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), static_cast<int*>(tickets), P);
  return 0;
}

template <typename T, int HD>
int dispatch_gn(int gn, const void* q, const void* k, const void* v, const void* valid,
                void* out, void* lse, void* part_ml, void* part_acc, void* tickets, const Params& P,
                int threads, int smem, int device, cudaStream_t s) {
  switch (gn) {
    case 1: return launch<T, HD, 1>(q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                    threads, smem, device, s);
    case 2: return launch<T, HD, 2>(q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                    threads, smem, device, s);
    case 3: return launch<T, HD, 3>(q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                    threads, smem, device, s);
    case 4: return launch<T, HD, 4>(q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                    threads, smem, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_hd(int hd, int gn, const void* q, const void* k, const void* v, const void* valid,
                void* out, void* lse, void* part_ml, void* part_acc, void* tickets, const Params& P,
                int threads, int smem, int device, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_gn<T, 32>(gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                       threads, smem, device, s);
    case 64: return dispatch_gn<T, 64>(gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                       threads, smem, device, s);
    case 80: return dispatch_gn<T, 80>(gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                                       threads, smem, device, s);
    case 128: return dispatch_gn<T, 128>(gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets,
                                         P, threads, smem, device, s);
    case 256: return dispatch_gn<T, 256>(gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets,
                                         P, threads, smem, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// plan: 20 int64 — B, Hq, Hkv, hd, C, the three K strides and the three V
// strides (elements), dtype (0 float32, 1 bfloat16, 2 float16), gn, qpb,
// hb, lgu, stages, splits, span, copy mode, threads, shared-memory bytes.
// part_ml (B·Hq·splits, 2) and part_acc (B·Hq·splits, hd) float32 are
// scratch and tickets (B·HC) int32 is zero on entry and left zero; all
// three are read only when splits > 1. With lse non-null (the rank form)
// out is float32 (B, Hq, hd) and lse float32 (B, Hq) gets each row's
// log-sum-exp; with lse null out is q's dtype.
int decode_attention(const void* q, const void* k, const void* v, const void* valid, void* out,
                     void* lse, void* part_ml, void* part_acc, void* tickets, const long long* plan,
                     float softcap, int device, void* stream) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  Params P;
  P.B = static_cast<int>(plan[0]);
  P.Hq = static_cast<int>(plan[1]);
  P.Hkv = static_cast<int>(plan[2]);
  const int hd = static_cast<int>(plan[3]);
  P.C = static_cast<int>(plan[4]);
  P.k_sb = plan[5];
  P.k_sc = plan[6];
  P.k_sh = plan[7];
  P.v_sb = plan[8];
  P.v_sc = plan[9];
  P.v_sh = plan[10];
  const int dtype = static_cast<int>(plan[11]);
  const int gn = static_cast<int>(plan[12]);
  P.qpb = static_cast<int>(plan[13]);
  P.hb = static_cast<int>(plan[14]);
  P.lgu = static_cast<int>(plan[15]);
  P.stages = static_cast<int>(plan[16]);
  P.splits = static_cast<int>(plan[17]);
  P.span = static_cast<int>(plan[18]);
  P.mode = static_cast<int>(plan[19]);
  const int threads = static_cast<int>(plan[20]);
  const int smem = static_cast<int>(plan[21]);
  P.softcap = softcap;
  P.partial = lse != nullptr;
  if (P.B <= 0 || P.Hq <= 0 || P.C <= 0) return 0;
  if (P.Hkv <= 0 || P.Hq % P.Hkv != 0 || gn < 1 || (P.Hq / P.Hkv) % gn != 0 || P.hb < 1 ||
      P.Hkv % P.hb != 0 || P.qpb < 1 || (P.Hq / P.Hkv / gn) % P.qpb != 0 || P.lgu < 1 ||
      P.stages < 1 || P.stages > MAX_STAGES || P.splits < 1 || P.span < 1 ||
      static_cast<long long>(P.splits) * P.span < P.C || threads < 32 ||
      threads > max_consumers(hd) || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_hd<float>(hd, gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                             threads, smem, device, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(hd, gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets,
                                     P, threads, smem, device, s);
  } else if (dtype == 2) {
    err = dispatch_hd<__half>(hd, gn, q, k, v, valid, out, lse, part_ml, part_acc, tickets, P,
                              threads, smem, device, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
