// decode_attention.cu — single-token GQA attention over a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_kernel (body _decode_attn_kernel)
// of src/repro/kernels/decode_attention/kernel.py. For every sequence b and
// query head hq (KV head h = hq / group):
//   s_t = q·k_t / √hd in float32, optionally softcap·tanh(s_t / softcap),
//   s_t = −1e30 where valid[t] is false,
//   out = Σ_t softmax(s)_t · v_t, divided by max(l, 1e-30), cast to q's dtype.
// q (B, Hq, hd) contiguous; k, v (B, C, Hkv, hd) read as they lie through
// their strides (the head dimension contiguous); valid (C,) bytes.
//
// What bounds it on the H100: bytes. Each key costs 2·hd·size bytes of K and
// V against about 4·group·hd flops, far under the card's balance, so the
// least time is the cache read once: at smollm-135m's serving shape
// (B 16, C 2184, Hkv 3, hd 64, bf16) 26.8 MB, 8.0 µs at 3.35 TB/s.
//
// Design.
// - No copy of the cache. The TPU wrapper pads C to a multiple of 512 and
//   transposes K and V to (B, Hkv, C, hd), two full copies per call; here
//   the kernel reads the cache in place and stops at C itself.
// - Blocks run in no order, so the TPU's sequential KV grid axis becomes a
//   loop inside the block, and the keys of one (b, h) are split over
//   `splits` blocks (flash-decoding) so that B·Hkv = 48 pairs still fill the
//   132 SMs; a second small kernel merges the splits' (m, l, acc).
// - Inside a block, a lane group of LPK lanes owns one key at a time: each
//   lane loads 16 bytes of K and V (hd/LPK elements), the group reduces the
//   q·k partials by shuffles, and keeps its own running (m, l, acc) for up to
//   four query heads of the KV head. The block merges its lane groups through
//   shared memory at the end.
// - Masking follows the TPU kernel's rule, which gives ref.py's answer: m
//   starts at −1e30 and masked scores are −1e30, so masked keys seen before
//   the first valid one add terms with p = 1 that the first valid key
//   multiplies by exp(−1e30 − s) = 0; a split, or a whole row, with no valid
//   key averages its values with equal weights, as the reference's softmax
//   of an all −1e30 row does.
// A simple kernel: no TMA, no wgmma (the work is a few flops per byte).
//
// Plain C interface for ctypes: launches on the given stream, never
// synchronises, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 4;        // query heads per block (the rest go to other blocks)
constexpr int UNROLL = 2;      // keys in flight per lane group
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <typename T, int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);                       // elements per 16 bytes
  static constexpr int LPK = HD / VEC < 32 ? HD / VEC : 32;        // lanes per key
  static constexpr int EPL = HD / LPK;                             // elements per lane
  static constexpr int NV = EPL / VEC;                             // 16-byte loads per lane
  static constexpr int KPW = 32 / LPK;                             // keys per warp
  static constexpr int NLG = WARPS * KPW;                          // lane groups per block
};

template <typename T, int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const T* src) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < N / VEC; ++j) {
    alignas(16) T tmp[VEC];
    *reinterpret_cast<uint4*>(tmp) = __ldg(reinterpret_cast<const uint4*>(src) + j);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[j * VEC + e] = to_f(tmp[e]);
  }
}

// Grid (splits, B·Hkv, query-head chunks). Each block serves the keys
// [split·span, min(C, (split+1)·span)) of one (b, h) for `gn` query heads
// starting at g0 within the group. With splits == 1 it writes `out`; else
// its (m, l) to part_ml and acc to part_acc, row ((b·Hq + hq)·splits + split).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        T* __restrict__ out, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int Hq, int Hkv, int C,
                        long long k_sb, long long k_sc, long long k_sh, long long v_sb,
                        long long v_sc, long long v_sh, float softcap, int gpb) {
  using L = Layout<T, HD>;
  __shared__ float sm_m[L::NLG][GMAX];
  __shared__ float sm_l[L::NLG][GMAX];
  __shared__ float sm_acc[L::NLG][GMAX][HD];

  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  const int g0 = blockIdx.z * gpb;
  const int gn = min(gpb, group - g0);
  const int span = (C + splits - 1) / splits;
  const int c_begin = split * span, c_end = min(C, c_begin + span);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % L::LPK;
  const int lg = warp * L::KPW + lane / L::LPK;
  const int e0 = li * L::EPL;
  const float rsq = sqrtf(static_cast<float>(HD));

  float qr[GMAX][L::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < gn) {
      load_row<T, L::EPL>(qr[g], q + (static_cast<long long>(b) * Hq + h * group + g0 + g) * HD + e0);
    } else {
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GMAX], l[GMAX], acc[GMAX][L::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = MASKED;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * k_sb + h * k_sh + e0;
  const T* vb = v + b * v_sb + h * v_sh + e0;
  // the trip count is the same for every lane, so the shuffles stay convergent
  for (int base = c_begin; base < c_end; base += UNROLL * L::NLG) {
    float kr[UNROLL][L::EPL], vr[UNROLL][L::EPL];
    bool ok[UNROLL], vis[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * L::NLG + lg;
      ok[u] = t < c_end;
      if (ok[u]) {
        load_row<T, L::EPL>(kr[u], kb + t * k_sc);
        load_row<T, L::EPL>(vr[u], vb + t * v_sc);
        vis[u] = valid[t] != 0;
      } else {
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
        vis[u] = false;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
        // every lane takes part in the shuffles, in range or not
#pragma unroll
        for (int off = L::LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (!ok[u] || g >= gn) continue;
        float s = dot / rsq;
        if (softcap != 0.f) s = softcap * tanhf(s / softcap);
        if (!vis[u]) s = MASKED;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) acc[g][e] = acc[g][e] * corr + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  // merge the lane groups of the block
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (li == 0) {
      sm_m[lg][g] = m[g];
      sm_l[lg][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) sm_acc[lg][g][e0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * HD; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    float M = MASKED;
    for (int j = 0; j < L::NLG; ++j) M = fmaxf(M, sm_m[j][g]);
    float Ls = 0.f, A = 0.f;
    for (int j = 0; j < L::NLG; ++j) {
      const float w = expf(sm_m[j][g] - M);
      Ls += sm_l[j][g] * w;
      A += sm_acc[j][g][d] * w;
    }
    const long long row = static_cast<long long>(b) * Hq + h * group + g0 + g;
    if (splits == 1) {
      out[row * HD + d] = from_f<T>(A / fmaxf(Ls, 1e-30f));
    } else {
      const long long prow = row * splits + split;
      part_acc[prow * HD + d] = A;
      if (d == 0) {
        part_ml[2 * prow] = M;
        part_ml[2 * prow + 1] = Ls;
      }
    }
  }
}

// One block per (b, hq) row, one thread per element of the head dimension:
// the splits' partial softmax states merged as the lane groups were.
template <typename T>
__global__ void decode_attention_merge(const float* __restrict__ part_ml,
                                       const float* __restrict__ part_acc,
                                       T* __restrict__ out, int splits, int hd) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * row * splits;
  float M = MASKED;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, ml[2 * i]);
  float Ls = 0.f, A = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float w = expf(ml[2 * i] - M);
    Ls += ml[2 * i + 1] * w;
    A += part_acc[(row * splits + i) * hd + d] * w;
  }
  out[row * hd + d] = from_f<T>(A / fmaxf(Ls, 1e-30f));
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* valid, void* out,
            void* part_ml, void* part_acc, int B, int Hq, int Hkv, int C, long long k_sb,
            long long k_sc, long long k_sh, long long v_sb, long long v_sc, long long v_sh,
            float softcap, int splits, cudaStream_t s) {
  const int group = Hq / Hkv;
  const int chunks = (group + GMAX - 1) / GMAX;
  const int gpb = (group + chunks - 1) / chunks;
  const dim3 grid(splits, B * Hkv, chunks);
  decode_attention_kernel<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), Hq, Hkv, C, k_sb, k_sc,
      k_sh, v_sb, v_sc, v_sh, softcap, gpb);
  if (splits > 1) {
    decode_attention_merge<T><<<B * Hq, HD, 0, s>>>(
        static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
        static_cast<T*>(out), splits, HD);
  }
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* valid,
                void* out, void* part_ml, void* part_acc, int B, int Hq, int Hkv, int C,
                long long k_sb, long long k_sc, long long k_sh, long long v_sb, long long v_sc,
                long long v_sh, float softcap, int splits, cudaStream_t s) {
  if (hd == 32) {
    launch<T, 32>(q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb, k_sc, k_sh,
                  v_sb, v_sc, v_sh, softcap, splits, s);
  } else if (hd == 64) {
    launch<T, 64>(q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb, k_sc, k_sh,
                  v_sb, v_sc, v_sh, softcap, splits, s);
  } else if (hd == 128) {
    launch<T, 128>(q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb, k_sc, k_sh,
                   v_sb, v_sc, v_sh, softcap, splits, s);
  } else if (hd == 256) {
    launch<T, 256>(q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb, k_sc, k_sh,
                   v_sb, v_sc, v_sh, softcap, splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike). Strides
// are in elements. part_ml (B·Hq·splits, 2) and part_acc (B·Hq·splits, hd)
// float32 are scratch, read only when splits > 1.
int decode_attention(const void* q, const void* k, const void* v, const void* valid, void* out,
                     void* part_ml, void* part_acc, int B, int Hq, int Hkv, int hd, int C,
                     long long k_sb, long long k_sc, long long k_sh, long long v_sb,
                     long long v_sc, long long v_sh, float softcap, int splits, int dtype,
                     void* stream) {
  if (B <= 0 || Hq <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 || splits < 1 || B * Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_hd<float>(hd, q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb,
                             k_sc, k_sh, v_sb, v_sc, v_sh, softcap, splits, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C,
                                     k_sb, k_sc, k_sh, v_sb, v_sc, v_sh, softcap, splits, s);
  } else if (dtype == 2) {
    err = dispatch_hd<__half>(hd, q, k, v, valid, out, part_ml, part_acc, B, Hq, Hkv, C, k_sb,
                              k_sc, k_sh, v_sb, v_sc, v_sh, softcap, splits, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
