// Blocked online-softmax attention: causal, sliding window, GQA, q_offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).  The TPU runs a (batch*q_heads, q_blocks, kv_blocks)
// grid with kv innermost and carries the (bq, d) accumulator and the running
// max and denominator from one grid step to the next in VMEM scratch.  On
// this card the blocks run in parallel in no order, so one block owns one
// (batch*q_head, 64 query rows) tile and walks the kv tiles itself, with the
// carry in registers.  GQA is folded in the index: query head h reads kv
// head h / (Hq / Hkv), and no repeated K/V is ever materialized.
//
// Arithmetic, as the reference's: q, k and v are read in their storage type
// (f32, bf16 or f16) and every product, the scale, the masks, exp and the
// running sums are f32 (expf, not __expf).  A masked score is -1e30 and its
// p is set to 0 explicitly; a row that sees no unmasked key writes 0.  The
// output is rounded once to q's type.
//
// What bounds it on this card: the operations.  At the serving shapes
// (zamba2's shared block, 32 heads of 64, a causal prompt of L tokens) the
// work is 2 * 2 * L^2/2 * 64 FLOP a head against 4 * L * 64 elements of
// traffic, so for L > ~100 the f32 rate, and not the 3.35 TB/s, is the
// limit.  The tensor cores would lift that bound, but they multiply bf16
// operands: p would have to be rounded to bf16 before P.V, which the
// reference does not do.  So this first kernel stays on the f32 FMA units
// and keeps the reference's numbers; the design spends its effort on
// feeding them: Q, K and V tiles are staged as f32 in shared memory (rows
// padded to an odd stride, so the strided reads hit distinct banks), and
// each thread holds a 4 x 8 block of scores and a 4 x D/8 block of the
// output in registers, so every shared-memory read feeds 2-4 FMAs.  Tiles
// that the causal or window frontier masks entirely are skipped, which is
// what keeps windowed attention O(L * window).  wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // 16 row groups of 4 rows x 8 column lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Reduce over the 8 lanes of one row group (contiguous lanes).
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// NC: output columns a thread keeps (8 * NC >= D).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Lq, int Lkv, int D, int causal, int window,
                       int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = D | 1;                 // odd row stride: conflict-free
  constexpr int LDP = BK + 1;
  float* Qs = smem;                     // BQ x ld
  float* Ks = Qs + BQ * ld;             // BK x ld
  float* Vs = Ks + BK * ld;             // BK x ld
  float* Ps = Vs + BK * ld;             // BQ x LDP

  const int bh = blockIdx.y;            // b * Hq + h
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int i0 = blockIdx.x * BQ;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)kvh * Lkv * D;
  const T* vp = v + (size_t)kvh * Lkv * D;
  T* op = o + (size_t)bh * Lq * D;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    Qs[r * ld + d] = i0 + r < Lq ? to_f32(qp[(size_t)(i0 + r) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // Global positions of this block's first and last real query row.
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + BQ, Lq) - 1;
  const int n_tiles = (Lkv + BK - 1) / BK;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv_lo = jt * BK;
    // The block frontier: skip tiles no query row of this block can see.
    if (causal && kv_lo > q_hi) break;
    if (window > 0 && kv_lo + BK - 1 <= q_lo - window) continue;

    __syncthreads();                    // the last tile's reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      const bool in = kv_lo + r < Lkv;
      const size_t g = (size_t)(kv_lo + r) * D + d;
      Ks[r * ld + d] = in ? to_f32(kp[g]) : 0.0f;
      Vs[r * ld + d] = in ? to_f32(vp[g]) : 0.0f;
    }
    __syncthreads();

    // Scores: rows ty*4 + i, keys tx + 8*c.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[(tx + 8 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // Masks and the online softmax, row by row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + ty * 4 + i;
      unsigned keep = 0;
      float row_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kv_pos = kv_lo + tx + 8 * c;
        const bool ok = kv_pos < Lkv && (!causal || q_pos >= kv_pos) &&
                        (window <= 0 || q_pos - kv_pos < window);
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        keep |= (unsigned)ok << c;
        row_max = fmaxf(row_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      float p_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = (keep >> c) & 1u ? expf(s[i][c] - m_new) : 0.0f;
        Ps[(ty * 4 + i) * LDP + tx + 8 * c] = p;
        p_sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + group_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, output columns tx + 8*c.
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 8 * c;
        const float vv = d < D ? Vs[j * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < D) op[(size_t)r * D + d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Lq, int Lkv, int D, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int ld = D | 1;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * ld + BQ * (BK + 1));
  auto kern = flash_attention_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Lq, Lkv, D,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Lq, int Lkv, int D, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lkv <= 0 ||
      D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Lq, Lkv, D, causal, window,
                        q_offset, scale, stream);
  return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Lq, Lkv, D, causal, window,
                       q_offset, scale, stream);
}

}  // namespace

extern "C" {

// q: (B, Hq, Lq, D), k and v: (B, Hkv, Lkv, D), o: (B, Hq, Lq, D), all
// contiguous and of one type; D <= 128, Hq % Hkv == 0.  causal: 0 or 1;
// window: <= 0 for none; q_offset: global position of query row 0.
#define FLASH_ENTRY(name, T)                                                   \
  int name(const void* q, const void* k, const void* v, void* o, int B,        \
           int Hq, int Hkv, int Lq, int Lkv, int D, int causal, int window,    \
           int q_offset, float scale, cudaStream_t stream) {                   \
    return dispatch<T>(q, k, v, o, B, Hq, Hkv, Lq, Lkv, D, causal, window,     \
                       q_offset, scale, stream);                               \
  }
FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
FLASH_ENTRY(flash_attention_f16, __half)
#undef FLASH_ENTRY

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
