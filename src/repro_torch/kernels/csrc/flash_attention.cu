// Blocked online-softmax attention: causal, sliding window, GQA, q_offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).  The TPU runs a (batch*q_heads, q_blocks, kv_blocks)
// grid with kv innermost and carries the (bq, d) accumulator and the running
// max and denominator from one grid step to the next in VMEM scratch.  On
// this card the blocks run in parallel in no order, so one block owns one
// (batch*q_head, 64 query rows) tile and walks the kv tiles itself, with the
// carry in registers.  GQA is folded in the index: query head h reads kv
// head h / (Hq / Hkv), and no repeated K/V is ever materialized.  Tiles that
// the causal or window frontier masks for the whole block are skipped,
// which keeps windowed attention O(L * window).
//
// The reference's arithmetic: every product, the scale, the masks, exp and
// the running sums are f32 (expf, not __expf).  A masked score is -1e30 and
// its p is set to 0 explicitly; a row that sees no unmasked key writes 0.
// The output is rounded once to q's type.
//
// What bounds it on this card: the operations.  At the serving shapes
// (zamba2's shared block, 32 heads of 64, a causal prompt of L tokens) the
// work is 2 * 2 * L^2/2 * 64 FLOP a head against 4 * L * 64 elements of
// traffic, so for L > ~100 the arithmetic, and not the 3.35 TB/s, is the
// limit, and only the tensor cores lift it.  Two kernels:
//
// * bf16 (serving): mma.sync m16n8k16 bf16 x bf16 -> f32 on the tensor
//   cores, FlashAttention-2's layout.  Four warps of 16 query rows; Q, K and
//   V stay bf16 in shared memory (D zero-padded to a multiple of 16, rows
//   padded by 8 so that ldmatrix hits distinct banks); K and V tiles of 64
//   keys are double-buffered with cp.async.  A bf16 x bf16 product is exact
//   in f32, so QK^T with f32 accumulation differs from the reference only
//   in summation order.  The reference keeps p in f32 for PV; one rounding
//   of p to bf16 breaks the check of one bf16 ulp + 1e-5 of max|v|.  So p is
//   split, p_hi = bf16(p), p_lo = bf16(p - p_hi), and PV = P_hi V + P_lo V,
//   two mma against one V fragment: for p in [2^e, 2^(e+1)) |p - p_hi| <=
//   2^(e-8), so |p - p_hi - p_lo| <= 2^(e-17) <= 2^-17 p, and after the
//   division by l the error is at most 2^-17 max|v| (7.6e-6), under the
//   check's 1e-5.  P never leaves registers: the f32 C fragment of the
//   score mma is the A fragment of the PV mma.  l is the f32 sum of the
//   unsplit p, as the reference's.
//   Beyond the mma, the time goes to the instructions of each pair (expf
//   alone is 8, the split 3), so the design keeps them few: a tile that
//   every row of a warp sees in full skips the masks (a template instance
//   with no test a pair); a masked p is expf(-inf) = 0, a select on the
//   argument, so the expf stay free of branches; the accumulator is
//   rescaled only when a row's max moved; and the query blocks that see the
//   most causal tiles are launched first, which keeps the tail short.
// * f32 and f16: the f32 FMA units.  f32 has no exact tensor-core form, and
//   f16 cannot take the split: p_lo of a small p is subnormal in f16, which
//   breaks the bound.  Q, K and V tiles are staged as f32 in shared memory
//   (rows padded to an odd stride, conflict-free), and each thread holds a
//   4 x 8 block of scores and a 4 x D/8 block of the output in registers, so
//   every shared-memory read feeds 2-4 FMAs.
//
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // FMA: 16 row groups of 4 rows x 8 lanes;
                              // mma: 4 warps of 16 rows
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two p of one row, split into bf16 halves packed for the PV A fragment
// (the lower column in the low 16 bits): p0 - hi is exact in f32, and
// lo = bf16(p - hi) leaves |p - hi - lo| <= 2^-17 p.
__device__ __forceinline__ void split_pack(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// The 64 rows of an (L, D) matrix from src (row r0) into a 64 x DP tile
// of stride DP + 8, zero past its `rows` = L - r0 real rows and past D.
// vec: D % 8 == 0 and a 16-byte aligned base, so every 16-byte chunk is
// all in or all out and goes by cp.async, KD chunks a thread at offsets
// that do not change from tile to tile; otherwise element by element (any
// D).
template <int KD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows,
                                          int D, bool vec, int tid) {
  constexpr int DP = 16 * KD, LDS = DP + 8, CH = DP / 8;
  if (vec) {
#pragma unroll
    for (int i = 0; i < KD; ++i) {      // BK * CH == KD * THREADS chunks
      const int c = tid + i * THREADS;
      const int r = c / CH, col = (c - r * CH) * 8;
      const bool in = r < rows && col < D;
      cp_async16(smem_addr(dst + r * LDS + col), in ? src + r * D + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int r = e / DP, col = e - r * DP;
      dst[r * LDS + col] =
          r < rows && col < D ? src[r * D + col] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The online softmax of one tile.  s holds a thread's 32 scores of rows
// g and g + 8 (element e of key block j: row g + 8 * (e >> 1), key
// 8j + 2t + (e & 1)) and leaves with their p.  MASKED: bit 4j + e of keep
// says whether the pair is unmasked; a masked score is -1e30 and its p is
// 0, as expf(-inf): the select is on the argument, so the 32 expf stay
// free of branches.  Otherwise every pair is kept and nothing is tested.
template <bool MASKED, int NT>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], unsigned keep,
                                               float scale, float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[NT][4]) {
  float mx[2] = {NEG_INF, NEG_INF}, corr[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !MASKED || ((keep >> (4 * j + e)) & 1u);
      s[j][e] = ok ? s[j][e] * scale : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
  // Rescale only when some row's max moved (a product by 1 is exact).
  if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !MASKED || ((keep >> (4 * j + e)) & 1u);
      const float p = expf(ok ? s[j][e] - m[e >> 1] : -INFINITY);
      s[j][e] = p;
      l[e >> 1] += p;
    }
}

// KD: 16-wide steps over the head dim (DP = 16 * KD >= D).  Warp w owns
// query rows 16w..16w+15 of the block; in every m16n8 fragment lane holds
// rows g = lane/4 and g + 8, columns 2t, 2t + 1 (t = lane % 4).
template <int KD>
__global__ void __launch_bounds__(THREADS)
flash_attention_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int Hq, int Hkv, int Lq, int Lkv, int D, int causal,
                         int window, int q_offset, float scale, int vec) {
  constexpr int DP = 16 * KD, LDS = DP + 8, TILE = BK * LDS, NT = DP / 8;
  static_assert(BQ == BK, "one tile shape for Q, K and V");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;                 // two stages
  bf16* Vs = Ks + 2 * TILE;             // two stages

  // Grid (batch * q_heads, query blocks), the query blocks in reverse on
  // the slow axis: the last blocks of every head see the most causal
  // tiles, and they start first (longest first keeps the tail short).
  const int bh = blockIdx.x;            // b * Hq + h
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* qp = q + (size_t)bh * Lq * D;
  const bf16* kp = k + (size_t)kvh * Lkv * D;
  const bf16* vp = v + (size_t)kvh * Lkv * D;
  bf16* op = o + (size_t)bh * Lq * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // The block frontier: the kv tiles some query row of this block sees.
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + BQ, Lq) - 1;
  int jt_end = (Lkv + BK - 1) / BK;
  if (causal) jt_end = min(jt_end, q_hi / BK + 1);
  const int jt_begin =
      window > 0 && q_lo - window >= 0 ? (q_lo - window + 1) / BK : 0;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const int wq_lo = q_lo + warp * 16;       // the warp's first row
  const int qpos0 = wq_lo + g;              // global position of row g

  if (jt_begin < jt_end) {
    const size_t first = (size_t)jt_begin * BK * D;
    load_tile<KD>(Qs, qp + (size_t)i0 * D, Lq - i0, D, vec, tid);
    load_tile<KD>(Ks, kp + first, Lkv - jt_begin * BK, D, vec, tid);
    load_tile<KD>(Vs, vp + first, Lkv - jt_begin * BK, D, vec, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[kk], smem_addr(Qs + (warp * 16 + (lane & 15)) * LDS +
                                kk * 16 + (lane >> 4) * 8));
    // Each lane's ldmatrix row in stage 0: K by key blocks (x4 = two
    // blocks of 8 keys, both 8-column halves), V transposed (16 keys, two
    // 8-column blocks).
    const uint32_t k_lane = smem_addr(
        Ks + ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8);
    const uint32_t v_lane = smem_addr(
        Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8);
    constexpr uint32_t STAGE = TILE * sizeof(bf16);

#pragma unroll 1
    for (int jt = jt_begin; jt < jt_end; ++jt) {
      const int st = (jt - jt_begin) & 1;
      if (jt + 1 < jt_end) {            // the next tile loads meanwhile
        const size_t next = (size_t)(jt + 1) * BK * D;
        const int rows = Lkv - (jt + 1) * BK;
        load_tile<KD>(Ks + (st ^ 1) * TILE, kp + next, rows, D, vec, tid);
        load_tile<KD>(Vs + (st ^ 1) * TILE, vp + next, rows, D, vec, tid);
        cp_async_commit();
      }
      const uint32_t kt = k_lane + st * STAGE, vt = v_lane + st * STAGE;

      // S = Q K^T: 16 rows x 64 keys a warp, key block j = keys 8j..8j+7.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t kf[4];
          ldsm_x4(kf, kt + (jp * 16 * LDS + kk * 16) * sizeof(bf16));
          mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // Masks in global positions.  A tile whose 64 keys every one of the
      // warp's 16 rows sees is kept whole, with no test a pair.
      const int kv0 = jt * BK;
      const bool full = kv0 + BK <= Lkv &&
                        (!causal || kv0 + BK - 1 <= wq_lo) &&
                        (window <= 0 || wq_lo + 15 - kv0 < window);
      if (full) {
        online_softmax<false>(s, 0u, scale, m, l, acc);
      } else {
        unsigned keep = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = qpos0 + 8 * (e >> 1);
            const int kpos = kv0 + 8 * j + 2 * t + (e & 1);
            const bool ok = kpos < Lkv && (!causal || qpos >= kpos) &&
                            (window <= 0 || qpos - kpos < window);
            keep |= (unsigned)ok << (4 * j + e);
          }
        online_softmax<true>(s, keep, scale, m, l, acc);
      }

      // acc += P_hi V + P_lo V over 4 steps of 16 keys; P from registers.
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ph[4], pl[4];
        split_pack(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
        split_pack(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
        split_pack(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
        split_pack(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, vt + (ks * 16 * LDS + dp * 16) * sizeof(bf16));
          mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }

      cp_async_wait_all();              // the next tile has landed
      __syncthreads();                  // and this one is read by all
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = i0 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    const float denom = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        op[(size_t)row * D + col] = __float2bfloat16_rn(acc[n][2 * r] / denom);
      if (col + 1 < D)
        op[(size_t)row * D + col + 1] =
            __float2bfloat16_rn(acc[n][2 * r + 1] / denom);
    }
  }
}

// Q, then K and V in two stages each: five 64-row tiles of stride DP + 8.
template <int KD>
constexpr size_t smem_bf16 = sizeof(bf16) * 5 * BK * (16 * KD + 8);

// The one D -> KD table: calls f(std::integral_constant<int, KD>) with
// KD = ceil(D / 16), for D in 1..128.
template <typename F>
int with_kd(int D, F&& f) {
  switch ((D + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                  int Hq, int Hkv, int Lq, int Lkv, int D, int causal,
                  int window, int q_offset, float scale, cudaStream_t stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lkv <= 0 ||
      D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  if ((Lq + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = D % 8 == 0 && addr % 16 == 0;
  return with_kd(D, [&](auto kd) {
    constexpr int KD = decltype(kd)::value;
    const size_t smem = smem_bf16<KD>;
    auto kern = flash_attention_bf16_mma<KD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * Hq, (Lq + BQ - 1) / BQ);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Lq, Lkv,
        D, causal, window, q_offset, scale, vec);
    return (int)cudaGetLastError();
  });
}

int attributes_bf16(int D, int* regs, int* smem_bytes, int* blocks_per_sm) {
  if (D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
  return with_kd(D, [&](auto kd) {
    constexpr int KD = decltype(kd)::value;
    const size_t smem = smem_bf16<KD>;
    auto kern = flash_attention_bf16_mma<KD>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern,
                                                          THREADS, smem);
    *regs = attr.numRegs;
    *smem_bytes = (int)smem;
    return (int)err;
  });
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
FLASH_ENTRY(flash_attention_f16, __half)
#undef FLASH_ENTRY

// The same arguments; bf16 runs on the tensor cores (any D in 1..128).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Lq, int Lkv, int D,
                         int causal, int window, int q_offset, float scale,
                         cudaStream_t stream) {
  return dispatch_bf16(q, k, v, o, B, Hq, Hkv, Lq, Lkv, D, causal, window,
                       q_offset, scale, stream);
}

// The bf16 kernel at head dim D (1..128): registers a thread, dynamic
// shared memory a block, and blocks an SM can hold.
int flash_attention_bf16_attributes(int D, int* regs, int* smem_bytes,
                                    int* blocks_per_sm) {
  return attributes_bf16(D, regs, smem_bytes, blocks_per_sm);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
