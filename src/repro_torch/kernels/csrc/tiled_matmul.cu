// Tiled GEMM (M, K) @ (K, N) for Hopper: int8 x int8 -> int32 exact and
// bf16 / f16 with f32 sums on the tensor cores, f32 on the FMA pipe.
//
// Replaces the TPU kernel repro/kernels/tiled_matmul.py::tiled_matmul (body
// _matmul_kernel), the paper's Gemmini tiled_matmul_auto on the MXU: a
// (bm, bn) accumulator in VMEM scratch carried across a sequential k grid
// axis, ragged shapes zero-padded in HBM first.  Here blocks run in no
// order, so nothing is carried between them: a block either owns its
// output tile for the whole contraction, or (the decode form below) adds
// its slice of K into the output with atomics.  Ragged edges of M, N and K
// are zero-filled as tiles are loaded, with no padded copy in device
// memory.
//
// int8 (i8::mma_kernel).  Every product is mma.sync.m16n8k32.s32.s8.s8.s32, the
// tensor cores' integer MMA: exact, and integer addition is associative,
// so any order of sums (split-K partials included) gives the same int32,
// equal to the plain version while |sum| < 2^31, which holds for any K
// below 131072 (the largest product is 128^2).  The C entry picks one of
// two forms by M:
//   * tile (M > 16): a block of 8 warps owns a 128x128 output tile, each
//     warp 64x32 of it as 4 x 4 m16n8 accumulators;
//   * decode (M <= 16): a block of 4 warps owns a 16 x 128 strip and one
//     slice of K (a multiple of 64); the slices are chosen so that the
//     grid holds about 4 blocks for each of the H100's 132 SMs, the
//     output is zeroed on the stream first and every block adds its
//     partial sums with atomicAdd.  A decode step is one pass over y.
// Both forms stream 64-deep k steps of x and y through a 4-stage ring in
// shared memory by 16-byte cp.async (zero-filled past M, N and K), and
// take element-by-element loads instead where a row is not 16-byte
// aligned (K or N not a multiple of 16).  A fragments come from x's rows
// (K-contiguous) by ldmatrix.  The B operand (.col) wants four k of one
// column in a register, but y is N-contiguous: ldmatrix.x4.trans on a b16
// view gives each lane two k of two columns from each of four 8-row
// matrices whose rows are k = 4i + {0, 1} (+2, +16, +18), and one
// __byte_perm of two such registers packs k 4q..4q+3 of the even column,
// another those of the odd one, so one x4 load feeds two n8 products.
// The even / odd products' accumulators interleave back to four
// consecutive columns a lane, stored as one int4.  Both tiles are
// XOR-swizzled by 16-byte chunk so that every ldmatrix phase reads 8
// distinct bank groups.
//
// What bounds it on this card.  At zamba2-1.2b's prefill (M = 999,
// K = 2048, N = 8384) the int8 product is 34 GOP against 19 MB of int8
// operands and 34 MB of int32 out: at the int8 tensor-core rate (1979
// TOPS, which needs wgmma) a 17 us job, the bytes 16 us.  The tile form
// issues mma.sync, 16 a warp for each 32-deep k step against 6 ldmatrix
// and 8 byte permutes, and reads x and y from L2 once for each tile
// column and row (270 MB at that shape); on an H100 80GB HBM3 at 700 W it
// reaches about 420 TOPS, and a GEMM with N = 2048 fills only 128 of the
// card's 264 block slots.  wgmma with TMA is the later form.  A decode
// step (M = 4) is bound by reading y once (17 MB, 5 us); the decode form
// streams it at about 80% of the memory rate at M = 4, and its time grows
// with M by the partials' atomics (M x 128 a block).
//
// bf16 / f16 (wg::mma_kernel).  wgmma.mma_async m64n64k16 with f32
// accumulators, both operands read from shared memory through 64-bit
// descriptors in the 128-byte-swizzled layout: A is x's rows (K-major); B
// is y as stored (N-contiguous, MN-major), which wgmma takes for 16-bit
// types through its transpose-B immediate, so y needs no copy and no
// permute.  A block of two warpgroups owns a 128x128 output tile, each
// warpgroup 64 rows as two 64-column halves with accumulators of their
// own.  128x128 rather than 128x256: the running sums and their
// compensation (below) take 128 registers a thread for 64 x 128, and a
// 64 x 256 warpgroup would need twice that; at zamba2's in_proj 128x128
// gives 8 x 66 = 528 tiles, 4 whole waves of one block on each of the 132
// SMs.  64-deep k steps of x and y stream through a 5-stage ring by
// 16-byte cp.async written at the swizzled addresses (element by element
// where K or N is not a multiple of 8), zero-filled past M, N and K, each
// stage's writes made visible to the tensor cores by fence.proxy.async
// before the block barrier.
//
// The f32 sums.  The tensor cores truncate the f32 sum of a product's 16
// terms and its accumulator instead of rounding to nearest, so a chain of
// products fed back through the accumulator errs more than the plain f32
// product.  The kernel promotes its partial sums as the reference does at
// its own block depth (each grid step adds one jnp.dot of bk k into an f32
// accumulator): every CHAIN_K k a fresh accumulator (scale-d 0) is added
// into a running f32 sum in registers with __fadd_rn and Kahan
// compensation; the output is that sum, less its compensation, rounded
// once to its type, to nearest even.  CHAIN_K is 16 for every K, each
// product its own chain: a longer chain adds a truncated accumulate, which
// the contract (twice the plain f32 product's error) does not absorb where
// the plain's sum of few terms is near exact (PERF.md, the chain lengths
// tried).  A bf16 or f16 product of two operands is exact in f32.  Each
// half's adds run while the other half's product and the other
// warpgroup's are on the tensor cores (wait_group 1).
//
// What bounds it.  At zamba2's in_proj (999 x 2048 x 8384) the product is
// 34.3 GFLOP against 55 MB of bf16 operands and output: at 989 TFLOP/s
// dense bf16 a 35 us job, the bytes 16 us.  The promotion is 4 f32
// operations an output every 16 k, on a pipe of 128 lanes an SM against
// the tensor cores' 4096 bf16 FLOP a clock: 4 times the products' time, so
// the adds, not the tensor cores, bound it (about 0.14 ms at in_proj at the
// published rates).
// No group is left pending across a stage, and no wgmma, its fence or
// wait sits in a branch (either makes ptxas serialize every wgmma).  TMA,
// a producer warp and a persistent grid are the later form.
//
// f32 (matmul_f32acc_kernel): one block per 64x64 output tile, K staged
// through shared memory in steps of 32, each of 256 threads keeping a 4x4
// block in registers; a partial sum chains 8 k-values with __fmaf_rn, and
// the partials are added to the running sum with Kahan compensation, so
// the sum's error is that of an 8-term chain, not of a K-term one (a
// single K-long chain erred 2.4-6.4x more than cuBLAS's f32 product on the
// H100); the output is rounded to its type once, to nearest even.  It runs
// on the FMA pipe, bound by the FMA rate and shared-memory reads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction depth staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 output block each
constexpr int PAD = 4;        // row padding of the f32 tiles (keeps float4 reads aligned)
constexpr int CHAIN = 8;      // k-values a float partial sum chains before it is added

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// f32 operands: sA holds the A tile transposed (sA[k][m]) so that a
// thread's four rows are one float4; sB[k][n] likewise for its columns.
template <typename Out>
__global__ void __launch_bounds__(THREADS)
matmul_f32acc_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     Out* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float sA[BK][BM + PAD];
  __shared__ __align__(16) float sB[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4], comp[4][4];  // the running sum and its Kahan compensation
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (64 x 32): consecutive threads read consecutive k of a row
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int k = tid & (BK - 1), m = (tid >> 5) + r * (THREADS / BK);
      const int gm = m0 + m, gk = k0 + k;
      sA[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    // B tile (32 x 64): consecutive threads read consecutive n of a row
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int n = tid & (BN - 1), k = (tid >> 6) + r * (THREADS / BN);
      const int gk = k0 + k, gn = n0 + n;
      sB[k][n] = (gk < K && gn < N) ? y[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k0c = 0; k0c < BK; k0c += CHAIN) {
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll
      for (int k = k0c; k < k0c + CHAIN; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = __fmaf_rn(av[i], bv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // Kahan: acc += part, the lost bits kept in comp
          const float d = __fsub_rn(part[i][j], comp[i][j]);
          const float t = __fadd_rn(acc[i][j], d);
          comp[i][j] = __fsub_rn(__fsub_rn(t, acc[i][j]), d);
          acc[i][j] = t;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = from_f32<Out>(__fsub_rn(acc[i][j], comp[i][j]));
    }
  }
}

// ---------------------------------------------------------------------------
// int8 on the tensor cores.
namespace i8 {

constexpr int BN = 128;            // output columns a block, both forms
constexpr int BK = 64;             // contraction bytes a pipeline stage
constexpr int STAGES = 4;          // cp.async ring depth
constexpr int DECODE_ROWS = 16;    // M up to this takes the decode form
constexpr int DECODE_BLOCKS = 528; // the decode grid's target: 4 x 132 SMs
constexpr int TILE_BM = 128;       // output rows a tile-form block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: a 16 x 32 (row), b 32 x 8 (col), c 16 x 8, all exact in int32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offsets in a stage.  A: rows of BK bytes, 16-byte chunk c of row m
// kept at chunk c ^ ((m >> 1) & 3).  B: rows (k) of BN bytes, chunk c of
// row k kept at c ^ (((k >> 1) & 6) | (k & 1)), which maps the eight rows
// k = 4i + {0, 1} of one ldmatrix.trans phase to eight distinct chunks.
__device__ __forceinline__ int a_off(int m, int kb) {
  return m * BK + ((((kb >> 4) ^ (m >> 1)) & 3) << 4) + (kb & 15);
}
__device__ __forceinline__ int b_off(int k, int nb) {
  return k * BN + (((nb >> 4) ^ (((k >> 1) & 6) | (k & 1))) << 4) + (nb & 15);
}

// vec bits: 1 x rows 16-byte aligned, 2 y rows, 4 out rows (int4 stores).
enum { A_VEC = 1, B_VEC = 2, OUT_VEC = 4 };

// One form: BM_ x BN output a block, WM x WN warps, SPLIT: the block owns
// rows [0, M) and the K slice blockIdx.y (k_slice deep) and adds its sums
// into a zeroed output; otherwise blockIdx.y is the row tile and the block
// covers all of K.
template <int BM_, int WM, int WN, bool SPLIT, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
           int32_t* __restrict__ out, int M, int N, int K, int k_slice, int vec) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM_ / WM, TN = BN / WN;  // a warp's tile
  constexpr int MF = TM / 16, NG = TN / 16;   // m16 fragments; 16-column groups
  constexpr int A_BYTES = BM_ * BK, STAGE = A_BYTES + BK * BN;
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const int n0 = blockIdx.x * BN;
  const int m0 = SPLIT ? 0 : blockIdx.y * BM_;
  const int kbeg = SPLIT ? blockIdx.y * k_slice : 0;
  const int kend = SPLIT ? min(K, kbeg + k_slice) : K;
  const int nk = (kend - kbeg + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    int8_t* sa = smem + stage * STAGE;
    int8_t* sb = sa + A_BYTES;
    const int k0 = kbeg + kt * BK;
    if (vec & A_VEC) {
#pragma unroll
      for (int c = tid; c < BM_ * BK / 16; c += NT) {
        const int m = c >> 2, kb = (c & 3) << 4;
        const int gm = m0 + m, gk = k0 + kb;
        const bool in = gm < M && gk < kend;
        cp_async16(smem_addr(sa + a_off(m, kb)), in ? x + (size_t)gm * K + gk : x, in ? 16 : 0);
      }
    } else {
      for (int w = tid; w < BM_ * BK / 4; w += NT) {
        const int m = w >> 4, kb = (w & 15) << 2;
        const int gm = m0 + m;
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + kb + e;
          if (gm < M && gk < kend) v |= (uint32_t)(uint8_t)x[(size_t)gm * K + gk] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(sa + a_off(m, kb)) = v;
      }
    }
    if (vec & B_VEC) {
#pragma unroll
      for (int c = tid; c < BK * BN / 16; c += NT) {
        const int k = c >> 3, nb = (c & 7) << 4;
        const int gk = k0 + k, gn = n0 + nb;
        const bool in = gk < kend && gn < N;
        cp_async16(smem_addr(sb + b_off(k, nb)), in ? y + (size_t)gk * N + gn : y, in ? 16 : 0);
      }
    } else {
      for (int w = tid; w < BK * BN / 4; w += NT) {
        const int k = w >> 5, nb = (w & 31) << 2;
        const int gk = k0 + k;
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gn = n0 + nb + e;
          if (gk < kend && gn < N) v |= (uint32_t)(uint8_t)y[(size_t)gk * N + gn] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(sb + b_off(k, nb)) = v;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  int acc[MF][NG][2][4];  // [m16][16 columns][even / odd n8][C fragment]
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][p][r] = 0;

  // A (ldmatrix.x4): lanes 0-7 give rows 0-7 of the first 16 k bytes,
  // 8-15 rows 8-15, 16-31 the same rows of the next 16 bytes: a0..a3.
  const int a_row = wm + (lane & 7) + (lane & 8), a_kb = (lane >> 4) << 4;
  // B (ldmatrix.x4.trans): matrix j = lane / 8 holds rows
  // k = 4 (r / 2) + (r & 1) + 2 (j & 1) + 16 (j / 2), r = lane & 7, so lane
  // (g, q) gets k 4q, 4q+1 (matrix 0), 4q+2, 4q+3 (1) of columns 2g, 2g+1,
  // and the same 16 deeper (2, 3).
  const int b_k = ((lane & 7) >> 1) * 4 + (lane & 1) + ((lane >> 3) & 1) * 2 + (lane >> 4) * 16;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for reuse
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int8_t* sa = smem + (kt % STAGES) * STAGE;
    const int8_t* sb = sa + A_BYTES;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      uint32_t a[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) ldsm_x4(a[i], smem_addr(sa + a_off(a_row + 16 * i, 32 * s + a_kb)));
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_addr(sb + b_off(32 * s + b_k, wn + 16 * j)));
        // bytes of r: (k, 2g), (k, 2g+1), (k+1, 2g), (k+1, 2g+1)
        const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), e1 = __byte_perm(r[2], r[3], 0x6420);
        const uint32_t o0 = __byte_perm(r[0], r[1], 0x7531), o1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          mma_s8(acc[i][j][0], a[i], e0, e1);  // columns 2g of the group
          mma_s8(acc[i][j][1], a[i], o0, o1);  // columns 2g + 1
        }
      }
    }
  }

  // Lane (g, q) holds rows g and g + 8 of each m16; the even product's
  // C columns 2q, 2q+1 are the group's columns 4q, 4q+2, the odd's 4q+1,
  // 4q+3: four consecutive columns.
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + 16 * i + g + 8 * h;
        const int gn = n0 + wn + 16 * j + 4 * q;
        if (gm >= M) continue;
        const int v[4] = {acc[i][j][0][2 * h], acc[i][j][1][2 * h], acc[i][j][0][2 * h + 1],
                          acc[i][j][1][2 * h + 1]};
        int32_t* o = out + (size_t)gm * N + gn;
        if (SPLIT) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gn + e < N) atomicAdd(o + e, v[e]);
        } else if ((vec & OUT_VEC) && gn + 3 < N) {
          *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gn + e < N) o[e] = v[e];
        }
      }
}

// The two forms' shapes.
template <bool DECODE> struct Form {  // tile
  static constexpr int BM = TILE_BM, WM = 2, WN = 4, MINB = 2;
};
template <> struct Form<true> {  // decode
  static constexpr int BM = DECODE_ROWS, WM = 1, WN = 4, MINB = 4;
};
template <bool D> constexpr int kThreads = Form<D>::WM * Form<D>::WN * 32;
template <bool D> constexpr int kSmem = STAGES * (Form<D>::BM * BK + BK * BN);
template <bool D> auto kernel() {
  return mma_kernel<Form<D>::BM, Form<D>::WM, Form<D>::WN, D, Form<D>::MINB>;
}

// The launch's choice, shared by the launch and the attribute query: the
// form by M; for the decode form, the K slice (a multiple of BK) that
// brings strips x slices to about DECODE_BLOCKS.  (kernels/tiled_matmul.py
// ::plan is the same rule, checked against this one on the card.)
struct Plan {
  bool decode;
  int k_slice, slices;
  dim3 grid;
};

inline Plan plan(int M, int N, int K) {
  const int strips = std::max(1, (N + BN - 1) / BN);
  if (M > DECODE_ROWS) return {false, K, 1, dim3(strips, (M + TILE_BM - 1) / TILE_BM)};
  const int steps = (K + BK - 1) / BK;
  const int want = std::max(1, std::min(steps, (DECODE_BLOCKS + strips - 1) / strips));
  const int k_slice = std::max(1, (steps + want - 1) / want) * BK;
  const int slices = std::max(1, (K + k_slice - 1) / k_slice);
  return {true, k_slice, slices, dim3(strips, slices)};
}

template <typename F> int with_form(bool decode, F f) {
  return decode ? f(std::true_type{}) : f(std::false_type{});
}

int launch(const int8_t* x, const int8_t* y, int32_t* out, int M, int N, int K,
           cudaStream_t stream) {
  if ((M + TILE_BM - 1) / TILE_BM > 65535) return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, N, K);
  const int vec = ((K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? A_VEC : 0) |
                  ((N % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? B_VEC : 0) |
                  ((N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) ? OUT_VEC : 0);
  return with_form(p.decode, [&](auto d) {
    constexpr bool D = decltype(d)::value;
    cudaError_t err =
        cudaFuncSetAttribute(kernel<D>(), cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<D>);
    if (err == cudaSuccess && D)  // the slices add into zeros
      err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
    kernel<D>()<<<p.grid, kThreads<D>, kSmem<D>, stream>>>(x, y, out, M, N, K, p.k_slice, vec);
    return (int)cudaGetLastError();
  });
}

// info: form (0 tile, 1 decode), k_slice, slices, blocks, threads a block,
// registers a thread, dynamic shared memory a block, blocks an SM.
int attributes(int M, int N, int K, int* info) {
  const Plan p = plan(M, N, K);
  return with_form(p.decode, [&](auto d) {
    constexpr bool D = decltype(d)::value;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel<D>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel<D>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem<D>);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel<D>(), kThreads<D>,
                                                          kSmem<D>);
    const int vals[8] = {D ? 1 : 0, p.k_slice, p.slices, (int)(p.grid.x * p.grid.y),
                         kThreads<D>, err == cudaSuccess ? attr.numRegs : 0, kSmem<D>, blocks};
    for (int i = 0; i < 8; ++i) info[i] = vals[i];
    return (int)err;
  });
}

}  // namespace i8

// ---------------------------------------------------------------------------
// bf16 / f16 on the tensor cores: wgmma.
namespace wg {

constexpr int BM = 128;          // output rows a block: two warpgroups of 64
constexpr int BN = 128;          // output columns a block: two m64n64k16 halves a warpgroup
constexpr int BK = 64;           // k a pipeline stage: one 128-byte swizzle row of A
constexpr int STAGES = 5;        // cp.async ring depth
constexpr int PREFETCH = STAGES - 2;  // stages loaded ahead (one more is still being read)
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024
// k a tensor-core chain sums before it is added into the running f32
// sum, one constant for every K: each k16 product is its own chain
// (PERF.md gives the error argument).
constexpr int CHAIN_K = 16;
constexpr int STEPS = BK / 16;   // k16 products a stage

// Byte offsets in a stage, each tile 1024-aligned, in the layouts that the
// descriptors' 128-byte swizzle reads (16-byte chunk c of a 128-byte row
// r kept at chunk c ^ (r % 8)).  A, K-major: row m is 128 bytes of k.  B,
// MN-major: two 64-column atoms of BK rows each, row k of an atom 128
// bytes of n.  tests/test_torch_matmul.py models both.
__host__ __device__ inline int a_off(int m, int k) {
  return m * 128 + ((((k >> 3) ^ m) & 7) << 4) + ((k & 7) << 1);
}
__host__ __device__ inline int b_off(int k, int n) {
  return (n >> 6) * (BK * 128) + k * 128 + (((((n >> 3) & 7) ^ k) & 7) << 4) + ((n & 7) << 1);
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each in 16-byte units), 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// A (K-major): 8-row groups 1024 bytes apart (SBO); LBO unused with a
// swizzle.  B (MN-major): 64-column atoms BK * 128 bytes apart (LBO), 8-row
// k groups 1024 apart (SBO).  A k16 step moves A's start 32 bytes along
// its rows and B's 16 rows (2048 bytes) down.
constexpr uint32_t A_LBO = 16, A_SBO = 1024, B_LBO = BK * 128, B_SBO = 1024;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins every access of accumulator registers between the volatile wgmma
// statements: without it the compiler moves one half's adds across the
// other half's products, and ptxas then waits for each product.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_MMA(TYPE)                                                                     \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 1;\n}\n"                                                    \
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)                                         \
      : "l"(da), "l"(db), "r"(0))

// d = A B for a warpgroup, a fresh chain (scale-d 0): A 64 x 16 K-major,
// B 16 x 64 MN-major (transpose-B immediate 1), d 64 x 64 in f32.
template <typename In>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<In, __nv_bfloat16>::value) WG_MMA("bf16");
  else WG_MMA("f16");
}
#undef WG_MMA
#undef WG_D8

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<__half> { using type = __half2; };

// vec bits: x rows 16-byte aligned, y rows, out rows (paired stores).
enum { A_VEC = 1, B_VEC = 2, OUT_VEC = 4 };

// IDLE: the grid's last row tile leaves its second warpgroup with no row
// of M (M % 128 in [1, 64]), whose adds are then skipped.
template <typename In, typename Out, bool IDLE>
__global__ void __launch_bounds__(THREADS, 1)
mma_kernel(const In* __restrict__ x, const In* __restrict__ y, Out* __restrict__ out, int M,
           int N, int K, int vec) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = i8::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024-aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  // A thread's 16-byte chunks of each tile keep their rows (x's m, y's k)
  // and their 8-element column, so their shared-memory offsets and source
  // rows are computed once.
  constexpr int A_CHUNKS = BM * BK / 8 / THREADS, B_CHUNKS = BK * BN / 8 / THREADS;
  const int a_k = (tid & 7) << 3, b_n = (tid & 15) << 3;
  const bool b_col_in = n0 + b_n < N;
  uint32_t a_dst[A_CHUNKS], b_dst[B_CHUNKS];
  const In* a_row[A_CHUNKS];
  bool a_row_in[A_CHUNKS];
#pragma unroll
  for (int r = 0; r < A_CHUNKS; ++r) {
    const int m = (tid >> 3) + r * (THREADS >> 3);
    a_dst[r] = a_off(m, a_k);
    a_row_in[r] = m0 + m < M;
    a_row[r] = x + (size_t)(a_row_in[r] ? m0 + m : 0) * K + a_k;
  }
#pragma unroll
  for (int r = 0; r < B_CHUNKS; ++r)
    b_dst[r] = A_BYTES + b_off((tid >> 4) + r * (THREADS >> 4), b_n);
  const In* b_col = y + (b_col_in ? n0 + b_n : 0);

  auto load = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + A_BYTES;
    const uint32_t dst = base + stage * STAGE_BYTES;
    const int k0 = kt * BK;
    if (vec & A_VEC) {
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r) {
        const bool in = a_row_in[r] && k0 + a_k < K;
        i8::cp_async16(dst + a_dst[r], in ? a_row[r] + k0 : x, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e >> 6, k = e & 63;
        const bool in = m0 + m < M && k0 + k < K;
        *reinterpret_cast<In*>(sa + a_off(m, k)) =
            in ? x[(size_t)(m0 + m) * K + k0 + k] : from_f32<In>(0.0f);
      }
    }
    if (vec & B_VEC) {
#pragma unroll
      for (int r = 0; r < B_CHUNKS; ++r) {
        const int k = k0 + (tid >> 4) + r * (THREADS >> 4);
        const bool in = b_col_in && k < K;
        i8::cp_async16(dst + b_dst[r], in ? b_col + (size_t)k * N : y, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e >> 7, n = e & 127;
        const bool in = k0 + k < K && n0 + n < N;
        *reinterpret_cast<In*>(sb + b_off(k, n)) =
            in ? y[(size_t)(k0 + k) * N + n0 + n] : from_f32<In>(0.0f);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, s);
    i8::cp_async_commit();
  }

  // Each warpgroup's 64 x 128 is two 64 x 64 halves, a (columns 0-63) and
  // b, so that one half's adds run while the other half's product is on
  // the tensor cores.  A half keeps two buffers and a Kahan compensation:
  // a product lands in the free buffer, and its add leaves the running sum
  // there, freeing the other; so the sum moves between the two each step
  // and no add needs a register move.
  float a0[32], a1[32], ac[32], b0[32], b1[32], bc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a0[i] = a1[i] = ac[i] = b0[i] = b1[i] = bc[i] = 0.0f;
  // A warpgroup whose rows all lie past M issues its products (no wgmma
  // may sit in a branch) but skips their adds; the check is compiled only
  // into the instance for an M that leaves one (it slows every other M).
  const bool rows_in = !IDLE || m0 + 64 * wgi < M;
  // A chain's end, Kahan: sum += p rounded to nearest, the lost bits kept
  // (negated) in c.  p holds the product, s the sum; afterwards p holds
  // the sum and s is free.
  auto add = [&](float(&p)[32], float(&s)[32], float(&c)[32]) {
    if (!rows_in) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      c[i] = __fsub_rn(p[i], c[i]);  // the product less the lost bits
      p[i] = __fadd_rn(s[i], c[i]);  // the new sum
      s[i] = __fsub_rn(p[i], s[i]);  // what the add took in
      c[i] = __fsub_rn(s[i], c[i]);  // ... less what it was given
    }
  };

  // Step s of a stage: half a's sum is added while b_s is on the tensor
  // cores and a_{s+1} is issued; half b's sum is added while a_{s+1} runs
  // and b_{s+1} is issued (wait_group 1: one group in flight behind every
  // add).  The last step drains, so no group is pending across the loop's
  // back edge (ptxas would then serialize every wgmma).  With 4 steps a
  // stage the sums sit in a1 and b1 at every stage's end.
  uint32_t sa = 0, sb = 0;
  auto step = [&](auto s_) {
    constexpr int s = decltype(s_)::value;
    float(&pa)[32] = s % 2 ? a1 : a0;  // the product of step s
    float(&qa)[32] = s % 2 ? a0 : a1;  // the sum before it, then free
    float(&pb)[32] = s % 2 ? b1 : b0;
    float(&qb)[32] = s % 2 ? b0 : b1;
    fence_regs(pa);
    fence_regs(pb);
    wgmma_wait<1>();
    fence_regs(pa);
    add(pa, qa, ac);
    fence_regs(pa);
    fence_regs(qa);
    if constexpr (s + 1 < STEPS) {
      wgmma_fence();
      mma<In>(qa, desc(sa + 32 * (s + 1), A_LBO, A_SBO),
              desc(sb + 2048 * (s + 1), B_LBO, B_SBO));
      wgmma_commit();
      fence_regs(qa);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(pb);
    add(pb, qb, bc);
    fence_regs(pb);
    fence_regs(qb);
    if constexpr (s + 1 < STEPS) {
      wgmma_fence();
      mma<In>(qb, desc(sa + 32 * (s + 1), A_LBO, A_SBO),
              desc(sb + BK * 128 + 2048 * (s + 1), B_LBO, B_SBO));
      wgmma_commit();
    }
  };
  static_assert(STEPS == 4, "the steps of a stage are written out below");

  for (int kt = 0; kt < nk; ++kt) {
    i8::cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();  // this thread's tile writes, visible to wgmma's reads
    // Stage kt landed; every product of stage kt - 1 is done (each thread
    // waited for them), so its slot may be loaded again.
    __syncthreads();
    if (kt + PREFETCH < nk) load((kt + PREFETCH) % STAGES, kt + PREFETCH);
    i8::cp_async_commit();
    sa = base + (kt % STAGES) * STAGE_BYTES + wgi * 64 * 128;
    sb = base + (kt % STAGES) * STAGE_BYTES + A_BYTES;
    fence_regs(a0);
    fence_regs(b0);
    wgmma_fence();
    mma<In>(a0, desc(sa, A_LBO, A_SBO), desc(sb, B_LBO, B_SBO));
    wgmma_commit();
    mma<In>(b0, desc(sa, A_LBO, A_SBO), desc(sb + BK * 128, B_LBO, B_SBO));
    wgmma_commit();
    step(std::integral_constant<int, 0>{});
    step(std::integral_constant<int, 1>{});
    step(std::integral_constant<int, 2>{});
    step(std::integral_constant<int, 3>{});
  }
  i8::cp_async_wait<0>();

  // Thread (warp w, lane l) of a warpgroup holds, for each 8-column group c,
  // d[4c + 2h + e] = row 16w + l / 4 + 8h, column 8c + 2 (l % 4) + e.  A
  // warpgroup whose rows all lie past M computed zeros and stores nothing.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = m0 + 64 * wgi + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int gn = n0 + 8 * c + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + 8 * h;
      if (gm >= M || gn >= N) continue;
      // register 4c + 2h + e of half a for c < 8, of half b beyond
      const int j = (4 * c + 2 * h) & 31;
      const float* sum = c < 8 ? a1 : b1;
      const float* comp = c < 8 ? ac : bc;
      const Out v0 = from_f32<Out>(__fsub_rn(sum[j], comp[j]));
      const Out v1 = from_f32<Out>(__fsub_rn(sum[j + 1], comp[j + 1]));
      Out* o = out + (size_t)gm * N + gn;
      if ((vec & OUT_VEC) && gn + 1 < N) {
        typename Pair<Out>::type p;
        p.x = v0;
        p.y = v1;
        *reinterpret_cast<typename Pair<Out>::type*>(o) = p;
      } else {
        o[0] = v0;
        if (gn + 1 < N) o[1] = v1;
      }
    }
  }
}

inline dim3 grid_for(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }
// Whether the last row tile's second warpgroup holds no row of M.
inline bool idle_warpgroup(int M) { return M % BM != 0 && M % BM <= 64; }

template <typename In, typename Out>
int launch(const void* x, const void* y, void* out, int M, int N, int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const int vec = ((K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? A_VEC : 0) |
                  ((N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? B_VEC : 0) |
                  ((N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(Out)) == 0)
                       ? OUT_VEC : 0);
  auto kernel = idle_warpgroup(M) ? mma_kernel<In, Out, true> : mma_kernel<In, Out, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(M, N), THREADS, SMEM, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y), static_cast<Out*>(out), M, N, K,
      vec);
  return (int)cudaGetLastError();
}

// info: tile rows, tile columns, chain k, blocks, threads a block,
// registers a thread, dynamic shared memory a block, blocks an SM, of the
// bf16 -> bf16 instance that launch takes for M (the other types' instances
// differ only in their operand type and epilogue).
int attributes(int M, int N, int* info) {
  auto kernel = idle_warpgroup(M) ? mma_kernel<__nv_bfloat16, __nv_bfloat16, true>
                                  : mma_kernel<__nv_bfloat16, __nv_bfloat16, false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, SMEM);
  const dim3 g = grid_for(M, N);
  const int vals[8] = {BM, BN, CHAIN_K, (int)(g.x * g.y), THREADS,
                       err == cudaSuccess ? attr.numRegs : 0, SMEM, blocks};
  for (int i = 0; i < 8; ++i) info[i] = vals[i];
  return (int)err;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: the launch.

inline dim3 grid_for(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

template <typename Out>
int launch_f32acc(const void* x, const void* y, void* out, int M, int N, int K,
                  cudaStream_t stream) {
  matmul_f32acc_kernel<Out><<<grid_for(M, N), THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<Out*>(out), M, N,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) and y (K, N) row-major and contiguous, out (M, N) row-major.
// in_type: 0 f32, 1 bf16, 2 f16, 3 int8; out_type: 0 f32, 1 bf16, 2 f16,
// 4 int32 (int8 operands take int32 out only).  Returns a CUDA error code,
// cudaErrorInvalidValue for a pair of types it does not take or a grid
// taller than 65535 row tiles (64 rows a tile for f32, 128 for the rest).
int tiled_matmul(const void* x, const void* y, void* out, int in_type, int out_type, int M,
                 int N, int K, cudaStream_t stream) {
  if (in_type == 3) {
    if (out_type != 4) return (int)cudaErrorInvalidValue;
    return i8::launch(static_cast<const int8_t*>(x), static_cast<const int8_t*>(y),
                      static_cast<int32_t*>(out), M, N, K, stream);
  }
#define WG_OUT(IN)                                                           \
  switch (out_type) {                                                        \
    case 0: return wg::launch<IN, float>(x, y, out, M, N, K, stream);         \
    case 1: return wg::launch<IN, __nv_bfloat16>(x, y, out, M, N, K, stream); \
    case 2: return wg::launch<IN, __half>(x, y, out, M, N, K, stream);        \
    default: return (int)cudaErrorInvalidValue;                              \
  }
  if (in_type == 1) WG_OUT(__nv_bfloat16)
  if (in_type == 2) WG_OUT(__half)
#undef WG_OUT
  if (in_type != 0 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  switch (out_type) {
    case 0: return launch_f32acc<float>(x, y, out, M, N, K, stream);
    case 1: return launch_f32acc<__nv_bfloat16>(x, y, out, M, N, K, stream);
    case 2: return launch_f32acc<__half>(x, y, out, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The int8 launch that tiled_matmul would make for (M, N, K), into info[8]:
// form (0 tile, 1 decode), K slice, slices, blocks, threads a block,
// registers a thread, dynamic shared memory a block, blocks an SM.
// Launches nothing.
int tiled_matmul_i8_attributes(int M, int N, int K, int* info) {
  return i8::attributes(M, N, K, info);
}

// The bf16 / f16 launch that tiled_matmul would make for (M, N, K), into
// info[8]: tile rows, tile columns, chain k (the same for every K), blocks,
// threads a block, registers a thread, dynamic shared memory a block,
// blocks an SM.  Launches nothing.
int tiled_matmul_f16_attributes(int M, int N, int K, int* info) {
  (void)K;
  return wg::attributes(M, N, info);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
