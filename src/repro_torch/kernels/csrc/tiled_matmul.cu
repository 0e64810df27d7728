// Output-stationary tiled GEMM (M, K) @ (K, N) for Hopper: int8 x int8 ->
// int32 exact, and f32 / bf16 / f16 with f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/tiled_matmul.py::tiled_matmul (body
// _matmul_kernel), the paper's Gemmini tiled_matmul_auto on the MXU: a
// (bm, bn) accumulator in VMEM scratch carried across a sequential k grid
// axis, ragged shapes zero-padded in HBM first.  Here one block owns one
// 64x64 output tile for the whole contraction (blocks run in no order, so
// nothing is carried between them): K is staged through shared memory in
// steps of 32, each of the 256 threads keeps a 4x4 block of the tile in
// registers, and the ragged edges of M, N and K are masked as the tiles
// are loaded (zeros), with no padded copy in device memory.
//
// Arithmetic.  int8: four k-values packed per 32-bit word, accumulated with
// __dp4a into int32, exact while |sum| < 2^31, which holds for any K below
// 131072 (the largest product is 128^2).  Floats: each operand converted
// to f32 once, in shared memory; a partial sum chains 8 k-values with
// __fmaf_rn, and the partials are added to the running sum with Kahan
// compensation, so the sum's error is that of an 8-term chain, not of a
// K-term one (a single K-long chain erred 2.4-6.4x more than cuBLAS's f32
// product on the H100); the output is rounded to its type once, to
// nearest even.  A bf16 or f16 product of two operands is exact in f32, so
// those sums differ from the library's f32 product only in the additions.
//
// What bounds it on this card.  At zamba2-1.2b's prefill (M = 999,
// K = 2048, N = 8384) the int8 product is 34 GOP against 19 MB of int8
// operands and 34 MB of int32 out: the int8 tensor-core rate (1979 TOPS)
// would make it a 17 us job, the bytes 16 us.  This first design runs on the integer
// and FMA pipes, not the tensor cores (wgmma with TMA loads is the later,
// fast form), so it is bound by the dp4a / FMA rate and shared-memory
// reads: per 4-deep k step a thread reads two 16-byte words and runs 16 dp4a
// (or 16 FMA a k, and 4 adds a partial every 8 k).  A decode step (M = 4)
// could take the time of reading the weight once (5 us at in_proj); here
// one block streams each 64-column strip of y in K / 32 synchronised
// steps, and those steps set its time (70 us on the H100).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction depth staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 output block each
constexpr int PAD = 4;        // row padding of the f32 tiles (keeps float4 reads aligned)
constexpr int CHAIN = 8;      // k-values a float partial sum chains before it is added

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Float operands: sA holds the A tile transposed (sA[k][m]) so that a
// thread's four rows are one float4; sB[k][n] likewise for its columns.
template <typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
matmul_f32acc_kernel(const In* __restrict__ x, const In* __restrict__ y,
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
      sA[k][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
    // B tile (32 x 64): consecutive threads read consecutive n of a row
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int n = tid & (BN - 1), k = (tid >> 6) + r * (THREADS / BN);
      const int gk = k0 + k, gn = n0 + n;
      sB[k][n] = (gk < K && gn < N) ? to_f32(y[(size_t)gk * N + gn]) : 0.0f;
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

// int8 operands: sA[k4][m] packs A[m][4 k4 .. 4 k4 + 3] into one word (low
// byte first), sB[k4][n] packs B[4 k4 .. 4 k4 + 3][n]; __dp4a multiplies
// the four signed byte pairs and adds them to the int32 sum.
__global__ void __launch_bounds__(THREADS)
matmul_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
                 int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int32_t sA[BK / 4][BM];
  __shared__ __align__(16) int32_t sB[BK / 4][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: a thread packs 8 consecutive k of one row into two words
      const int m = tid >> 2, kq = tid & 3;
      const int gm = m0 + m;
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gk = k0 + kq * 8 + e;
        const uint32_t v =
            (gm < M && gk < K) ? (uint32_t)(uint8_t)x[(size_t)gm * K + gk] : 0u;
        w[e >> 2] |= v << (8 * (e & 3));
      }
      sA[kq * 2][m] = (int32_t)w[0];
      sA[kq * 2 + 1][m] = (int32_t)w[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // B tile: a thread packs 4 k of one column
      const int n = tid & (BN - 1), k4 = (tid >> 6) + 4 * r;
      const int gn = n0 + n;
      uint32_t w = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + k4 * 4 + e;
        const uint32_t v =
            (gk < K && gn < N) ? (uint32_t)(uint8_t)y[(size_t)gk * N + gn] : 0u;
        w |= v << (8 * e);
      }
      sB[k4][n] = (int32_t)w;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      const int4 a = *reinterpret_cast<const int4*>(&sA[k4][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&sB[k4][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
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
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

inline dim3 grid_for(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

template <typename In, typename Out>
int launch_f32acc(const void* x, const void* y, void* out, int M, int N, int K,
                  cudaStream_t stream) {
  matmul_f32acc_kernel<In, Out><<<grid_for(M, N), THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y), static_cast<Out*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) and y (K, N) row-major and contiguous, out (M, N) row-major.
// in_type: 0 f32, 1 bf16, 2 f16, 3 int8; out_type: 0 f32, 1 bf16, 2 f16,
// 4 int32 (int8 operands take int32 out only).  Returns a CUDA error code,
// cudaErrorInvalidValue for a pair of types it does not take.
int tiled_matmul(const void* x, const void* y, void* out, int in_type, int out_type, int M,
                 int N, int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if (in_type == 3) {
    if (out_type != 4) return (int)cudaErrorInvalidValue;
    matmul_i8_kernel<<<grid_for(M, N), THREADS, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(y),
        static_cast<int32_t*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
#define TM_OUT(IN)                                                              \
  switch (out_type) {                                                           \
    case 0: return launch_f32acc<IN, float>(x, y, out, M, N, K, stream);         \
    case 1: return launch_f32acc<IN, __nv_bfloat16>(x, y, out, M, N, K, stream); \
    case 2: return launch_f32acc<IN, __half>(x, y, out, M, N, K, stream);        \
    default: return (int)cudaErrorInvalidValue;                                 \
  }
  switch (in_type) {
    case 0: TM_OUT(float)
    case 1: TM_OUT(__nv_bfloat16)
    case 2: TM_OUT(__half)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TM_OUT
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
