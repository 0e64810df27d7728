// Same-padded multi-mask 2-D correlation, a direct stencil for Hopper.
//
// Replaces the TPU kernel repro/kernels/conv2d_gemm.py::conv2d_gemm (body
// _conv_kernel), which streams nine halo-neighbour BlockSpecs into VMEM and
// runs one im2col GEMM of all masks against the patch tensor.  With at most
// 3 masks of at most 7x7 taps that GEMM is far too thin for the tensor
// cores, so here each thread runs every mask over its pixel as a chain of
// FMAs read from shared memory.
//
// What bounds it on this card: memory.  Each output pixel costs 25 (Gauss)
// or 18 (Sobel pair) multiply-adds against 4 bytes read and 4 or 8 bytes
// written, far below the ~20 FLOP/byte where the card's f32 rate would
// become the limit.  The design reads every input pixel from device memory
// once per tile (a 32x32 output tile plus its (k-1) halo, staged in shared
// memory, about 27% extra reads for 5x5), writes each output once,
// coalesced along W, and keeps the masks in a small shared copy.
//
// Types follow repro/kernels/tiles.py::acc_dtype: f32 accumulates in f32,
// int32 and int8 inputs in int32 (exact), f16 in f16.  The output is
// (N, M, H, W) in the accumulator type; zero padding at the frame border
// and ragged tiles are masked here, not padded in device memory.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;   // output columns per block (one warp wide)
constexpr int TILE_H = 32;   // output rows per block
constexpr int BLOCK_Y = 8;   // thread rows; each thread covers TILE_H/BLOCK_Y rows

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __half zero<__half>() {
  return __float2half(0.0f);
}

__device__ __forceinline__ float mac(float acc, float m, float v) {
  return __fmaf_rn(m, v, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int32_t m, int32_t v) {
  return acc + m * v;
}
__device__ __forceinline__ __half mac(__half acc, __half m, __half v) {
  return __hfma(m, v, acc);
}

template <typename Acc, typename In> __device__ __forceinline__ Acc widen(In v) {
  return static_cast<Acc>(v);
}

template <typename In, typename Acc>
__global__ void __launch_bounds__(TILE_W * BLOCK_Y)
conv2d_kernel(const In* __restrict__ img, const Acc* __restrict__ masks,
              Acc* __restrict__ out, int H, int W, int M, int kh, int kw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = kh * kw;
  const int th = TILE_H + kh - 1;
  const int tw = TILE_W + kw - 1;
  Acc* s_mask = reinterpret_cast<Acc*>(smem_raw);
  Acc* s_tile = s_mask + M * taps;

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int ph = kh / 2, pw = kw / 2;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * BLOCK_Y;

  for (int i = tid; i < M * taps; i += nthreads) s_mask[i] = masks[i];
  const In* src = img + (size_t)n * H * W;
  for (int i = tid; i < th * tw; i += nthreads) {
    const int r = i / tw, c = i - r * tw;
    const int y = y0 - ph + r, x = x0 - pw + c;
    Acc v = zero<Acc>();
    if (y >= 0 && y < H && x >= 0 && x < W) v = widen<Acc>(src[(size_t)y * W + x]);
    s_tile[r * tw + c] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ry = threadIdx.y; ry < TILE_H; ry += BLOCK_Y) {
    const int y = y0 + ry;
    if (y >= H) break;
    for (int m = 0; m < M; ++m) {
      const Acc* mk = s_mask + m * taps;
      Acc acc = zero<Acc>();
      for (int dy = 0; dy < kh; ++dy) {
        const Acc* row = s_tile + (ry + dy) * tw + threadIdx.x;
        for (int dx = 0; dx < kw; ++dx) acc = mac(acc, mk[dy * kw + dx], row[dx]);
      }
      out[(((size_t)n * M + m) * H + y) * W + x] = acc;
    }
  }
}

template <typename In, typename Acc>
int launch(const In* img, const Acc* masks, Acc* out, int N, int H, int W,
           int M, int kh, int kw, cudaStream_t stream) {
  const dim3 block(TILE_W, BLOCK_Y);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, N);
  const size_t smem =
      sizeof(Acc) * ((size_t)M * kh * kw + (size_t)(TILE_H + kh - 1) * (TILE_W + kw - 1));
  conv2d_kernel<In, Acc><<<grid, block, smem, stream>>>(img, masks, out, H, W, M, kh, kw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv2d_f32(const float* img, const float* masks, float* out, int N, int H,
               int W, int M, int kh, int kw, cudaStream_t stream) {
  return launch<float, float>(img, masks, out, N, H, W, M, kh, kw, stream);
}

int conv2d_f16(const __half* img, const __half* masks, __half* out, int N,
               int H, int W, int M, int kh, int kw, cudaStream_t stream) {
  return launch<__half, __half>(img, masks, out, N, H, W, M, kh, kw, stream);
}

int conv2d_i32(const int32_t* img, const int32_t* masks, int32_t* out, int N,
               int H, int W, int M, int kh, int kw, cudaStream_t stream) {
  return launch<int32_t, int32_t>(img, masks, out, N, H, W, M, kh, kw, stream);
}

int conv2d_i8(const int8_t* img, const int32_t* masks, int32_t* out, int N,
              int H, int W, int M, int kh, int kw, cudaStream_t stream) {
  return launch<int8_t, int32_t>(img, masks, out, N, H, W, M, kh, kw, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
