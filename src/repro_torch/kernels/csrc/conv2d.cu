// Same-padded multi-mask 2-D correlation, a direct stencil for Hopper.
//
// Replaces the TPU kernel repro/kernels/conv2d_gemm.py::conv2d_gemm (body
// _conv_kernel), which streams nine halo-neighbour BlockSpecs into VMEM and
// runs one im2col GEMM of all masks against the patch tensor.  With at most
// 3 masks of at most 7x7 taps that GEMM is far too thin for the tensor
// cores, so here each thread runs every mask over a strip of pixels as
// chains of FMAs.
//
// What bounds it on this card: memory in f32 and int32.  Each output pixel
// costs 25 (Gauss) or 18 (Sobel pair) multiply-adds against 4 bytes read
// and 4 or 8 bytes written, far below the ~20 FLOP/byte where the card's
// f32 rate would become the limit; at 720x1280 x 8 the pair runs within
// ~10% of a plain copy of the same bytes.  With 2-byte f16 or 1-byte int8
// frames, and with the 7x7 set's 147 taps, the instructions bound it
// instead (PERF.md section 6).  The design keeps the arithmetic and the
// shared-memory traffic small:
//
//   1. a block's window (its TILE_H x TILE_W outputs plus the mask's halo)
//      comes in by cp.async, 16 bytes a copy where rows allow it (zero
//      filled outside the frame, no per-element index arithmetic), and
//      stays in the input type;
//   2. each thread computes a vertical strip of STRIP outputs of one
//      column, one mask at a time: it reads each window row of the strip
//      once (STRIP + k - 1 rows, not k rows per output) and runs every
//      output's chain from registers;
//   3. the mask sides the detector launches (3, 5, 7, square) are compile-
//      time constants, so the tap loops unroll and the mask's taps sit in
//      registers, read from device memory once a block; other shapes take
//      the generic instance of the same kernel, with runtime bounds and
//      the taps read from shared memory;
//   4. a warp's 32 threads take 32 neighbouring columns, so each store
//      writes a whole 128-byte row segment of a mask's plane (64 in f16).
//
// Every output is the same chain as in the reference's order: start from
// zero, then taps dy-major and dx-minor, one __fmaf_rn / __hfma / integer
// multiply-add each.  A strip changes only which thread computes an
// output, so the result is bit for bit that of any other schedule of
// these chains (and of kernels/fused_detect.cu's conv_strip).
//
// Types follow repro/kernels/tiles.py::acc_dtype: f32 accumulates in f32,
// int32 and int8 inputs in int32 (exact), f16 in f16.  The output is
// (N, M, H, W) in the accumulator type; zero padding at the frame border
// and ragged tiles are masked here, not padded in device memory.
// kernels/conv2d_gemm.py::launch_plan mirrors conv2d_plan below.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 128;  // output columns per block (four warps wide)
constexpr int TILE_H = 16;   // output rows per block
constexpr int THREADS = 128;
constexpr int STRIP = 8;     // output rows a thread computes per strip
constexpr int STRIP_ROWS = THREADS / TILE_W;  // strips side by side in a pass
constexpr int MAX_HALO = 7;  // the generic instance's pad: masks up to 15x15
static_assert(TILE_H % STRIP == 0 && THREADS % TILE_W == 0, "tile shape");

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

// The window's left and right pad in input elements: the mask's half side
// rounded up to a 16-byte copy, so every copy starts 16-byte aligned.
__host__ __device__ constexpr int pad_of(int K, int in_bytes) {
  return ((K ? K / 2 : MAX_HALO) + 16 / in_bytes - 1) / (16 / in_bytes) * (16 / in_bytes);
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared memory of one block: the masks (in the accumulator type), then
// the window, rows of pad + TILE_W + pad input elements.
__host__ __device__ inline size_t smem_bytes(int K, int in_bytes, int acc_bytes, int M,
                                             int kh, int kw) {
  const int pitch = 2 * pad_of(K, in_bytes) + TILE_W;
  return align16((size_t)acc_bytes * M * kh * kw) +
         (size_t)in_bytes * (TILE_H + kh - 1) * pitch;
}

// 16 bytes from global to shared memory without waiting (cp.async, L2
// only), or 16 zero bytes where `in` is false (a source size of 0; `src`
// is then any valid address).
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block: frame blockIdx.z, outputs [y0, y0 + TILE_H) x [x0, x0 +
// TILE_W).  K: the mask side of an unrolled instance, 0 for the generic
// one (kh, kw at run time).  vec: rows and the image start on 16 bytes.
template <typename In, typename Acc, int K>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const In* __restrict__ img, const Acc* __restrict__ masks,
              Acc* __restrict__ out, int H, int W, int M, int kh_rt, int kw_rt, bool vec) {
  constexpr int PAD = pad_of(K, sizeof(In));
  constexpr int PITCH = 2 * PAD + TILE_W;  // window row, input elements
  const int kh = K ? K : kh_rt, kw = K ? K : kw_rt;
  const int taps = kh * kw;
  const int rows = TILE_H + kh - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* s_mask = reinterpret_cast<Acc*>(smem_raw);
  In* s_win = reinterpret_cast<In*>(smem_raw + align16(sizeof(Acc) * (size_t)M * taps));

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int ph = kh / 2, pw = kw / 2;
  const int tid = threadIdx.x;
  const In* src = img + (size_t)n * H * W;

  // Window row r, column c holds pixel (y0 - ph + r, x0 - PAD + c).
  if (vec) {
    constexpr int E = 16 / sizeof(In);  // elements a copy
    constexpr int CHUNKS = PITCH / E;
    for (int i = tid; i < rows * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, cc = i - r * CHUNKS;
      const int y = y0 - ph + r, x = x0 - PAD + cc * E;
      // W is a multiple of E: a copy lies wholly inside the row or outside
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      copy16_async(s_win + r * PITCH + cc * E, in ? src + (size_t)y * W + x : img, in);
    }
  } else {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += THREADS / 32) {
      const int y = y0 - ph + r;
      for (int c = lane; c < PITCH; c += 32) {
        const int x = x0 - PAD + c;
        s_win[r * PITCH + c] =
            y >= 0 && y < H && x >= 0 && x < W ? src[(size_t)y * W + x] : In(0);
      }
    }
  }
  for (int i = tid; i < M * taps; i += THREADS) s_mask[i] = masks[i];
  copy_async_wait();
  __syncthreads();

  const int c = tid % TILE_W;
  const int x = x0 + c;
  if (x >= W) return;
  const In* col = s_win + (PAD - pw) + c;  // the window column of dx = 0
  for (int m = 0; m < M; ++m) {
    const Acc* mk_s = s_mask + m * taps;
    Acc mk[K ? K * K : 1];
    if constexpr (K > 0) {
#pragma unroll
      for (int t = 0; t < K * K; ++t) mk[t] = mk_s[t];
    }
    Acc* plane = out + ((size_t)n * M + m) * H * W + x;
    for (int s = tid / TILE_W; s < TILE_H / STRIP; s += STRIP_ROWS) {
      const int r0 = s * STRIP;
      const int left = H - (y0 + r0);  // rows of the strip inside the frame
      if (left <= 0) break;
      Acc acc[STRIP];
#pragma unroll
      for (int j = 0; j < STRIP; ++j) acc[j] = zero<Acc>();
      if constexpr (K > 0) {
        // input row r0 + k feeds output r0 + j at tap row dy = k - j
#pragma unroll
        for (int k = 0; k < STRIP + K - 1; ++k) {
          const In* row = col + (r0 + k) * PITCH;
          Acc v[K];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) v[dx] = widen<Acc>(row[dx]);
#pragma unroll
          for (int j = 0; j < STRIP; ++j) {
            const int dy = k - j;
            if (dy >= 0 && dy < K) {
#pragma unroll
              for (int dx = 0; dx < K; ++dx) acc[j] = mac(acc[j], mk[dy * K + dx], v[dx]);
            }
          }
        }
      } else {
        for (int k = 0; k < STRIP + kh - 1; ++k) {
          const In* row = col + (r0 + k) * PITCH;
          for (int dx = 0; dx < kw; ++dx) {
            const Acc v = widen<Acc>(row[dx]);
#pragma unroll
            for (int j = 0; j < STRIP; ++j) {
              const int dy = k - j;
              if (dy >= 0 && dy < kh) acc[j] = mac(acc[j], mk_s[dy * kw + dx], v);
            }
          }
        }
      }
      Acc* o = plane + (size_t)(y0 + r0) * W;
#pragma unroll
      for (int j = 0; j < STRIP; ++j)
        if (j < left) o[(size_t)j * W] = acc[j];
    }
  }
}

// The instance a mask shape takes: its side if square 3, 5 or 7, else 0
// (the generic one).
inline int instance_of(int kh, int kw) {
  return kh == kw && (kh == 3 || kh == 5 || kh == 7) ? kh : 0;
}

template <typename In, typename Acc, int K>
int launch_instance(const In* img, const Acc* masks, Acc* out, int N, int H, int W, int M,
                    int kh, int kw, cudaStream_t stream) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, N);
  const size_t smem = smem_bytes(K, sizeof(In), sizeof(Acc), M, kh, kw);
  const bool vec = (W * sizeof(In)) % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  conv2d_kernel<In, Acc, K><<<grid, THREADS, smem, stream>>>(img, masks, out, H, W, M, kh,
                                                              kw, vec);
  return (int)cudaGetLastError();
}

// instance: instance_of(kh, kw), or 0 (the generic instance takes any
// shape); anything else is refused.
template <typename In, typename Acc>
int launch(const In* img, const Acc* masks, Acc* out, int N, int H, int W, int M, int kh,
           int kw, int instance, cudaStream_t stream) {
  if (instance != 0 && instance != instance_of(kh, kw)) return (int)cudaErrorInvalidValue;
  switch (instance) {
    case 3: return launch_instance<In, Acc, 3>(img, masks, out, N, H, W, M, kh, kw, stream);
    case 5: return launch_instance<In, Acc, 5>(img, masks, out, N, H, W, M, kh, kw, stream);
    case 7: return launch_instance<In, Acc, 7>(img, masks, out, N, H, W, M, kh, kw, stream);
    default: return launch_instance<In, Acc, 0>(img, masks, out, N, H, W, M, kh, kw, stream);
  }
}

}  // namespace

extern "C" {

// One launch: (N, H, W) image, (M, kh, kw) masks in the accumulator type,
// (N, M, H, W) output; instance as launch() takes it.  Returns the launch's
// cudaGetLastError.
int conv2d_f32(const float* img, const float* masks, float* out, int N, int H,
               int W, int M, int kh, int kw, int instance, cudaStream_t stream) {
  return launch<float, float>(img, masks, out, N, H, W, M, kh, kw, instance, stream);
}

int conv2d_f16(const __half* img, const __half* masks, __half* out, int N,
               int H, int W, int M, int kh, int kw, int instance, cudaStream_t stream) {
  return launch<__half, __half>(img, masks, out, N, H, W, M, kh, kw, instance, stream);
}

int conv2d_i32(const int32_t* img, const int32_t* masks, int32_t* out, int N,
               int H, int W, int M, int kh, int kw, int instance, cudaStream_t stream) {
  return launch<int32_t, int32_t>(img, masks, out, N, H, W, M, kh, kw, instance, stream);
}

int conv2d_i8(const int8_t* img, const int32_t* masks, int32_t* out, int N,
              int H, int W, int M, int kh, int kw, int instance, cudaStream_t stream) {
  return launch<int8_t, int32_t>(img, masks, out, N, H, W, M, kh, kw, instance, stream);
}

// The launch plan of a call, as kernels/conv2d_gemm.py::launch_plan gives
// it: out[0..8] = instance (mask side, 0 generic), tile rows, tile
// columns, threads, grid x, y, z, shared bytes, 16-byte row copies (W *
// in_bytes a multiple of 16; the image's start is checked at launch).
void conv2d_plan(int in_bytes, int acc_bytes, int N, int H, int W, int M, int kh, int kw,
                 long long* out) {
  const int K = instance_of(kh, kw);
  const long long v[9] = {K,
                          TILE_H,
                          TILE_W,
                          THREADS,
                          (W + TILE_W - 1) / TILE_W,
                          (H + TILE_H - 1) / TILE_H,
                          N,
                          (long long)smem_bytes(K, in_bytes, acc_bytes, M, kh, kw),
                          (long long)(W * in_bytes) % 16 == 0};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
