// Hough voting: rho bins of every (pixel, theta), then a weighted histogram.
//
// Replaces the TPU kernel repro/kernels/hough_vote.py::hough_vote (body
// _vote_kernel).  The TPU has no cheap scattered read-modify-write, so it
// turns the histogram into a one-hot contraction per (rho, theta, pixel)
// block.  This card has fast atomics in L2, so here one thread takes one
// (compacted) pixel, walks a block of thetas, and atomically adds its weight
// into the f32 (N, n_rho, T) accumulator, which the wrapper zeroes.
//
// The rho product keeps the rounding of the reference's f32 dot (XLA's and
// torch's CPU matmul alike): rho = fadd(fma(y, sin, x * cos), z * diag).
// floor() turns any other nesting into moved votes (1046 rho bins at
// 720x1280 for the unfused (x*c + y*s) + d).  With 0/1 weights every bin is
// an integer below 2^24, so the sum is exact in any atomic order.
//
// What bounds it on this card: the scattered atomics and the output.  The
// work is count x T votes (about 4096 x 180 per dense frame at 720x1280),
// far fewer bytes than the 2938 x 180 f32 accumulator it must write.  The
// design reads only the rows that hold edges: a thread exits at once on
// weight 0 or on a row at or past its frame's edge count, which compaction
// leaves in device memory, so the host never learns the count.  A
// shared-memory histogram per theta block is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX_PER_BLOCK = 128;
constexpr int THETA_PER_BLOCK = 32;

__global__ void __launch_bounds__(PIX_PER_BLOCK)
hough_vote_kernel(const float* __restrict__ xy, long long xy_frame_stride,
                  const float* __restrict__ w, long long w_frame_stride,
                  const int32_t* __restrict__ counts,
                  const float* __restrict__ trig, float* __restrict__ out,
                  int P, int C, int T, int n_rho) {
  __shared__ float s_trig[3][THETA_PER_BLOCK];
  const int n = blockIdx.z;
  const int t0 = blockIdx.y * THETA_PER_BLOCK;
  const int nt = min(THETA_PER_BLOCK, T - t0);
  for (int i = threadIdx.x; i < C * THETA_PER_BLOCK; i += blockDim.x) {
    const int r = i / THETA_PER_BLOCK, k = i - r * THETA_PER_BLOCK;
    s_trig[r][k] = k < nt ? trig[(size_t)r * T + t0 + k] : 0.0f;
  }
  __syncthreads();

  const int p = blockIdx.x * PIX_PER_BLOCK + threadIdx.x;
  const int limit = counts != nullptr ? min(counts[n], P) : P;
  if (p >= limit) return;
  const float wt = w[n * w_frame_stride + p];
  if (wt == 0.0f) return;
  const float* q = xy + n * xy_frame_stride + (size_t)p * C;
  const float x = q[0], y = q[1];
  const float z = C == 3 ? q[2] : 0.0f;
  float* o = out + (size_t)n * n_rho * T + t0;
  const float rho_max = (float)n_rho;
  for (int k = 0; k < nt; ++k) {
    float rho = __fmaf_rn(y, s_trig[1][k], __fmul_rn(x, s_trig[0][k]));
    if (C == 3) rho = __fadd_rn(rho, __fmul_rn(z, s_trig[2][k]));
    const float bin = floorf(rho);
    if (bin >= 0.0f && bin < rho_max) atomicAdd(o + (size_t)(int)bin * T + k, wt);
  }
}

}  // namespace

extern "C" {

// xy: f32 rows of C in {2, 3} floats, frame n at xy + n * xy_frame_stride
// (0 for one raster shared by every frame); w: f32, frame n at
// w + n * w_frame_stride; counts: int32 (N,) edge counts or NULL for all P
// rows; trig: f32 (C, T); out: f32 (N, n_rho, T), zeroed by the caller.
int hough_vote_f32(const float* xy, long long xy_frame_stride, const float* w,
                   long long w_frame_stride, const int32_t* counts,
                   const float* trig, float* out, int N, int P, int C, int T,
                   int n_rho, cudaStream_t stream) {
  const dim3 grid((P + PIX_PER_BLOCK - 1) / PIX_PER_BLOCK,
                  (T + THETA_PER_BLOCK - 1) / THETA_PER_BLOCK, N);
  hough_vote_kernel<<<grid, PIX_PER_BLOCK, 0, stream>>>(
      xy, xy_frame_stride, w, w_frame_stride, counts, trig, out, P, C, T, n_rho);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
