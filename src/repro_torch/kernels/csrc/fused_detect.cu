// Fused detection front end: Canny -> edge threshold -> rho-corridor filter
// -> raster-order compaction, in one C entry (three short kernels).
//
// Replaces the TPU kernel repro/kernels/fused_detect.py::fused_detect (body
// _fused_kernel).  The TPU kernel holds one whole frame in VMEM and runs the
// staged jnp Canny on it, then a whole-frame prefix sum.  An SM has 228 KB of
// shared memory and a 720x1280 f32 frame is 3.7 MB, so here the frame is cut
// into 32x32 output tiles, each computed from a window with a halo:
//
//   image radius = conv radius (3) + NMS (1) + hysteresis_iters
//
// because every hysteresis pass spreads strong edges by one pixel (the
// "paper" variant's single dilation needs conv radius + 1).  Each plane of
// the window is computed once per block in shared memory, and a plane's
// pixels outside the frame are the zeros of the reference's padding at
// that stage: the image (the Gauss's same padding), the Gauss output (the
// Sobel pads nr, not the image), the magnitude (NMS and the border clear),
// and the strong/weak bits (the dilation's zero shift).
//
// The three kernels:
//   1. canny_tile_kernel: one block per tile; writes one 32-bit keep mask
//      per (row, tile column) segment, a warp ballot over a tile row;
//   2. scan_kernel: one block per frame; the exclusive prefix sum of the
//      segments' popcounts in raster order (row-major over (row, segment),
//      since 2-D tiles are not raster order), and the frame's count
//      min(total, max_edges);
//   3. scatter_kernel: one warp per segment ranks its kept pixels with
//      popc and writes (x, y, 1) and weight 1 to offset + rank below
//      max_edges (later edges are dropped, as the reference drops them);
//      extra blocks zero the rows from the count to max_edges.
//
// Arithmetic is that of the staged path on this card, so the fused edges
// equal the staged edges bit for bit: the conv tap order and __fmaf_rn
// chain of conv2d.cu with nr stored as f32 between the two convs; magnitude
// and direction in round-to-nearest IEEE steps as torch's eager ops take
// them (no contraction into FMAs; never build with --use_fast_math); the
// integer rewrite floors "// 159" and takes the L1 magnitude with the
// cross-multiplied tan tests; the corridor product rounds as the
// reference's K=2 dot does on the CPU, x*c and y*s each rounded, then one
// rounded add.
//
// What bounds it on this card: per pixel about 90 f32 operations of conv
// and magnitude against 4 bytes of image read, so the f32 rate, not the
// memory, is the floor (about 13 us for 720x1280x8).  This first design
// repeats the halo's work in every tile (a 56x56 window for a 32x32 tile
// at 8 hysteresis passes, about 3x the pixels of the tile), and the scan
// runs one block per frame.  Wider tiles, TMA loads and a single-pass
// decoupled look-back scan are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // output tile side; one warp spans a tile row
constexpr int BLOCK_Y = 8;    // warps per block
constexpr int NTHREADS = TILE * BLOCK_Y;
constexpr int SCAN_THREADS = 1024;
constexpr int SCATTER_THREADS = 256;
constexpr int GAUSS_NORM = 159;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on Hopper

// Window radii around the tile: strong/weak bits, magnitude, Gauss output,
// image.  The conv radius is 3 either way (5x5 Gauss + 3x3 Sobel, or the
// fused 7x7 masks).
struct Radii {
  int s, m, n, i;
};

__host__ __device__ inline Radii radii(int iters, bool paper) {
  Radii r;
  r.s = paper ? 1 : iters;
  r.m = paper ? 1 : iters + 1;
  r.n = r.m + 1;
  r.i = r.m + 3;
  return r;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline int side(int r) { return TILE + 2 * r; }

// Shared memory of one block: masks, image, Gauss output (unfused only),
// magnitude, direction (full variant only), two strong/weak bit planes.
// kernels/fused_detect.py::smem_bytes repeats this formula.
__host__ __device__ inline size_t smem_bytes(int iters, bool paper, bool fused) {
  const Radii r = radii(iters, paper);
  const size_t mask_vals = fused ? 3 * 49 : 25 + 2 * 9;
  const size_t sm = side(r.m), ss = side(r.s), si = side(r.i), sn = side(r.n);
  size_t b = align16(4 * mask_vals) + align16(4 * si * si);
  if (!fused) b += align16(4 * sn * sn);
  b += align16(4 * sm * sm);
  if (!paper) b += align16(sm * sm);
  return b + 2 * align16(ss * ss);
}

__device__ __forceinline__ float mac(float acc, float m, float v) {
  return __fmaf_rn(m, v, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int32_t m, int32_t v) {
  return acc + m * v;
}

template <typename Acc> __device__ __forceinline__ Acc from_image(float v);
template <> __device__ __forceinline__ float from_image<float>(float v) { return v; }
// torch's f32 -> int32 cast truncates toward zero
template <> __device__ __forceinline__ int32_t from_image<int32_t>(float v) {
  return static_cast<int32_t>(v);
}

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {  // b > 0
  int32_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

// The integer rewrite's "// GAUSS_NORM" after a conv; identity in f32.
__device__ __forceinline__ float norm_out(float v) { return v; }
__device__ __forceinline__ int32_t norm_out(int32_t v) { return floordiv(v, GAUSS_NORM); }

// |G| and the direction bin (0: E-W pair, 1: NE-SW, 2: N-S, 3: NW-SE).
__device__ __forceinline__ float magnitude(float gx, float gy, int* dir) {
  const float ax = fabsf(gx), ay = fabsf(gy);
  const float t = __fdiv_rn(ay, fmaxf(ax, 1e-9f));
  const bool d0 = t < 0.4140625f;   // 53/128 ~ tan 22.5
  const bool d90 = t >= 2.4140625f; // 309/128 ~ tan 67.5
  const bool same = (gx >= 0.0f) == (gy >= 0.0f);
  *dir = d0 ? 0 : (d90 ? 2 : (same ? 1 : 3));
  return __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
}
__device__ __forceinline__ int32_t magnitude(int32_t gx, int32_t gy, int* dir) {
  const int32_t ax = abs(gx), ay = abs(gy);
  const bool d0 = 128 * ay < 53 * ax;
  const bool d90 = 128 * ay >= 309 * ax;
  const bool same = (gx >= 0) == (gy >= 0);
  *dir = d0 ? 0 : (d90 ? 2 : (same ? 1 : 3));
  return ax + ay;  // L1: no sqrt in the integer pipeline
}

// torch compares a tensor with a Python float in f32.
__device__ __forceinline__ bool at_least(float v, float t) { return v >= t; }
__device__ __forceinline__ bool at_least(int32_t v, float t) { return (float)v >= t; }

__device__ __forceinline__ bool in_corridor(const float* __restrict__ cor, int n_cor,
                                            float x, float y) {
  for (int k = 0; k < n_cor; ++k) {
    const float* q = cor + 4 * k;
    const float rho = __fadd_rn(__fmul_rn(x, q[0]), __fmul_rn(y, q[1]));
    if (rho >= q[2] && rho <= q[3]) return true;
  }
  return false;
}

// Phase 1.  Bits of the s-planes: 1 = strong, 2 = weak (full) or edge
// (paper).  m0: the Gauss (1,5,5) or the fused (3,7,7) masks; m1: the
// Sobel pair (2,3,3) or unused.
template <typename Acc, bool FUSED, bool PAPER>
__global__ void __launch_bounds__(NTHREADS)
canny_tile_kernel(const float* __restrict__ img, const Acc* __restrict__ m0,
                  const Acc* __restrict__ m1, const float* __restrict__ cor,
                  int n_cor, uint32_t* __restrict__ keep_bits, int H, int W,
                  int nseg, float low, float high, float edge_thr, int border,
                  int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Radii R = radii(iters, PAPER);
  const int si = side(R.i), sn = side(R.n), sm = side(R.m), ss = side(R.s);
  constexpr int K0 = FUSED ? 7 : 5;
  constexpr int TAPS0 = K0 * K0;
  constexpr int NM0 = FUSED ? 3 : 1;
  constexpr int NM1 = FUSED ? 0 : 2;

  unsigned char* p = smem;
  Acc* s_m0 = reinterpret_cast<Acc*>(p);
  Acc* s_m1 = s_m0 + NM0 * TAPS0;
  p += align16(4 * (FUSED ? 3 * 49 : 25 + 2 * 9));
  Acc* s_img = reinterpret_cast<Acc*>(p);
  p += align16(4 * (size_t)si * si);
  Acc* s_nr = reinterpret_cast<Acc*>(p);
  if (!FUSED) p += align16(4 * (size_t)sn * sn);
  Acc* s_mag = reinterpret_cast<Acc*>(p);
  p += align16(4 * (size_t)sm * sm);
  uint8_t* s_dir = p;
  if (!PAPER) p += align16((size_t)sm * sm);
  uint8_t* s_b0 = p;
  uint8_t* s_b1 = p + align16((size_t)ss * ss);

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  for (int i = tid; i < NM0 * TAPS0; i += NTHREADS) s_m0[i] = m0[i];
  for (int i = tid; i < NM1 * 9; i += NTHREADS) s_m1[i] = m1[i];
  const float* src = img + (size_t)n * H * W;
  for (int i = tid; i < si * si; i += NTHREADS) {
    const int r = i / si, c = i - r * si;
    const int y = y0 - R.i + r, x = x0 - R.i + c;
    Acc v = Acc(0);
    if (y >= 0 && y < H && x >= 0 && x < W) v = from_image<Acc>(src[(size_t)y * W + x]);
    s_img[i] = v;
  }
  __syncthreads();

  if (!FUSED) {  // Gauss; nr outside the frame is the Sobel's zero padding
    for (int i = tid; i < sn * sn; i += NTHREADS) {
      const int r = i / sn, c = i - r * sn;
      const int y = y0 - R.n + r, x = x0 - R.n + c;
      Acc v = Acc(0);
      if (y >= 0 && y < H && x >= 0 && x < W) {
        Acc acc = Acc(0);
        for (int dy = 0; dy < 5; ++dy) {
          const Acc* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 5; ++dx) acc = mac(acc, s_m0[dy * 5 + dx], row[dx]);
        }
        v = norm_out(acc);
      }
      s_nr[i] = v;
    }
    __syncthreads();
  }

  // gradients -> magnitude (zero outside the frame and in the border) and
  // direction
  for (int i = tid; i < sm * sm; i += NTHREADS) {
    const int r = i / sm, c = i - r * sm;
    const int y = y0 - R.m + r, x = x0 - R.m + c;
    Acc mag = Acc(0);
    int dir = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      Acc gx = Acc(0), gy = Acc(0);
      if (FUSED) {
        for (int dy = 0; dy < 7; ++dy) {
          const Acc* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 7; ++dx) gx = mac(gx, s_m0[TAPS0 + dy * 7 + dx], row[dx]);
        }
        for (int dy = 0; dy < 7; ++dy) {
          const Acc* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 7; ++dx) gy = mac(gy, s_m0[2 * TAPS0 + dy * 7 + dx], row[dx]);
        }
        gx = norm_out(gx);
        gy = norm_out(gy);
      } else {
        for (int dy = 0; dy < 3; ++dy) {
          const Acc* row = s_nr + (r + dy) * sn + c;
          for (int dx = 0; dx < 3; ++dx) gx = mac(gx, s_m1[dy * 3 + dx], row[dx]);
        }
        for (int dy = 0; dy < 3; ++dy) {
          const Acc* row = s_nr + (r + dy) * sn + c;
          for (int dx = 0; dx < 3; ++dx) gy = mac(gy, s_m1[9 + dy * 3 + dx], row[dx]);
        }
      }
      mag = magnitude(gx, gy, &dir);
      if (!(y >= border && y < H - border && x >= border && x < W - border)) mag = Acc(0);
    }
    s_mag[i] = mag;
    if (!PAPER) s_dir[i] = (uint8_t)dir;
  }
  __syncthreads();

  // strong/weak (or strong/edge) bits; false outside the frame
  const int off = R.m - R.s;
  for (int i = tid; i < ss * ss; i += NTHREADS) {
    const int r = i / ss, c = i - r * ss;
    const int y = y0 - R.s + r, x = x0 - R.s + c;
    uint8_t b = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int rr = r + off, cc = c + off;
      const Acc m = s_mag[rr * sm + cc];
      if (PAPER) {
        const bool edge = at_least(m, low);
        b = (uint8_t)((edge && at_least(m, high)) | (edge << 1));
      } else {
        int r1, c1, r2, c2;
        switch (s_dir[rr * sm + cc]) {
          case 0: r1 = rr; c1 = cc + 1; r2 = rr; c2 = cc - 1; break;
          case 1: r1 = rr - 1; c1 = cc + 1; r2 = rr + 1; c2 = cc - 1; break;
          case 2: r1 = rr + 1; c1 = cc; r2 = rr - 1; c2 = cc; break;
          default: r1 = rr + 1; c1 = cc + 1; r2 = rr - 1; c2 = cc - 1; break;
        }
        const bool keep = m >= s_mag[r1 * sm + c1] && m >= s_mag[r2 * sm + c2];
        const Acc sup = keep ? m : Acc(0);
        const bool strong = at_least(sup, high);
        const bool weak = at_least(sup, low) && !strong;
        b = (uint8_t)(strong | (weak << 1));
      }
    }
    s_b0[i] = b;
  }
  __syncthreads();

  // Hysteresis, one synchronous (Jacobi) pass at a time: pass k updates the
  // window of radius R.s - k - 1 from the previous pass's values, so the
  // tile is exact after the last pass.
  uint8_t* cur = s_b0;
  uint8_t* nxt = s_b1;
  if (!PAPER) {
    for (int k = 0; k < iters; ++k) {
      const int lo = k + 1, span = ss - 2 * (k + 1);
      for (int i = tid; i < span * span; i += NTHREADS) {
        const int rr = lo + i / span, cc = lo + i % span;
        uint8_t b = cur[rr * ss + cc];
        if (b == 2) {  // weak and not yet strong
          const uint8_t* u = cur + (rr - 1) * ss + cc;
          const uint8_t* d = cur + (rr + 1) * ss + cc;
          const uint8_t* h = cur + rr * ss + cc;
          if ((u[-1] | u[0] | u[1] | h[-1] | h[1] | d[-1] | d[0] | d[1]) & 1) b = 3;
        }
        nxt[rr * ss + cc] = b;
      }
      __syncthreads();
      uint8_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  // edge weight -> corridor -> one keep word per tile row
  const int x = x0 + threadIdx.x;
  for (int ry = threadIdx.y; ry < TILE; ry += BLOCK_Y) {
    const int y = y0 + ry;
    bool keep = false;
    if (y < H && x < W) {
      const int rr = ry + R.s, cc = threadIdx.x + R.s;
      const uint8_t* h = cur + rr * ss + cc;
      bool edge = h[0] & 1;
      if (PAPER && !edge && (h[0] & 2)) {
        const uint8_t* u = h - ss;
        const uint8_t* d = h + ss;
        edge = (u[-1] | u[0] | u[1] | h[-1] | h[1] | d[-1] | d[0] | d[1]) & 1;
      }
      keep = (edge ? 255.0f : 0.0f) >= edge_thr;
      if (keep && n_cor > 0) keep = in_corridor(cor, n_cor, (float)x, (float)y);
    }
    const uint32_t word = __ballot_sync(0xffffffffu, keep);
    if (threadIdx.x == 0 && y < H) keep_bits[((size_t)n * H + y) * nseg + blockIdx.x] = word;
  }
}

// Phase 2: exclusive raster-order scan of one frame's segment popcounts.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const uint32_t* __restrict__ keep_bits, int32_t* __restrict__ offsets,
            int32_t* __restrict__ counts, int S, int max_edges) {
  __shared__ int32_t warp_sums[SCAN_THREADS / 32];
  __shared__ int32_t s_total;
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const uint32_t* b = keep_bits + (size_t)n * S;
  int32_t* o = offsets + (size_t)n * S;
  const int per = (S + SCAN_THREADS - 1) / SCAN_THREADS;
  const int beg = min(tid * per, S), end = min(beg + per, S);
  int32_t sum = 0;
  for (int i = beg; i < end; ++i) sum += __popc(b[i]);
  int32_t incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int32_t v = warp_sums[lane];
    int32_t w = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w - v;
    if (lane == 31) s_total = w;
  }
  __syncthreads();
  int32_t run = warp_sums[wid] + incl - sum;
  for (int i = beg; i < end; ++i) {
    o[i] = run;
    run += __popc(b[i]);
  }
  if (tid == 0) counts[n] = min(s_total, max_edges);
}

// Phase 3: blocks [0, seg_blocks) scatter one segment per warp; the rest
// zero the rows from each frame's count to max_edges.
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_kernel(const uint32_t* __restrict__ keep_bits, const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ counts, float* __restrict__ cxy,
               float* __restrict__ cw, int N, int H, int nseg, int max_edges,
               int seg_blocks) {
  if ((int)blockIdx.x < seg_blocks) {
    const long long seg = (long long)blockIdx.x * (SCATTER_THREADS / 32) + (threadIdx.x >> 5);
    if (seg >= (long long)N * H * nseg) return;
    const int lane = threadIdx.x & 31;
    const uint32_t word = keep_bits[seg];
    if (!((word >> lane) & 1u)) return;
    const int slot = offsets[seg] + __popc(word & ((1u << lane) - 1u));
    if (slot >= max_edges) return;  // overflow: trailing edges drop
    const long long per_frame = (long long)H * nseg;
    const int n = (int)(seg / per_frame);
    const int rem = (int)(seg - n * per_frame);
    const int y = rem / nseg, s = rem - y * nseg;
    const size_t row = (size_t)n * max_edges + slot;
    cxy[row * 3 + 0] = (float)(s * 32 + lane);
    cxy[row * 3 + 1] = (float)y;
    cxy[row * 3 + 2] = 1.0f;
    cw[row] = 1.0f;
    return;
  }
  const long long j = (long long)(blockIdx.x - seg_blocks) * SCATTER_THREADS + threadIdx.x;
  if (j >= (long long)N * max_edges) return;
  const int n = (int)(j / max_edges);
  if (j - (long long)n * max_edges < counts[n]) return;
  cw[j] = 0.0f;
  cxy[j * 3 + 0] = 0.0f;
  cxy[j * 3 + 1] = 0.0f;
  cxy[j * 3 + 2] = 0.0f;
}

template <typename Acc, bool FUSED, bool PAPER>
int launch_tiles(const float* img, const void* m0, const void* m1, const float* cor,
                 int n_cor, uint32_t* keep_bits, int N, int H, int W, int nseg,
                 float low, float high, float edge_thr, int border, int iters,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(iters, PAPER, FUSED);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = canny_tile_kernel<Acc, FUSED, PAPER>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nseg, (H + TILE - 1) / TILE, N);
  kernel<<<grid, dim3(TILE, BLOCK_Y), smem, stream>>>(
      img, static_cast<const Acc*>(m0), static_cast<const Acc*>(m1), cor, n_cor,
      keep_bits, H, W, nseg, low, high, edge_thr, border, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: f32 (N, H, W); m0/m1: the config's conv masks on the card, f32 or
// int32 (integer != 0), m1 NULL for the fused 7x7 set; cor: f32 (n_cor, 4)
// rows [cos, sin, rho_lo, rho_hi] or NULL (n_cor 0); keep_bits/offsets:
// scratch of N * H * ceil(W / 32) words; cxy (N, max_edges, 3), cw
// (N, max_edges), counts (N,) are written in full.
int fused_detect(const float* img, const void* m0, const void* m1, int integer,
                 int fused, int paper, const float* cor, int n_cor,
                 uint32_t* keep_bits, int32_t* offsets, float* cxy, float* cw,
                 int32_t* counts, int N, int H, int W, int max_edges, float low,
                 float high, float edge_thr, int border, int iters,
                 cudaStream_t stream) {
  if (iters < 0) iters = 0;
  const int nseg = (W + TILE - 1) / TILE;
  int rc;
#define FD_TILES(ACC, FU, PA)                                                   \
  launch_tiles<ACC, FU, PA>(img, m0, m1, cor, n_cor, keep_bits, N, H, W, nseg, \
                            low, high, edge_thr, border, iters, stream)
  if (integer) {
    if (fused) rc = paper ? FD_TILES(int32_t, true, true) : FD_TILES(int32_t, true, false);
    else rc = paper ? FD_TILES(int32_t, false, true) : FD_TILES(int32_t, false, false);
  } else {
    if (fused) rc = paper ? FD_TILES(float, true, true) : FD_TILES(float, true, false);
    else rc = paper ? FD_TILES(float, false, true) : FD_TILES(float, false, false);
  }
#undef FD_TILES
  if (rc != 0) return rc;
  const int S = H * nseg;
  scan_kernel<<<N, SCAN_THREADS, 0, stream>>>(keep_bits, offsets, counts, S, max_edges);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long segs = (long long)N * S;
  const int seg_blocks = (int)((segs + SCATTER_THREADS / 32 - 1) / (SCATTER_THREADS / 32));
  const int zero_blocks =
      (int)(((long long)N * max_edges + SCATTER_THREADS - 1) / SCATTER_THREADS);
  scatter_kernel<<<seg_blocks + zero_blocks, SCATTER_THREADS, 0, stream>>>(
      keep_bits, offsets, counts, cxy, cw, N, H, nseg, max_edges, seg_blocks);
  return (int)cudaGetLastError();
}

size_t fused_detect_smem_bytes(int iters, int paper, int fused) {
  return smem_bytes(iters < 0 ? 0 : iters, paper != 0, fused != 0);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
