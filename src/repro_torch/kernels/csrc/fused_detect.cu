// Fused detection front end: Canny -> edge threshold -> rho-corridor filter
// -> raster-order compaction, in one C entry (three short kernels, a
// pre-pass for the int8 gradient tier, and for a long hysteresis two more
// kernels, below).
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
// The three kernels (after the int8 tier's pre-pass):
//   1. canny_tile_kernel: one block per tile; writes one 32-bit keep mask
//      per (row, tile column) segment, a warp ballot over a tile row (or,
//      for a long hysteresis, each pixel's strong/weak state: below);
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
// A long hysteresis.  The window's side is 32 + 2 (iters + 4) and every
// in-tile pass sweeps it, and past 44 passes (54 with the fused 7x7 masks)
// its planes no longer fit the 227 KB of shared memory a block may use
// (smem_bytes > MAX_SMEM).  Such a config, and only such a config, sends
// the hysteresis through two (N, H, W) planes of one byte a pixel that the
// caller allocates: the tile kernel runs at halo 0 (no in-tile passes) and
// writes each pixel's strong/weak bits; hysteresis_kernel then runs up to
// HYST_HALO Jacobi passes a launch, each HYST_TILE core read with a halo
// of HYST_HALO (zeros outside the frame, the reference's zero-shifted
// dilation), ping-ponging between the planes until every pass is done;
// keep_kernel applies the edge threshold and the corridors to the final
// plane and writes the same keep words, and the scan and scatter follow.
// Jacobi passes compose exactly, so the edges are those of the tile path
// and of the staged detector at any pass count.  Every config that fits
// keeps the single tile kernel, the 8-pass default among them.
//
// The gradient tiers (CannyConfig.grad_dtype) take the same route.  f16:
// the frame cast to f16, each conv an __hfma chain in conv2d.cu's tap
// order, nr kept in f16, the gradients upcast to f32 before the magnitude.
// int8: the frame quantized per frame (round(v / s1) half to even, clipped),
// integer convs, and canny.py's dequantize / requantize in its order.  Its
// two scales are frame-wide, so no tile can start before they are known:
// a pre-pass reduces max|image| per frame (s1), and, for the Gauss + Sobel
// masks, max|nr_q| of the integer Gauss conv of the quantized frame, which
// gives s2 = max(fl(max|nr_q| * fl(s1 / 159)), 1e-12) / 127 exactly (the
// reference's amax(|nr|), since multiplying by a positive f32 is monotone).
// The maxima stay on the card; each tile block derives the scales itself.
//
// What bounds it on this card: per pixel about 90 f32 operations of conv
// and magnitude against 4 bytes of image read, so the f32 rate, not the
// memory, is the floor (about 13 us for 720x1280x8).  This first design
// repeats the halo's work in every tile (a 56x56 window for a 32x32 tile
// at 8 hysteresis passes, about 3x the pixels of the tile), and the scan
// runs one block per frame.  Wider tiles, TMA loads and a single-pass
// decoupled look-back scan are later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // output tile side; one warp spans a tile row
constexpr int BLOCK_Y = 8;    // warps per block
constexpr int NTHREADS = TILE * BLOCK_Y;
constexpr int SCAN_THREADS = 1024;
constexpr int SCATTER_THREADS = 256;
constexpr int PRE_THREADS = 256;
constexpr int GAUSS_NORM = 159;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on Hopper
constexpr int HYST_TILE = 64;        // a hysteresis launch's core tile side
constexpr int HYST_HALO = 16;        // its halo: the most passes one launch runs
constexpr int HYST_SIDE = HYST_TILE + 2 * HYST_HALO;
constexpr int HYST_ROWS = 16;        // warps a hysteresis block

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

// The gradient tiers (CannyConfig): each stage's arithmetic type.
//   F32: the float pipeline; INT: the paper's integer rewrite
//   (integer=True); F16: grad_dtype="f16", the convs in f16 with __hfma;
//   I8: grad_dtype="int8", the convs on per-frame int8 quantized values
//   in int32, dequantized to f32 between the stages.
enum Tier { T_F32 = 0, T_INT = 1, T_F16 = 2, T_I8 = 3 };
template <int TIER> struct TierTypes {     // F32
  using Conv = float;                      // image, masks, conv sums, nr
  using Mag = float;                       // gradients and magnitude
};
template <> struct TierTypes<T_INT> { using Conv = int32_t; using Mag = int32_t; };
template <> struct TierTypes<T_F16> { using Conv = __half; using Mag = float; };
template <> struct TierTypes<T_I8> { using Conv = int32_t; using Mag = float; };

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __half zero<__half>() { return __float2half(0.0f); }

__device__ __forceinline__ float mac(float acc, float m, float v) {
  return __fmaf_rn(m, v, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int32_t m, int32_t v) {
  return acc + m * v;
}
__device__ __forceinline__ __half mac(__half acc, __half m, __half v) {
  return __hfma(m, v, acc);  // conv2d.cu's f16 chain, tap for tap
}

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {  // b > 0
  int32_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

// quantize_frames on one value: round(v / s) half to even, clipped to int8
__device__ __forceinline__ int32_t quantize8(float v, float s) {
  return (int32_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.0f), 127.0f);
}

// core/quantize.py's scale: max(amax, 1e-12) / 127, one rounding
__device__ __forceinline__ float scale8(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

// The int8 tier's per-frame scales, in canny.py's order: s1 of the image,
// c1 = s1 / 159 (the Gauss's dequantization), s2 of the Gauss output.
// max|nr| is max|nr_q| * c1 rounded once, since x -> fl(x * c1) is monotone.
struct Scales {
  float s1, c1, s2;
};

__device__ __forceinline__ Scales frame_scales(const uint32_t* amax_bits, const int32_t* nr_max,
                                               int n) {
  Scales sc;
  sc.s1 = scale8(__uint_as_float(amax_bits[n]));
  sc.c1 = __fdiv_rn(sc.s1, (float)GAUSS_NORM);
  sc.s2 = nr_max ? scale8(__fmul_rn((float)nr_max[n], sc.c1)) : 0.0f;
  return sc;
}

// A frame pixel as the tier's conv input: f32 as it is, the integer
// rewrite's truncating int32 cast, the f16 cast (to nearest), or the int8
// quantization at the frame's scale.
template <int TIER>
__device__ __forceinline__ typename TierTypes<TIER>::Conv from_image(float v, const Scales& sc) {
  if constexpr (TIER == T_F32) return v;
  else if constexpr (TIER == T_INT) return static_cast<int32_t>(v);
  else if constexpr (TIER == T_F16) return __float2half_rn(v);
  else return quantize8(v, sc.s1);
}

// The Gauss output as the Sobel's input: the integer rewrite's "// 159",
// or the int8 tier's dequantize (nr = nr_q * c1) and requantize at s2.
template <int TIER>
__device__ __forceinline__ typename TierTypes<TIER>::Conv gauss_out(
    typename TierTypes<TIER>::Conv acc, const Scales& sc) {
  if constexpr (TIER == T_INT) return floordiv(acc, GAUSS_NORM);
  else if constexpr (TIER == T_I8) return quantize8(__fmul_rn((float)acc, sc.c1), sc.s2);
  else return acc;
}

// A gradient sum as the magnitude's input: f16 upcast to f32, the int8
// tier dequantized (the fused masks by c1, the Sobel by s2), the integer
// rewrite's fused masks floored "// 159".
template <int TIER, bool FUSED>
__device__ __forceinline__ typename TierTypes<TIER>::Mag grad_out(
    typename TierTypes<TIER>::Conv acc, const Scales& sc) {
  if constexpr (TIER == T_INT) return FUSED ? floordiv(acc, GAUSS_NORM) : acc;
  else if constexpr (TIER == T_F16) return __half2float(acc);
  else if constexpr (TIER == T_I8) return __fmul_rn((float)acc, FUSED ? sc.c1 : sc.s2);
  else return acc;
}

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
// Sobel pair (2,3,3) or unused; both in the tier's conv type.  amax_bits
// and nr_max: the int8 tier's per-frame maxima from the pre-pass.  STATE
// (the long-hysteresis path, launched at iters 0): write each pixel's bits
// to the (N, H, W) plane `state` in place of keep words.
template <int TIER, bool FUSED, bool PAPER, bool STATE>
__global__ void __launch_bounds__(NTHREADS)
canny_tile_kernel(const float* __restrict__ img,
                  const typename TierTypes<TIER>::Conv* __restrict__ m0,
                  const typename TierTypes<TIER>::Conv* __restrict__ m1,
                  const float* __restrict__ cor, int n_cor,
                  const uint32_t* __restrict__ amax_bits, const int32_t* __restrict__ nr_max,
                  uint32_t* __restrict__ keep_bits, uint8_t* __restrict__ state, int H, int W,
                  int nseg, float low, float high, float edge_thr, int border, int iters) {
  using Conv = typename TierTypes<TIER>::Conv;
  using Mag = typename TierTypes<TIER>::Mag;
  extern __shared__ __align__(16) unsigned char smem[];
  const Radii R = radii(iters, PAPER);
  const int si = side(R.i), sn = side(R.n), sm = side(R.m), ss = side(R.s);
  constexpr int K0 = FUSED ? 7 : 5;
  constexpr int TAPS0 = K0 * K0;
  constexpr int NM0 = FUSED ? 3 : 1;
  constexpr int NM1 = FUSED ? 0 : 2;

  // every plane is sized for 4-byte values; f16 uses half of its slot
  unsigned char* p = smem;
  Conv* s_m0 = reinterpret_cast<Conv*>(p);
  Conv* s_m1 = s_m0 + NM0 * TAPS0;
  p += align16(4 * (FUSED ? 3 * 49 : 25 + 2 * 9));
  Conv* s_img = reinterpret_cast<Conv*>(p);
  p += align16(4 * (size_t)si * si);
  Conv* s_nr = reinterpret_cast<Conv*>(p);
  if (!FUSED) p += align16(4 * (size_t)sn * sn);
  Mag* s_mag = reinterpret_cast<Mag*>(p);
  p += align16(4 * (size_t)sm * sm);
  uint8_t* s_dir = p;
  if (!PAPER) p += align16((size_t)sm * sm);
  uint8_t* s_b0 = p;
  uint8_t* s_b1 = p + align16((size_t)ss * ss);

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  Scales sc{0.0f, 0.0f, 0.0f};
  if constexpr (TIER == T_I8) sc = frame_scales(amax_bits, FUSED ? nullptr : nr_max, n);

  for (int i = tid; i < NM0 * TAPS0; i += NTHREADS) s_m0[i] = m0[i];
  for (int i = tid; i < NM1 * 9; i += NTHREADS) s_m1[i] = m1[i];
  const float* src = img + (size_t)n * H * W;
  for (int i = tid; i < si * si; i += NTHREADS) {
    const int r = i / si, c = i - r * si;
    const int y = y0 - R.i + r, x = x0 - R.i + c;
    Conv v = zero<Conv>();
    if (y >= 0 && y < H && x >= 0 && x < W) v = from_image<TIER>(src[(size_t)y * W + x], sc);
    s_img[i] = v;
  }
  __syncthreads();

  if (!FUSED) {  // Gauss; nr outside the frame is the Sobel's zero padding
    for (int i = tid; i < sn * sn; i += NTHREADS) {
      const int r = i / sn, c = i - r * sn;
      const int y = y0 - R.n + r, x = x0 - R.n + c;
      Conv v = zero<Conv>();
      if (y >= 0 && y < H && x >= 0 && x < W) {
        Conv acc = zero<Conv>();
        for (int dy = 0; dy < 5; ++dy) {
          const Conv* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 5; ++dx) acc = mac(acc, s_m0[dy * 5 + dx], row[dx]);
        }
        v = gauss_out<TIER>(acc, sc);
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
    Mag mag = Mag(0);
    int dir = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      Conv gx = zero<Conv>(), gy = zero<Conv>();
      if (FUSED) {
        for (int dy = 0; dy < 7; ++dy) {
          const Conv* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 7; ++dx) gx = mac(gx, s_m0[TAPS0 + dy * 7 + dx], row[dx]);
        }
        for (int dy = 0; dy < 7; ++dy) {
          const Conv* row = s_img + (r + dy) * si + c;
          for (int dx = 0; dx < 7; ++dx) gy = mac(gy, s_m0[2 * TAPS0 + dy * 7 + dx], row[dx]);
        }
      } else {
        for (int dy = 0; dy < 3; ++dy) {
          const Conv* row = s_nr + (r + dy) * sn + c;
          for (int dx = 0; dx < 3; ++dx) gx = mac(gx, s_m1[dy * 3 + dx], row[dx]);
        }
        for (int dy = 0; dy < 3; ++dy) {
          const Conv* row = s_nr + (r + dy) * sn + c;
          for (int dx = 0; dx < 3; ++dx) gy = mac(gy, s_m1[9 + dy * 3 + dx], row[dx]);
        }
      }
      mag = magnitude(grad_out<TIER, FUSED>(gx, sc), grad_out<TIER, FUSED>(gy, sc), &dir);
      if (!(y >= border && y < H - border && x >= border && x < W - border)) mag = Mag(0);
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
      const Mag m = s_mag[rr * sm + cc];
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
        const Mag sup = keep ? m : Mag(0);
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

  const int x = x0 + threadIdx.x;
  if constexpr (STATE) {
    for (int ry = threadIdx.y; ry < TILE; ry += BLOCK_Y) {
      const int y = y0 + ry;
      if (y < H && x < W) state[((size_t)n * H + y) * W + x] = cur[(ry + R.s) * ss + threadIdx.x + R.s];
    }
    return;
  }

  // edge weight -> corridor -> one keep word per tile row
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

// The long-hysteresis path, 1: up to HYST_HALO Jacobi passes over one
// HYST_TILE core, read from `src` with a halo of HYST_HALO (zeros outside
// the frame), written to `dst`.  Pass k of `passes` updates the window of
// radius passes - k - 1 around the core from the previous pass's values,
// as canny_tile_kernel's passes do; a warp walks each window row.
__global__ void __launch_bounds__(32 * HYST_ROWS)
hysteresis_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W,
                  int passes) {
  __shared__ uint8_t s_b0[HYST_SIDE * HYST_SIDE];
  __shared__ uint8_t s_b1[HYST_SIDE * HYST_SIDE];
  const int n = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * HYST_TILE, y0 = blockIdx.y * HYST_TILE;
  const uint8_t* in = src + (size_t)n * H * W;
  for (int r = ty; r < HYST_SIDE; r += HYST_ROWS) {
    const int y = y0 - HYST_HALO + r;
    for (int c = tx; c < HYST_SIDE; c += 32) {
      const int x = x0 - HYST_HALO + c;
      s_b0[r * HYST_SIDE + c] = (y >= 0 && y < H && x >= 0 && x < W) ? in[(size_t)y * W + x] : 0;
    }
  }
  __syncthreads();
  uint8_t* cur = s_b0;
  uint8_t* nxt = s_b1;
  for (int k = 0; k < passes; ++k) {
    const int lo = HYST_HALO - passes + k + 1, hi = HYST_SIDE - lo;
    for (int rr = lo + ty; rr < hi; rr += HYST_ROWS) {
      for (int cc = lo + tx; cc < hi; cc += 32) {
        uint8_t b = cur[rr * HYST_SIDE + cc];
        if (b == 2) {  // weak and not yet strong
          const uint8_t* u = cur + (rr - 1) * HYST_SIDE + cc;
          const uint8_t* d = cur + (rr + 1) * HYST_SIDE + cc;
          const uint8_t* h = cur + rr * HYST_SIDE + cc;
          if ((u[-1] | u[0] | u[1] | h[-1] | h[1] | d[-1] | d[0] | d[1]) & 1) b = 3;
        }
        nxt[rr * HYST_SIDE + cc] = b;
      }
    }
    __syncthreads();
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  uint8_t* out = dst + (size_t)n * H * W;
  for (int r = ty; r < HYST_TILE; r += HYST_ROWS) {
    const int y = y0 + r;
    for (int c = tx; c < HYST_TILE; c += 32) {
      const int x = x0 + c;
      if (y < H && x < W) out[(size_t)y * W + x] = cur[(r + HYST_HALO) * HYST_SIDE + c + HYST_HALO];
    }
  }
}

// The long-hysteresis path, 2: the final plane -> edge weight -> corridor
// -> one keep word per (row, 32-pixel segment), a warp ballot each, as
// canny_tile_kernel's last step.
__global__ void __launch_bounds__(NTHREADS)
keep_kernel(const uint8_t* __restrict__ state, const float* __restrict__ cor, int n_cor,
            uint32_t* __restrict__ keep_bits, int H, int W, int nseg, float edge_thr) {
  const int n = blockIdx.z, x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (y >= H) return;  // a whole warp: one row
  bool keep = false;
  if (x < W) {
    const bool edge = state[((size_t)n * H + y) * W + x] & 1;
    keep = (edge ? 255.0f : 0.0f) >= edge_thr;
    if (keep && n_cor > 0) keep = in_corridor(cor, n_cor, (float)x, (float)y);
  }
  const uint32_t word = __ballot_sync(0xffffffffu, keep);
  if (threadIdx.x == 0) keep_bits[((size_t)n * H + y) * nseg + blockIdx.x] = word;
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

// Pre-pass of the int8 tier, 1: max|image| of each frame into
// amax_bits[n], as the bits of a non-negative float (which order as
// unsigned ints, so atomicMax takes them).
__global__ void __launch_bounds__(PRE_THREADS)
frame_amax_kernel(const float* __restrict__ img, uint32_t* __restrict__ amax_bits,
                  long long hw) {
  const float* src = img + (size_t)blockIdx.y * hw;
  float m = 0.0f;
  for (long long i = (long long)blockIdx.x * PRE_THREADS + threadIdx.x; i < hw;
       i += (long long)gridDim.x * PRE_THREADS)
    m = fmaxf(m, fabsf(src[i]));
  __shared__ float warp_max[PRE_THREADS / 32];
  for (int d = 16; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < PRE_THREADS / 32; ++k) m = fmaxf(m, warp_max[k]);
    atomicMax(amax_bits + blockIdx.y, __float_as_uint(m));
  }
}

// Pre-pass of the int8 tier, 2 (Gauss + Sobel masks only): max|nr_q| of
// each frame, nr_q the integer Gauss conv of the frame quantized at its
// scale s1, one 32x32 tile a block, into nr_max[n].
__global__ void __launch_bounds__(NTHREADS)
gauss_qmax_kernel(const float* __restrict__ img, const int32_t* __restrict__ gauss,
                  const uint32_t* __restrict__ amax_bits, int32_t* __restrict__ nr_max,
                  int H, int W) {
  constexpr int S = TILE + 4;
  __shared__ int32_t s_img[S * S];
  __shared__ int32_t s_g[25];
  __shared__ int32_t s_max[BLOCK_Y];
  const int n = blockIdx.z, x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const float s1 = scale8(__uint_as_float(amax_bits[n]));
  if (tid < 25) s_g[tid] = gauss[tid];
  const float* src = img + (size_t)n * H * W;
  for (int i = tid; i < S * S; i += NTHREADS) {
    const int r = i / S, c = i - r * S;
    const int y = y0 - 2 + r, x = x0 - 2 + c;
    s_img[i] = (y >= 0 && y < H && x >= 0 && x < W) ? quantize8(src[(size_t)y * W + x], s1) : 0;
  }
  __syncthreads();
  int32_t m = 0;
  const int x = x0 + threadIdx.x;
  for (int ry = threadIdx.y; ry < TILE; ry += BLOCK_Y) {
    if (y0 + ry >= H || x >= W) break;
    int32_t acc = 0;
    for (int dy = 0; dy < 5; ++dy)
      for (int dx = 0; dx < 5; ++dx) acc += s_g[dy * 5 + dx] * s_img[(ry + dy) * S + threadIdx.x + dx];
    m = max(m, abs(acc));
  }
  for (int d = 16; d; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (threadIdx.x == 0) s_max[threadIdx.y] = m;
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < BLOCK_Y; ++k) m = max(m, s_max[k]);
    atomicMax(nr_max + n, m);
  }
}

#define FD_TILE_PARAMS                                                                \
  const float *img, const void *m0, const void *m1, const float *cor, int n_cor,      \
      const uint32_t *amax_bits, const int32_t *nr_max, uint32_t *keep_bits,          \
      uint8_t *state0, uint8_t *state1, int N, int H, int W, int nseg, float low,     \
      float high, float edge_thr, int border, int iters, cudaStream_t stream
#define FD_TILE_ARGS                                                                  \
  img, m0, m1, cor, n_cor, amax_bits, nr_max, keep_bits, state0, state1, N, H, W,     \
      nseg, low, high, edge_thr, border, iters, stream

// One launch of canny_tile_kernel at `iters` in-tile passes.
template <int TIER, bool FUSED, bool PAPER, bool STATE>
int launch_tile_kernel(FD_TILE_PARAMS) {
  using Conv = typename TierTypes<TIER>::Conv;
  const size_t smem = smem_bytes(iters, PAPER, FUSED);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = canny_tile_kernel<TIER, FUSED, PAPER, STATE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nseg, (H + TILE - 1) / TILE, N);
  kernel<<<grid, dim3(TILE, BLOCK_Y), smem, stream>>>(
      img, static_cast<const Conv*>(m0), static_cast<const Conv*>(m1), cor, n_cor, amax_bits,
      nr_max, keep_bits, state0, H, W, nseg, low, high, edge_thr, border, iters);
  return (int)cudaGetLastError();
}

// The long-hysteresis path (the full variant only: the paper variant's
// window does not grow with iters): the tile kernel's bits into state0,
// ceil(iters / HYST_HALO) hysteresis launches between the two planes, the
// keep words from the last.
template <int TIER, bool FUSED>
int launch_long_hysteresis(FD_TILE_PARAMS) {
  const int passes = iters;
  iters = 0;
  int rc = launch_tile_kernel<TIER, FUSED, false, true>(FD_TILE_ARGS);
  if (rc != 0) return rc;
  uint8_t* src = state0;
  uint8_t* dst = state1;
  const dim3 grid((W + HYST_TILE - 1) / HYST_TILE, (H + HYST_TILE - 1) / HYST_TILE, N);
  for (int done = 0; done < passes; done += HYST_HALO) {
    const int p = passes - done < HYST_HALO ? passes - done : HYST_HALO;
    hysteresis_kernel<<<grid, dim3(32, HYST_ROWS), 0, stream>>>(src, dst, H, W, p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    uint8_t* t = src;
    src = dst;
    dst = t;
  }
  keep_kernel<<<dim3(nseg, (H + BLOCK_Y - 1) / BLOCK_Y, N), dim3(TILE, BLOCK_Y), 0, stream>>>(
      src, cor, n_cor, keep_bits, H, W, nseg, edge_thr);
  return (int)cudaGetLastError();
}

// The path is the tile's wherever its window fits shared memory, else the
// planes'; the planes are given exactly when they are needed.
template <int TIER, bool FUSED, bool PAPER>
int launch_tiles(FD_TILE_PARAMS) {
  const bool planes = smem_bytes(iters, PAPER, FUSED) > MAX_SMEM;
  if (planes != (state0 != nullptr) || (state0 == nullptr) != (state1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!planes) return launch_tile_kernel<TIER, FUSED, PAPER, false>(FD_TILE_ARGS);
  if constexpr (PAPER) return (int)cudaErrorInvalidValue;  // its window never grows
  else return launch_long_hysteresis<TIER, FUSED>(FD_TILE_ARGS);
}

template <int TIER>
int launch_tier(bool fused, bool paper, FD_TILE_PARAMS) {
  if (fused)
    return paper ? launch_tiles<TIER, true, true>(FD_TILE_ARGS)
                 : launch_tiles<TIER, true, false>(FD_TILE_ARGS);
  return paper ? launch_tiles<TIER, false, true>(FD_TILE_ARGS)
               : launch_tiles<TIER, false, false>(FD_TILE_ARGS);
}

// The int8 tier's per-frame maxima, on the stream ahead of the tiles.
int int8_prepass(const float* img, const void* m0, bool fused, uint32_t* amax_bits,
                 int32_t* nr_max, int N, int H, int W, int nseg, cudaStream_t stream) {
  if (!amax_bits || (!fused && !nr_max)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(amax_bits, 0, sizeof(uint32_t) * N, stream);
  if (e != cudaSuccess) return (int)e;
  const long long hw = (long long)H * W;
  const long long per_frame = (hw + PRE_THREADS - 1) / PRE_THREADS;
  const int bx = (int)(per_frame < 64 ? per_frame : 64);
  frame_amax_kernel<<<dim3(bx, N), PRE_THREADS, 0, stream>>>(img, amax_bits, hw);
  e = cudaGetLastError();
  if (e != cudaSuccess || fused) return (int)e;
  e = cudaMemsetAsync(nr_max, 0, sizeof(int32_t) * N, stream);
  if (e != cudaSuccess) return (int)e;
  gauss_qmax_kernel<<<dim3(nseg, (H + TILE - 1) / TILE, N), dim3(TILE, BLOCK_Y), 0, stream>>>(
      img, static_cast<const int32_t*>(m0), amax_bits, nr_max, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: f32 (N, H, W); tier: 0 f32, 1 the integer rewrite, 2 f16, 3 int8
// (Tier); m0/m1: the config's conv masks on the card in the tier's conv
// type (f32, int32, f16, int32), m1 NULL for the fused 7x7 set; cor: f32
// (n_cor, 4) rows [cos, sin, rho_lo, rho_hi] or NULL (n_cor 0);
// keep_bits/offsets: scratch of N * H * ceil(W / 32) words; amax_bits and
// nr_max: scratch of N words for the int8 tier (nr_max unused with the
// fused masks), NULL otherwise; state0/state1: two scratch planes of
// N * H * W bytes where the tile's window does not fit shared memory
// (fused_detect_smem_bytes above 232448, a long hysteresis), NULL
// otherwise; cxy (N, max_edges, 3), cw (N, max_edges), counts (N,) are
// written in full.
int fused_detect(const float* img, const void* m0, const void* m1, int tier, int fused,
                 int paper, const float* cor, int n_cor, uint32_t* keep_bits,
                 int32_t* offsets, uint32_t* amax_bits, int32_t* nr_max, uint8_t* state0,
                 uint8_t* state1, float* cxy, float* cw, int32_t* counts, int N, int H, int W,
                 int max_edges, float low, float high, float edge_thr, int border, int iters,
                 cudaStream_t stream) {
  if (iters < 0) iters = 0;
  const int nseg = (W + TILE - 1) / TILE;
  int rc;
  switch (tier) {
    case T_F32: rc = launch_tier<T_F32>(fused, paper, FD_TILE_ARGS); break;
    case T_INT: rc = launch_tier<T_INT>(fused, paper, FD_TILE_ARGS); break;
    case T_F16: rc = launch_tier<T_F16>(fused, paper, FD_TILE_ARGS); break;
    case T_I8:
      rc = int8_prepass(img, m0, fused, amax_bits, nr_max, N, H, W, nseg, stream);
      if (rc == 0) rc = launch_tier<T_I8>(fused, paper, FD_TILE_ARGS);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
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
