// Fused detection front end: Canny -> edge threshold -> rho-corridor filter
// -> raster-order compaction, in one C entry (a tile kernel and a
// compaction kernel, a pre-pass for the int8 gradient tier, and for a long
// hysteresis two more kernels, below).
//
// Replaces the TPU kernel repro/kernels/fused_detect.py::fused_detect (body
// _fused_kernel).  The TPU kernel holds one whole frame in VMEM and runs the
// staged jnp Canny on it, then a whole-frame prefix sum.  An SM has 228 KB of
// shared memory and a 720x1280 f32 frame is 3.7 MB, so here the frame is cut
// into TILE_W x TILE_H output tiles (128x32), each computed from a window
// with a halo:
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
// The two kernels (after the int8 tier's pre-pass):
//   1. canny_tile_kernel: one block per tile; writes one 32-bit keep word
//      per (row, 32-pixel segment), a warp ballot over a segment (or, for
//      a long hysteresis, each pixel's strong/weak state: below);
//   2. compact_kernel: a decoupled look-back over chunks of keep words in
//      raster order (row-major over (row, segment), since 2-D tiles are not
//      raster order), chunks handed out by an atomic ticket; each chunk
//      scatters its kept pixels as (x, y, 1) and weight 1 below max_edges
//      (later edges are dropped, as the reference drops them), a frame's
//      last chunk writes min(total, max_edges), and trailing blocks zero
//      the rows from each frame's count to max_edges.
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
// A long hysteresis.  The window's side is TILE + 2 (iters + 4), and past
// 41 passes (with either mask set) its planes no longer fit the
// 227 KB of shared memory a block may use (smem_bytes > MAX_SMEM).  Such a
// config, and only such a config, sends the hysteresis through two (N, H,
// W) planes of one byte a pixel that the caller allocates: the tile kernel
// runs at halo 0 (no in-tile passes) and writes each pixel's strong/weak
// bits; hysteresis_kernel then runs up to HYST_HALO Jacobi passes a launch,
// each HYST_TILE core read with a halo of HYST_HALO (zeros outside the
// frame, the reference's zero-shifted dilation), ping-ponging between the
// planes until every pass is done; keep_kernel applies the edge threshold
// and the corridors to the final plane and writes the same keep words, and
// the compaction follows.  Jacobi passes compose exactly, so the edges are
// those of the tile path and of the staged detector at any pass count.
// Every config that fits keeps the single tile kernel, the 8-pass default
// among them.
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
// What bounds it on this card.  The work is about 90 f32 operations of
// conv and magnitude a pixel against 4 bytes of image read, so the f32
// issue rate, not the memory, is the floor (about 13 us for 720x1280x8).
// The first design (32x32 tiles, 8 warps) was held far above it by the
// shared-memory pipe (every FMA loaded its mask tap and its pixel from
// shared memory, and the byte-per-pixel hysteresis loaded 9 bytes a pixel
// a pass: about 360k shared loads a block) and by latency (each thread's
// loads of the image window one after another, each waiting on memory).
// The redesign, in the steps it was measured in (PERF.md):
//   1. the masks go by value as a kernel parameter (each tap a uniform
//      operand of its FMA), and each thread computes an 8-row strip of one
//      column of a conv plane, sliding the input rows through registers
//      ((8 + K - 1) K loads for 8 outputs, not 8 K^2), over loops with no
//      division by a plane's side;
//   2. strong and weak are bit planes (a ballot a word), a hysteresis pass
//      S |= Wk & dilate3x3(S) on whole words, the paper's single dilation
//      one such pass;
//   3. wider tiles cut the halo's repeated work, and the magnitude and the
//      bit planes reuse the dead image and Gauss planes: 128x32 output
//      tiles of 16 warps, two blocks an SM, chosen by timing other shapes
//      (chip_smoke.py's tile probe; the Gauss plane 1.9x the tile, 2.6x at
//      32x32);
//   4. one look-back compaction launch replaces a scan with one block a
//      frame and a scatter;
//   5. every copy of the image window is in flight at once (cp.async,
//      zero-filled outside the frame), converted to the tier's type after;
//   6. the NMS runs in 8-row strips: a lane loads its column's magnitudes
//      and their neighbours at once and picks the pair across the edge by
//      selects, where each pixel waited on a direction load, then on two
//      loads at the offsets it gave.
// After them the tile is bound by instruction issue: the strips' FMAs
// and the magnitude's IEEE divide and square root, with a barrier between
// the phases.  The tensor cores do not fit: the f32 and f16 tiers must equal
// the staged path bit for bit (conv2d.cu's tap order, one rounding a tap,
// nr stored in the tier's type between the convs), and a tensor-core
// product sums in another order and width.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int SEG = 32;       // pixels a keep word; one warp ballots a segment
constexpr int TILE_W = 128;   // output tile width, a multiple of SEG
constexpr int TILE_H = 32;    // output tile height
constexpr int TILE_WARPS = 16;  // warps a tile block
constexpr int TILE_THREADS = 32 * TILE_WARPS;
constexpr int NWARPS = 8;     // warps a block of the other kernels
constexpr int NTHREADS = 32 * NWARPS;
constexpr int STRIP = 8;      // conv outputs a thread computes down one column
constexpr int COMPACT_THREADS = 256;  // a compaction block
constexpr int CHUNK_PER_THREAD = 4;   // keep words a compaction thread
constexpr int CHUNK_WORDS = COMPACT_THREADS * CHUNK_PER_THREAD;
constexpr int ZERO_ROWS = 2048;       // rows a clearing block zeroes
constexpr int PRE_TILE = 32;  // the int8 pre-pass's tile side
constexpr int PRE_THREADS = 256;
constexpr int GAUSS_NORM = 159;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on Hopper
constexpr int MAX_DEVICES = 16;      // cards whose raised smem limit is remembered
constexpr int HYST_TILE = 64;        // a hysteresis launch's core tile side
constexpr int HYST_HALO = 16;        // its halo: the most passes one launch runs
constexpr int HYST_SIDE = HYST_TILE + 2 * HYST_HALO;
constexpr int HYST_ROWS = 16;        // warps a hysteresis block
static_assert(TILE_W % SEG == 0, "a tile row is whole keep words");

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

// Shared memory of one block, each window TILE + 2 r on a side: plane A
// (the image), plane B (the Gauss output, or with the fused masks the
// magnitude), the direction bytes (full variant only).  The magnitude
// reuses A once the Gauss has read it, and the three bit planes (strong
// twice, weak; ceil(ws / 32) words a row) whichever of A and B does not
// hold the magnitude.  kernels/fused_detect.py::smem_bytes repeats this
// formula.
__host__ __device__ inline size_t smem_bytes(int iters, bool paper, bool fused) {
  const Radii r = radii(iters, paper);
  const size_t hi = TILE_H + 2 * r.i, wi = TILE_W + 2 * r.i;
  const size_t hn = TILE_H + 2 * r.n, wn = TILE_W + 2 * r.n;
  const size_t hm = TILE_H + 2 * r.m, wm = TILE_W + 2 * r.m;
  return align16(4 * hi * wi) + align16(4 * (fused ? hm * wm : hn * wn)) +
         (paper ? 0 : align16(hm * wm));
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

// The config's conv masks, passed by value as a kernel parameter, so that
// each FMA reads its tap from the constant bank: the Gauss (25 taps) and
// the Sobel pair (2 x 9), or the fused set's x and y masks (2 x 49).
template <typename Conv> struct Masks {
  Conv m[98];
};
constexpr int SOBEL_X = 25, SOBEL_Y = 34, FUSED_Y = 49;

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

// 4 bytes from global to shared memory without waiting (cp.async), or 4
// zero bytes where `in` is false (a source size of 0; `src` is then any
// valid address).  copy_async_wait waits for this thread's copies.
__device__ __forceinline__ void copy4_async(void* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row `row` of a bit plane (nw words) dilated by one pixel to each side, at
// word w: a bit is set where the pixel or a horizontal neighbour is, with
// zeros beyond the row.
__device__ __forceinline__ uint32_t dilate_row(const uint32_t* row, int w, int nw) {
  const uint32_t c = row[w];
  const uint32_t lo = w > 0 ? row[w - 1] : 0u;
  const uint32_t hi = w + 1 < nw ? row[w + 1] : 0u;
  return c | (c << 1) | (lo >> 31) | (c >> 1) | (hi << 31);
}

// Calls f(r0, c) for every strip of a plane of rows x cols items: a strip
// is STRIP rows of one column, from r0 down; the last strip of a column
// moves up to end at the plane's last row (rows >= STRIP), so it repeats a
// few items of the one above, with the same values.  The (strip, column)
// items are dealt in turn to the STEP workers of a block, worker `first`
// taking the first, consecutive workers consecutive columns; the walk
// adds and wraps, with no division.  for_strips deals them to threads.
template <int STEP, class F>
__device__ __forceinline__ void deal_strips(int rows, int cols, int first, F&& f) {
  const int nstrips = (rows + STRIP - 1) / STRIP;
  int s = 0, c = first;
  while (c >= cols) c -= cols, ++s;
  while (s < nstrips) {
    f(min(s * STRIP, rows - STRIP), c);
    c += STEP;
    while (c >= cols) c -= cols, ++s;
  }
}

template <class F>
__device__ __forceinline__ void for_strips(int rows, int cols, F&& f) {
  deal_strips<TILE_THREADS>(rows, cols, threadIdx.y * 32 + threadIdx.x, f);
}

// One strip of a K x K correlation chain for each of NM masks (taps from
// M.m[B0], M.m[B1]): out[q][j] is mask q at plane row r0 + j, its taps
// in conv2d.cu's order (dy-major, dx-minor, from 0) from the input rows
// r0 + j + dy, columns c + dx.  Each input row is read from shared memory
// once for the whole strip and every tap is a kernel-parameter operand.
template <int K, int NM, int B0, int B1, typename Conv>
__device__ __forceinline__ void conv_strip(const Conv* __restrict__ in, int pitch, int r0, int c,
                                           const Masks<Conv>& M, Conv (&out)[NM][STRIP]) {
#pragma unroll
  for (int q = 0; q < NM; ++q)
#pragma unroll
    for (int j = 0; j < STRIP; ++j) out[q][j] = zero<Conv>();
#pragma unroll
  for (int k = 0; k < STRIP + K - 1; ++k) {
    const Conv* row = in + (r0 + k) * pitch + c;
    Conv v[K];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) v[dx] = row[dx];
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      const int dy = k - j;
      if (dy >= 0 && dy < K) {
#pragma unroll
        for (int q = 0; q < NM; ++q)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            out[q][j] = mac(out[q][j], M.m[(q == 0 ? B0 : B1) + dy * K + dx], v[dx]);
      }
    }
  }
}

// Phase 1.  Strong and weak (full) or edge (paper) bit planes.  M: the
// Gauss and Sobel masks or the fused set, in the tier's conv type.
// amax_bits and nr_max: the int8 tier's per-frame maxima from the
// pre-pass.  STATE (the long-hysteresis path, launched at iters 0):
// write each pixel's bits to the (N, H, W) plane `state` in place of keep
// words.
template <int TIER, bool FUSED, bool PAPER, bool STATE>
__global__ void __launch_bounds__(TILE_THREADS, 2)
canny_tile_kernel(const float* __restrict__ img,
                  const __grid_constant__ Masks<typename TierTypes<TIER>::Conv> M,
                  const float* __restrict__ cor, int n_cor,
                  const uint32_t* __restrict__ amax_bits, const int32_t* __restrict__ nr_max,
                  uint32_t* __restrict__ keep_bits, uint8_t* __restrict__ state, int H, int W,
                  int nseg, float low, float high, float edge_thr, int border, int iters) {
  using Conv = typename TierTypes<TIER>::Conv;
  using Mag = typename TierTypes<TIER>::Mag;
  extern __shared__ __align__(16) unsigned char smem[];
  const Radii R = radii(iters, PAPER);
  const int hi = TILE_H + 2 * R.i, wi = TILE_W + 2 * R.i;
  const int hn = TILE_H + 2 * R.n, wn = TILE_W + 2 * R.n;
  const int hm = TILE_H + 2 * R.m, wm = TILE_W + 2 * R.m;
  const int hs = TILE_H + 2 * R.s, ws = TILE_W + 2 * R.s;

  // Planes A and B (smem_bytes), each sized for 4-byte values (f16 uses
  // half of its slot).  The frame's f32 pixels land in A; the image in
  // the tier's type stays there (f32; int32, converted in place) or, for
  // f16, goes to B, and the other plane takes the Gauss output.  The
  // magnitude then reuses the image's plane once the Gauss has read it
  // (the other plane with the fused masks, which read the image for both
  // gradients), and the bit planes whichever plane the magnitude is not
  // in, once it has been computed.
  unsigned char* plane_a = smem;
  unsigned char* plane_b = smem + align16(4 * (size_t)hi * wi);
  uint8_t* s_dir = plane_b + align16(4 * (size_t)(FUSED ? hm * wm : hn * wn));
  unsigned char* p_img = TIER == T_F16 ? plane_b : plane_a;
  unsigned char* p_other = TIER == T_F16 ? plane_a : plane_b;
  float* s_raw = reinterpret_cast<float*>(plane_a);
  Conv* s_img = reinterpret_cast<Conv*>(p_img);
  Conv* s_nr = reinterpret_cast<Conv*>(p_other);
  Mag* s_mag = reinterpret_cast<Mag*>(FUSED ? p_other : p_img);
  const int nw = (ws + 31) >> 5;  // bit words a window row
  uint32_t* s_s0 = reinterpret_cast<uint32_t*>(FUSED ? p_img : p_other);
  uint32_t* s_s1 = s_s0 + hs * nw;
  uint32_t* s_wk = s_s1 + hs * nw;

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int lane = threadIdx.x, wy = threadIdx.y;
  Scales sc{0.0f, 0.0f, 0.0f};
  if constexpr (TIER == T_I8) sc = frame_scales(amax_bits, FUSED ? nullptr : nr_max, n);

  // The image window: every pixel's copy in flight at once (cp.async, the
  // zeros of the Gauss's padding outside the frame), then each thread
  // converts the pixels it copied to the tier's conv type.
  const float* src = img + (size_t)n * H * W;
  for (int r = wy; r < hi; r += TILE_WARPS) {
    const int y = y0 - R.i + r;
    const bool row_in = y >= 0 && y < H;
    for (int c = lane; c < wi; c += 32) {
      const int x = x0 - R.i + c;
      const bool in = row_in && x >= 0 && x < W;
      copy4_async(s_raw + r * wi + c, in ? src + (size_t)y * W + x : src, in);
    }
  }
  copy_async_wait();
  if constexpr (TIER != T_F32) {
    for (int r = wy; r < hi; r += TILE_WARPS)
      for (int c = lane; c < wi; c += 32)
        s_img[r * wi + c] = from_image<TIER>(s_raw[r * wi + c], sc);
  }
  __syncthreads();

  if (!FUSED) {  // Gauss; nr outside the frame is the Sobel's zero padding
    for_strips(hn, wn, [&](int r0, int c) {
      Conv acc[1][STRIP];
      conv_strip<5, 1, 0, 0>(s_img, wi, r0, c, M, acc);
      const int x = x0 - R.n + c;
      const bool col_in = x >= 0 && x < W;
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        const int y = y0 - R.n + r0 + j;
        s_nr[(r0 + j) * wn + c] =
            col_in && y >= 0 && y < H ? gauss_out<TIER>(acc[0][j], sc) : zero<Conv>();
      }
    });
    __syncthreads();
  }

  // gradients -> magnitude (zero outside the frame and in the border) and
  // direction
  for_strips(hm, wm, [&](int r0, int c) {
    Conv g[2][STRIP];
    if constexpr (FUSED) conv_strip<7, 2, 0, FUSED_Y>(s_img, wi, r0, c, M, g);
    else conv_strip<3, 2, SOBEL_X, SOBEL_Y>(s_nr, wn, r0, c, M, g);
    const int x = x0 - R.m + c;
    const bool col_in = x >= 0 && x < W, col_inner = x >= border && x < W - border;
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      const int y = y0 - R.m + r0 + j;
      Mag mag = Mag(0);
      int dir = 0;
      if (col_in && y >= 0 && y < H) {
        mag = magnitude(grad_out<TIER, FUSED>(g[0][j], sc), grad_out<TIER, FUSED>(g[1][j], sc),
                        &dir);
        if (!(col_inner && y >= border && y < H - border)) mag = Mag(0);
      }
      s_mag[(r0 + j) * wm + c] = mag;
      if (!PAPER) s_dir[(r0 + j) * wm + c] = (uint8_t)dir;
    }
  });
  __syncthreads();

  // Strong and weak (or strong and edge) bits, one 32-bit word per 32
  // window pixels of a row (a warp ballot), false outside the frame; bit b
  // of word w of row r is the window pixel (r, 32 w + b).  A warp takes a
  // (strip of STRIP rows, word) item, lane b the column 32 w + b: its
  // magnitudes and their 3x3 neighbours are loaded at once (3 (STRIP + 2)
  // loads), the pair across the edge picked by selects.
  const int off = R.m - R.s;
  deal_strips<TILE_WARPS>(hs, nw, wy, [&](int r0, int w) {
    const int c = w * 32 + lane;
    const int cc = min(c, ws - 1) + off;  // in the window: loads stay in bounds
    const int x = x0 - R.s + c;
    const bool col_in = c < ws && x >= 0 && x < W;
    Mag m[STRIP + 2][3];
    if constexpr (!PAPER) {
#pragma unroll
      for (int k = 0; k < STRIP + 2; ++k)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m[k][dx] = s_mag[(r0 + off - 1 + k) * wm + cc - 1 + dx];
    }
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      const int y = y0 - R.s + r0 + j;
      bool strong = false, weak = false;
      if (col_in && y >= 0 && y < H) {
        if constexpr (PAPER) {
          const Mag v = s_mag[(r0 + j) * wm + cc];
          weak = at_least(v, low);  // the paper's edge bit
          strong = weak && at_least(v, high);
        } else {
          // the pair across the edge: E-W, NE-SW, N-S or NW-SE
          const Mag v = m[j + 1][1];
          const int d = s_dir[(r0 + off + j) * wm + cc];
          const Mag p1 = d == 0 ? m[j + 1][2]
                         : d == 1 ? m[j][2]
                         : d == 2 ? m[j + 2][1]
                                  : m[j + 2][2];
          const Mag p2 = d == 0 ? m[j + 1][0]
                         : d == 1 ? m[j + 2][0]
                         : d == 2 ? m[j][1]
                                  : m[j][0];
          const bool keep = v >= p1 && v >= p2;
          const Mag sup = keep ? v : Mag(0);
          strong = at_least(sup, high);
          weak = at_least(sup, low) && !strong;
        }
      }
      const uint32_t sbits = __ballot_sync(0xffffffffu, strong);
      const uint32_t wbits = __ballot_sync(0xffffffffu, weak);
      if (lane == 0) {
        s_s0[(r0 + j) * nw + w] = sbits;
        s_wk[(r0 + j) * nw + w] = wbits;
      }
    }
  });
  __syncthreads();

  // Hysteresis, one synchronous (Jacobi) pass at a time over the whole
  // window: S |= Wk & dilate3x3(S), word by word, with zeros beyond the
  // window.  A pixel's error from those zeros moves in one pixel a pass,
  // so the tile (R.s = passes from the window's edge) is exact after the
  // last pass.  The paper variant's single dilation is one such pass.  A
  // warp updates 32 / nw rows at once, lane (lr, lw) the word lw of row lr.
  uint32_t* cur = s_s0;
  uint32_t* nxt = s_s1;
  const int passes = PAPER ? 1 : iters;
  if (passes > 0) {
    const int rpw = 32 / nw;
    const int lr = lane / nw, lw = lane - lr * nw;
    for (int k = 0; k < passes; ++k) {
      if (lr < rpw) {
        for (int r = wy * rpw + lr; r < hs; r += TILE_WARPS * rpw) {
          uint32_t dil = dilate_row(cur + r * nw, lw, nw);
          if (r > 0) dil |= dilate_row(cur + (r - 1) * nw, lw, nw);
          if (r + 1 < hs) dil |= dilate_row(cur + (r + 1) * nw, lw, nw);
          nxt[r * nw + lw] = cur[r * nw + lw] | (s_wk[r * nw + lw] & dil);
        }
      }
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  if constexpr (STATE) {  // 1 strong, 2 weak: the hysteresis planes' bytes
    for (int ry = wy; ry < TILE_H; ry += TILE_WARPS) {
      const int y = y0 + ry;
      for (int cx = lane; cx < TILE_W; cx += 32) {
        const int x = x0 + cx, c = cx + R.s, i = (ry + R.s) * nw + (c >> 5);
        const uint32_t s = (cur[i] >> (c & 31)) & 1u, wk = (s_wk[i] >> (c & 31)) & 1u;
        if (y < H && x < W) state[((size_t)n * H + y) * W + x] = (uint8_t)(s | (wk << 1));
      }
    }
    return;
  }

  // edge weight -> corridor -> one keep word per tile row segment
  for (int ry = wy; ry < TILE_H; ry += TILE_WARPS) {
    const int y = y0 + ry;
    for (int sg = 0; sg < TILE_W / SEG; ++sg) {
      const int x = x0 + sg * SEG + lane;
      bool keep = false;
      if (y < H && x < W) {
        const int c = sg * SEG + lane + R.s;
        const bool edge = (cur[(ry + R.s) * nw + (c >> 5)] >> (c & 31)) & 1u;
        keep = (edge ? 255.0f : 0.0f) >= edge_thr;
        if (keep && n_cor > 0) keep = in_corridor(cor, n_cor, (float)x, (float)y);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, keep);
      const int seg = blockIdx.x * (TILE_W / SEG) + sg;
      if (lane == 0 && y < H && seg < nseg) keep_bits[((size_t)n * H + y) * nseg + seg] = word;
    }
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
  const int n = blockIdx.z, x = blockIdx.x * SEG + threadIdx.x;
  const int y = blockIdx.y * NWARPS + threadIdx.y;
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

// Phase 2, the compaction: one launch, a block a ticket.  Tickets come from
// an atomic counter in the order blocks start, so a block only ever waits
// on blocks that started before it, which makes progress whatever order
// the card schedules them in.  Tickets [0, n_chunks) are chunks of
// CHUNK_WORDS keep words of one frame in raster order (cpf a frame, frame
// by frame); the rest clear rows past each frame's count.
//
// A chunk block sums its words' popcounts, publishes the sum (ST_AGG),
// then looks back over the frame's earlier chunks, one warp reading 32 of
// them a step, adding their sums until the nearest that has published its
// inclusive prefix (ST_PREFIX; a frame's first chunk publishes its prefix
// at once), publishes its own prefix, and
// writes (x, y, 1) and weight 1 for each kept pixel at its raster rank
// below max_edges (later edges are dropped, as the reference drops them).
// A frame's last chunk writes counts[n] = min(total, max_edges).  A
// clearing block waits for its frame's last prefix and zeroes its share
// of the rows from the count to max_edges.  A flag word is value << 2 |
// status; the caller clears the flags and the ticket before the launch.
constexpr unsigned long long ST_AGG = 1, ST_PREFIX = 2;

__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long status,
                                        int value) {
  atomicExch(flag, ((unsigned long long)(unsigned)value << 2) | status);
}

// A flag once it is published.  Every flag waited on belongs to a block
// with a lower ticket, which has started and will publish; a flag that
// stays unpublished for ~2^24 reads means that the protocol broke, and the
// kernel traps (a launch failure) rather than hang the card.
__device__ __forceinline__ unsigned long long poll(const unsigned long long* flag) {
  unsigned long long f;
  for (int spins = 0;; ++spins) {
    f = *reinterpret_cast<const volatile unsigned long long*>(flag);
    if ((f & 3) != 0) return f;
    if (spins == (1 << 24)) __trap();
  }
}

__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const uint32_t* __restrict__ keep_bits, unsigned long long* flags,
               unsigned int* ticket, float* __restrict__ cxy, float* __restrict__ cw,
               int32_t* __restrict__ counts, int H, int nseg, int max_edges, int cpf,
               int n_chunks, int zpf) {
  constexpr int NW = COMPACT_THREADS / 32;
  __shared__ int s_ticket, s_base, s_total;
  __shared__ int s_warp[NW];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) s_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int t = s_ticket;

  if (t >= n_chunks) {  // clear rows [count, max_edges) of one frame's share
    const int z = t - n_chunks, n = z / zpf, part = z - n * zpf;
    if (tid == 0) {
      const unsigned long long* last = flags + (size_t)n * cpf + cpf - 1;
      unsigned long long f;
      do {
        f = poll(last);
      } while ((f & 3) != ST_PREFIX);
      s_base = min((int)(f >> 2), max_edges);
    }
    __syncthreads();
    const int lo = max(part * ZERO_ROWS, s_base), hi = min((part + 1) * ZERO_ROWS, max_edges);
    for (int r = lo + tid; r < hi; r += COMPACT_THREADS) {
      const size_t row = (size_t)n * max_edges + r;
      cw[row] = 0.0f;
      cxy[row * 3 + 0] = 0.0f;
      cxy[row * 3 + 1] = 0.0f;
      cxy[row * 3 + 2] = 0.0f;
    }
    return;
  }

  const int n = t / cpf, j = t - n * cpf;
  const int S = H * nseg;
  const uint32_t* kb = keep_bits + (size_t)n * S;
  const int g0 = j * CHUNK_WORDS + tid * CHUNK_PER_THREAD;
  uint32_t w[CHUNK_PER_THREAD];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < CHUNK_PER_THREAD; ++k) {
    w[k] = g0 + k < S ? kb[g0 + k] : 0u;
    sum += __popc(w[k]);
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int v = lane < NW ? s_warp[lane] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += u;
    }
    if (lane < NW) s_warp[lane] = x - v;
    if (lane == NW - 1) s_total = x;
  }
  __syncthreads();
  if (wid == 0) {  // the look-back, 32 earlier chunks a step, lane i at t - 1 - i
    const int agg = s_total;
    int excl = 0;
    if (j == 0) {
      if (lane == 0) publish(flags + t, ST_PREFIX, agg);
    } else {
      if (lane == 0) publish(flags + t, ST_AGG, agg);
      const int first = t - j;  // the frame's first chunk: a prefix from the start
      for (int top = t - 1;; top -= 32) {
        const int k = top - lane;
        unsigned long long f = k >= first ? poll(flags + k) : ST_PREFIX;
        const unsigned pre = __ballot_sync(0xffffffffu, (f & 3) == ST_PREFIX);
        const int stop = pre ? __ffs(pre) - 1 : 31;  // the nearest prefix
        int v = lane <= stop ? (int)(f >> 2) : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        excl += v;
        if (pre) break;
      }
      if (lane == 0) publish(flags + t, ST_PREFIX, excl + agg);
    }
    if (lane == 0) {
      if (j == cpf - 1) counts[n] = min(excl + agg, max_edges);
      s_base = excl;
    }
  }
  __syncthreads();

  int slot = s_base + s_warp[wid] + incl - sum;  // the rank of this thread's first kept pixel
  if (slot >= max_edges || sum == 0) return;
  int y = g0 / nseg, s = g0 - y * nseg;
#pragma unroll
  for (int k = 0; k < CHUNK_PER_THREAD; ++k) {
    uint32_t word = w[k];
    while (word && slot < max_edges) {
      const int b = __ffs(word) - 1;
      word &= word - 1;
      const size_t row = (size_t)n * max_edges + slot++;
      cxy[row * 3 + 0] = (float)(s * SEG + b);
      cxy[row * 3 + 1] = (float)y;
      cxy[row * 3 + 2] = 1.0f;
      cw[row] = 1.0f;
    }
    if (++s == nseg) s = 0, ++y;
  }
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
gauss_qmax_kernel(const float* __restrict__ img, const __grid_constant__ Masks<int32_t> M,
                  const uint32_t* __restrict__ amax_bits, int32_t* __restrict__ nr_max,
                  int H, int W) {
  constexpr int S = PRE_TILE + 4;
  __shared__ int32_t s_img[S * S];
  __shared__ int32_t s_max[NWARPS];
  const int n = blockIdx.z, x0 = blockIdx.x * PRE_TILE, y0 = blockIdx.y * PRE_TILE;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const float s1 = scale8(__uint_as_float(amax_bits[n]));
  const float* src = img + (size_t)n * H * W;
  for (int i = tid; i < S * S; i += NTHREADS) {
    const int r = i / S, c = i - r * S;
    const int y = y0 - 2 + r, x = x0 - 2 + c;
    s_img[i] = (y >= 0 && y < H && x >= 0 && x < W) ? quantize8(src[(size_t)y * W + x], s1) : 0;
  }
  __syncthreads();
  int32_t m = 0;
  const int x = x0 + threadIdx.x;
  for (int ry = threadIdx.y; ry < PRE_TILE; ry += NWARPS) {
    if (y0 + ry >= H || x >= W) break;
    int32_t acc = 0;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) acc += M.m[dy * 5 + dx] * s_img[(ry + dy) * S + threadIdx.x + dx];
    m = max(m, abs(acc));
  }
  for (int d = 16; d; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (threadIdx.x == 0) s_max[threadIdx.y] = m;
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < NWARPS; ++k) m = max(m, s_max[k]);
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

// The kernel parameter of a config's masks, from the host arrays m0 (the
// Gauss (1,5,5) or the fused set (3,7,7), whose first mask, the padded
// Gauss, the tile does not use) and m1 (the Sobel pair (2,3,3)).
template <typename Conv>
Masks<Conv> host_masks(const void* m0, const void* m1, bool fused) {
  Masks<Conv> M;
  memset(&M, 0, sizeof(M));
  const Conv* a = static_cast<const Conv*>(m0);
  if (fused) {
    memcpy(M.m, a + 49, 2 * 49 * sizeof(Conv));
  } else {
    memcpy(M.m, a, 25 * sizeof(Conv));
    memcpy(M.m + SOBEL_X, m1, 18 * sizeof(Conv));
  }
  return M;
}

// One launch of canny_tile_kernel at `iters` in-tile passes.
template <int TIER, bool FUSED, bool PAPER, bool STATE>
int launch_tile_kernel(FD_TILE_PARAMS) {
  using Conv = typename TierTypes<TIER>::Conv;
  const size_t smem = smem_bytes(iters, PAPER, FUSED);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = canny_tile_kernel<TIER, FUSED, PAPER, STATE>;
  if (smem > 48 * 1024) {
    // Each instance's limit is raised once a device to the largest size
    // asked so far, so that a warm call only launches.
    static std::atomic<int> raised[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || raised[dev].load(std::memory_order_relaxed) < (int)smem) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) raised[dev].store((int)smem, std::memory_order_relaxed);
    }
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, N);
  kernel<<<grid, dim3(32, TILE_WARPS), smem, stream>>>(
      img, host_masks<Conv>(m0, m1, FUSED), cor, n_cor, amax_bits, nr_max, keep_bits, state0, H,
      W, nseg, low, high, edge_thr, border, iters);
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
  keep_kernel<<<dim3(nseg, (H + NWARPS - 1) / NWARPS, N), dim3(32, NWARPS), 0, stream>>>(
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

// The compaction launch of a call: chunks a frame, chunks, clearing blocks
// a frame, blocks, and flag words (a flag a chunk, then the ticket).
struct Compaction {
  int cpf, chunks, zpf, blocks, flag_words;
};

inline Compaction compaction(int N, int H, int W, int max_edges) {
  Compaction c;
  const int S = H * ((W + SEG - 1) / SEG);
  c.cpf = (S + CHUNK_WORDS - 1) / CHUNK_WORDS;
  c.chunks = N * c.cpf;
  c.zpf = (max_edges + ZERO_ROWS - 1) / ZERO_ROWS;
  c.blocks = c.chunks + N * c.zpf;
  c.flag_words = c.chunks + 1;
  return c;
}

// The int8 tier's per-frame maxima, on the stream ahead of the tiles.
int int8_prepass(const float* img, const void* m0, const void* m1, bool fused,
                 uint32_t* amax_bits, int32_t* nr_max, int N, int H, int W,
                 cudaStream_t stream) {
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
  const dim3 grid((W + PRE_TILE - 1) / PRE_TILE, (H + PRE_TILE - 1) / PRE_TILE, N);
  gauss_qmax_kernel<<<grid, dim3(32, NWARPS), 0, stream>>>(
      img, host_masks<int32_t>(m0, m1, false), amax_bits, nr_max, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: f32 (N, H, W); tier: 0 f32, 1 the integer rewrite, 2 f16, 3 int8
// (Tier); m0/m1: the config's conv masks in host memory, in the tier's
// conv type (f32, int32, f16, int32), m1 NULL for the fused 7x7 set; each
// launch takes them by value; cor: f32
// (n_cor, 4) rows [cos, sin, rho_lo, rho_hi] or NULL (n_cor 0);
// keep_bits: scratch of N * H * ceil(W / 32) words; flags: scratch of
// N * ceil(H * ceil(W / 32) / 1024) + 1 64-bit words (fused_detect_plan),
// cleared here on the stream; amax_bits and
// nr_max: scratch of N words for the int8 tier (nr_max unused with the
// fused masks), NULL otherwise; state0/state1: two scratch planes of
// N * H * W bytes where the tile's window does not fit shared memory
// (fused_detect_smem_bytes above 232448, a long hysteresis), NULL
// otherwise; cxy (N, max_edges, 3), cw (N, max_edges), counts (N,) are
// written in full.
int fused_detect(const float* img, const void* m0, const void* m1, int tier, int fused,
                 int paper, const float* cor, int n_cor, uint32_t* keep_bits,
                 unsigned long long* flags, uint32_t* amax_bits, int32_t* nr_max, uint8_t* state0,
                 uint8_t* state1, float* cxy, float* cw, int32_t* counts, int N, int H, int W,
                 int max_edges, float low, float high, float edge_thr, int border, int iters,
                 cudaStream_t stream) {
  if (iters < 0) iters = 0;
  const int nseg = (W + SEG - 1) / SEG;
  int rc;
  switch (tier) {
    case T_F32: rc = launch_tier<T_F32>(fused, paper, FD_TILE_ARGS); break;
    case T_INT: rc = launch_tier<T_INT>(fused, paper, FD_TILE_ARGS); break;
    case T_F16: rc = launch_tier<T_F16>(fused, paper, FD_TILE_ARGS); break;
    case T_I8:
      rc = int8_prepass(img, m0, m1, fused, amax_bits, nr_max, N, H, W, stream);
      if (rc == 0) rc = launch_tier<T_I8>(fused, paper, FD_TILE_ARGS);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const Compaction c = compaction(N, H, W, max_edges);
  rc = (int)cudaMemsetAsync(flags, 0, sizeof(unsigned long long) * c.flag_words, stream);
  if (rc != 0) return rc;
  compact_kernel<<<c.blocks, COMPACT_THREADS, 0, stream>>>(
      keep_bits, flags, reinterpret_cast<unsigned int*>(flags + c.chunks), cxy, cw, counts, H,
      nseg, max_edges, c.cpf, c.chunks, c.zpf);
  return (int)cudaGetLastError();
}

size_t fused_detect_smem_bytes(int iters, int paper, int fused) {
  return smem_bytes(iters < 0 ? 0 : iters, paper != 0, fused != 0);
}

// The launch plan of a call, as kernels/fused_detect.py::launch_plan gives
// it, into out[0..8]: the tile's height and width, the tile launch's
// shared memory, its blocks a frame, the hysteresis launches, the fewest
// passes that go through device memory (-1: never, the paper variant),
// the compaction's chunks a frame, its blocks, and the flag words.
void fused_detect_plan(int iters, int paper, int fused, int N, int H, int W, int max_edges,
                       long long* out) {
  if (iters < 0) iters = 0;
  const bool planes = smem_bytes(iters, paper != 0, fused != 0) > MAX_SMEM;
  int first = -1;
  for (int i = 0; !paper && first < 0; ++i)
    if (smem_bytes(i, false, fused != 0) > MAX_SMEM) first = i;
  const Compaction c = compaction(N, H, W, max_edges);
  out[0] = TILE_H;
  out[1] = TILE_W;
  out[2] = (long long)smem_bytes(planes ? 0 : iters, paper != 0, fused != 0);
  out[3] = (long long)((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
  out[4] = planes ? (iters + HYST_HALO - 1) / HYST_HALO : 0;
  out[5] = first;
  out[6] = c.cpf;
  out[7] = c.blocks;
  out[8] = c.flag_words;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
