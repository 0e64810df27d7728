// Mamba-2 SSD chunked scan in three passes over the chunks: y and the final
// state out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  The TPU walks the chunks in order on one core and carries
// the (N, P) state in VMEM scratch.  Here the sequential axis is split so
// that every chunk of every head is its own block.  For a chunk of Q steps
// (Q = min(chunk, L)), with ldec = dt * A (<= 0) and xdt = x * dt as the
// reference's wrapper forms them (here inside the kernels, as a chunk is
// loaded: ldec with the same one rounding, dt folded into the other
// operand of each product):
//
//   cum   = inclusive cumsum of ldec over the chunk
//   S_c   = (B o exp(cum_last - cum))^T . xdt                   (N x P)
//   h_c   = exp(cum_last[c-1]) h_{c-1} + S_{c-1},  h_0 = 0        (carry)
//   y     = ((C B^T) o tril(exp(cum_i - cum_j))) . xdt
//           + (C o exp(cum)) . h_c                               (Q x P)
//
// Three kernels, all issued by ssd_scan_f32 on the caller's stream, each
// launch checked:
//   (a) ssd_scan_chunk_kernel: one block per (batch, head, chunk) writes the
//       chunk's cum (scratch, read again by (b) and (c), so every pass uses
//       the same values) and S_c (scratch); one block per (batch, group,
//       chunk) writes C B^T (its tiles on and below the diagonal, scratch).
//       B and C belong to the group, so C B^T is computed once per group and
//       chunk, not once per head, and the output pass applies each head's
//       decay mask to it.  Blocks in the same launch, rather than one block
//       walking all heads of a group, so that (c) keeps one head a block:
//       that is what fills the card at batch 1.
//   (b) ssd_scan_carry_kernel: one thread per (batch, head, n, p) walks the
//       chunks in order, the reference's recursion in the reference's
//       order, overwriting S_c with the state h_c that enters chunk c; it
//       writes the final state.
//   (c) ssd_scan_output_kernel: one block per (batch, head, chunk, 32 rows)
//       forms (C B^T) o decay o dt and C o exp(cum) in shared memory and
//       writes y, both products, once.
// The ragged tail of the last chunk, and the rows and columns that pad the
// chunk to 32 rows, N to 16 and P to 64 in shared memory, are identity
// steps (zero x, dt, B and C) or zero columns: they add nothing.
//
// What bounds it on this card: at the serving shapes (H = 64 heads, P = N =
// 64, Q = 128, one group, batch 1) the products are ~1.6 GFLOP at L = 999
// against ~35 MB read and written once, so the arithmetic, not the memory,
// bounds it.  The old design ran one block per (batch, head), 64 blocks for
// 132 SMs, on the f32 FMA pipe, with C B^T recomputed per head.  Here (c)
// has 256 blocks a full chunk (192 at the shortest prefill), and every
// product runs on the tensor cores as 3xTF32 mma.sync m16n8k8 with f32
// accumulators: each f32 operand split as hi = cvt.rna.tf32(a), lo =
// cvt.rna.tf32(a - hi), and lo.hi' + hi.lo' + hi.hi' summed, ~2^-21 of
// |a||b| a product where one TF32 product errs by up to 2^-10.  Tiles
// arrive by cp.async, every load of a block in flight at once; the masks,
// expf and the decays stay in f32 outside the products.  Each mask entry is
// expf of the difference cum_i - cum_j (or cum_last - cum_j), never a
// product of two exponentials, which could overflow over a long chunk.
// What is left: a block's phases (load, mask, products) do not overlap,
// and (c)'s 80 KB of shared memory allow 8 warps an SM; wgmma, TMA and a
// producer warp are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;         // passes (a) and (c): 4 warps
constexpr int CARRY_THREADS = 256;   // pass (b)
constexpr int RB = 32;               // rows of a chunk a block of (c) takes

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Sizes every pass shares: the chunk padded to RB rows, N to 16 and P to
// 64 (whole column groups: a warp's tiles need no guard).
struct Shape {
  int Bt, L, H, G, N, P, Q, QP, NP, PP, nc;
  __host__ __device__ Shape(int Bt_, int L_, int H_, int G_, int N_, int P_,
                            int Q_)
      : Bt(Bt_), L(L_), H(H_), G(G_), N(N_), P(P_), Q(Q_),
        QP(round_up(Q_, RB)), NP(round_up(N_, 16)), PP(round_up(P_, 64)),
        nc((L_ + Q_ - 1) / Q_) {}
  // Shared memory in floats.  Leading dimensions: 8 mod 16 for an array
  // read along its rows by lane t and across them by lane g (B^T and the
  // right-hand operands), 4 mod 8 for one read the other way: both put the
  // 32 lanes of a fragment load on 32 banks.
  __host__ __device__ int chunk_floats() const {
    const int state = QP * (NP + 8) + QP * (PP + 8) + 3 * QP;
    const int cb = 2 * QP * (NP + 4);
    return state > cb ? state : cb;
  }
  __host__ __device__ int output_floats() const {
    return RB * (QP + 4) + RB * (NP + 4) + QP * (PP + 8) + NP * (PP + 8) +
           2 * QP;
  }
  __host__ __device__ long long chunk_blocks() const {
    return (long long)Bt * (G + H) * nc;
  }
  __host__ __device__ long long carry_blocks() const {
    return ((long long)Bt * H * N * P + CARRY_THREADS - 1) / CARRY_THREADS;
  }
  __host__ __device__ long long output_blocks() const {
    return (long long)Bt * H * nc * (QP / RB);
  }
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool real) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(real ? 16 : 0));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[r * ld + col] = src[r * stride + col] for r < rows, col < cols
// (float4 copies in flight until cp_wait_all); rows r >= rows_real and
// columns [cols, cols_pad) zero.
__device__ void load_rows(float* dst, int ld, const float* src, size_t stride,
                          int rows, int rows_real, int cols, int cols_pad) {
  const int v = cols / 4;
  for (int e = threadIdx.x; e < rows * v; e += blockDim.x) {
    const int r = e / v, q = e - r * v;
    const bool real = r < rows_real;
    cp16(dst + r * ld + 4 * q, real ? src + r * stride + 4 * q : src, real);
  }
  const int w = cols_pad - cols;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w;
    dst[r * ld + cols + (e - r * w)] = 0.0f;
  }
}

// dts[i] = dt[(b, t0 + i, h)] for the chunk's real steps, 0 past them.
__device__ __forceinline__ void load_dt(float* dts, const float* dt,
                                        size_t at, int H, int real, int QP) {
  for (int i = threadIdx.x; i < QP; i += blockDim.x)
    dts[i] = i < real ? dt[at + (size_t)i * H] : 0.0f;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as a 32-bit register with the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (a rest below 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)
// (the difference is exact in f32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores, m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (tile j: rows 0-15, columns 8j..8j+7) += A(r, k) B(k, c) summed
// over k < kend (a multiple of 8), as 3xTF32: each operand split into hi +
// lo, and the products lo.hi' + hi.lo' + hi.hi' accumulated in f32 (lo.lo'
// and the split's rest fall below 2^-21 of |a||b|, where one TF32 product
// errs by up to 2^-10).  A k-step splits all its fragments first, then
// issues each product across the NT tiles, so that no mma waits on the one
// before it.  Fragments of m16n8k8: lane (g, t) = (lane / 4, lane % 4)
// holds A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4) and B(t, g),
// B(t + 4, g) of each k-step and tile, and acc[j] = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
template <int NT, typename AF, typename BF>
__device__ __forceinline__ void warp_product(float acc[NT][4], int kend, AF A,
                                             BF B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kend; k += 8) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split(A(g, k + t), ah[0], al[0]);
    split(A(g + 8, k + t), ah[1], al[1]);
    split(A(g, k + t + 4), ah[2], al[2]);
    split(A(g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(B(k + t, 8 * j + g), bh[j][0], bl[j][0]);
      split(B(k + t + 4, 8 * j + g), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float acc[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
}

// Inclusive cumsum of a chunk's log-decay ldec_i = dt_i * A (the
// reference wrapper's product), by one warp: each lane sums a run of
// consecutive steps, then the lanes scan their totals.  Steps past `real`
// are zero.
__device__ void chunk_cumsum(float* cum, const float* dts, float A, int real,
                             int QP) {
  const int lane = threadIdx.x & 31;
  const int per = (QP + 31) / 32;
  const int lo = lane * per, hi = min(lo + per, QP);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run += i < real ? dts[i] * A : 0.0f;
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += before;
}

// (a) Blocks [0, Bt*G*nc): C B^T of (batch, group, chunk) into cb
// (Bt, G, nc, QP, QP), the tiles on and below the diagonal.  Blocks after:
// (batch, head, chunk): cum into cum_out (Bt, H, nc, QP) and S_c into
// hbuf (Bt, H, nc, N, P).
__global__ void __launch_bounds__(THREADS)
ssd_scan_chunk_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ Ap,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ cum_out,
                      float* __restrict__ hbuf, float* __restrict__ cb,
                      const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int n_cb = s.Bt * s.G * s.nc;
  int blk = blockIdx.x;

  if (blk < n_cb) {
    const int c = blk % s.nc, bg = blk / s.nc;
    const int b = bg / s.G, g = bg - b * s.G;
    const int t0 = c * s.Q, real = min(s.Q, s.L - t0);
    const int ld = s.NP + 4;
    float* Cs = smem;                 // QP x ld: C of the chunk
    float* Bs = smem + s.QP * ld;     // QP x ld: B of the chunk
    const size_t at = ((size_t)(b * s.L + t0) * s.G + g) * s.N;
    load_rows(Cs, ld, Cm + at, (size_t)s.G * s.N, s.QP, real, s.N, s.NP);
    load_rows(Bs, ld, Bm + at, (size_t)s.G * s.N, s.QP, real, s.N, s.NP);
    cp_wait_all();
    __syncthreads();
    float* out = cb + (size_t)bg * s.nc * s.QP * s.QP + (size_t)c * s.QP * s.QP;
    const int strips = s.QP / 16, kend = round_up(s.N, 8);
    // strip k has 2k + 2 tiles: pair the short strips with the long ones
    for (int k = warp; k < (strips + 1) / 2; k += THREADS / 32) {
      for (int half = 0; half < 2; ++half) {
        const int st = half ? strips - 1 - k : k;
        if (half && st == k) break;
        // the tiles up to the diagonal, in whole groups of 32 columns
        const int ncols = round_up(16 * st + 16, 32);
        for (int c0 = 0; c0 < ncols; c0 += 32) {
          float acc[4][4];
          zero<4>(acc);
          warp_product<4>(
              acc, kend,
              [&](int r, int kk) { return Cs[(16 * st + r) * ld + kk]; },
              [&](int kk, int col) { return Bs[(c0 + col) * ld + kk]; });
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c0 + 8 * j + 2 * t4;
            const int r0 = 16 * st + g4;
            *reinterpret_cast<float2*>(out + r0 * s.QP + col) =
                make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(out + (r0 + 8) * s.QP + col) =
                make_float2(acc[j][2], acc[j][3]);
          }
        }
      }
    }
    return;
  }

  blk -= n_cb;
  const int c = blk % s.nc, bh = blk / s.nc;
  const int b = bh / s.H, h = bh - b * s.H, g = h / (s.H / s.G);
  const int t0 = c * s.Q, real = min(s.Q, s.L - t0);
  const int ldb = s.NP + 8, ldx = s.PP + 8;
  float* Bs = smem;                   // QP x ldb: B of the chunk
  float* Xs = Bs + s.QP * ldb;        // QP x ldx: x of the chunk
  float* cum = Xs + s.QP * ldx;       // QP
  float* dts = cum + s.QP;            // QP: dt
  float* w = dts + s.QP;              // QP: exp(cum_last - cum_j) dt_j
  load_rows(Bs, ldb, Bm + ((size_t)(b * s.L + t0) * s.G + g) * s.N,
            (size_t)s.G * s.N, s.QP, real, s.N, s.NP);
  load_rows(Xs, ldx, x + ((size_t)(b * s.L + t0) * s.H + h) * s.P,
            (size_t)s.H * s.P, s.QP, real, s.P, s.PP);
  load_dt(dts, dt, (size_t)(b * s.L + t0) * s.H + h, s.H, real, s.QP);
  __syncthreads();
  if (warp == 0) chunk_cumsum(cum, dts, Ap[h], real, s.QP);
  cp_wait_all();
  __syncthreads();
  const float last = cum[s.QP - 1];
  float* co = cum_out + (size_t)blk * s.QP;
  for (int i = threadIdx.x; i < s.QP; i += THREADS) {
    w[i] = expf(last - cum[i]) * dts[i];
    co[i] = cum[i];
  }
  __syncthreads();

  // S_c = (B o w)^T . x: rows n (16 a strip), columns p, k over the real
  // steps
  float* so = hbuf + (size_t)blk * s.N * s.P;
  const int kend = round_up(real, 8);
  for (int st = warp; st < s.NP / 16; st += THREADS / 32) {
    for (int c0 = 0; c0 < s.PP; c0 += 64) {
      float acc[8][4];
      zero<8>(acc);
      warp_product<8>(
          acc, kend,
          [&](int r, int kk) { return Bs[kk * ldb + 16 * st + r] * w[kk]; },
          [&](int kk, int col) { return Xs[kk * ldx + c0 + col]; });
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + 8 * j + 2 * t4;
        if (col < s.P) {
          const int n0 = 16 * st + g4;
          if (n0 < s.N)
            *reinterpret_cast<float2*>(so + n0 * s.P + col) =
                make_float2(acc[j][0], acc[j][1]);
          if (n0 + 8 < s.N)
            *reinterpret_cast<float2*>(so + (n0 + 8) * s.P + col) =
                make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
  }
}

// (b) h_0 = 0, h_{c+1} = exp(cum_last[c]) h_c + S_c; hbuf[c] <- h_c; the
// final state out.
__global__ void __launch_bounds__(CARRY_THREADS)
ssd_scan_carry_kernel(const float* __restrict__ cum, float* __restrict__ hbuf,
                      float* __restrict__ state, const Shape s) {
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  const int np = s.N * s.P;
  if (e >= (long long)s.Bt * s.H * np) return;
  const int bh = (int)(e / np), at = (int)(e - (long long)bh * np);
  float* hp = hbuf + (size_t)bh * s.nc * np + at;
  const float* cl = cum + (size_t)bh * s.nc * s.QP + s.QP - 1;
  float hc = 0.0f;
  for (int c0 = 0; c0 < s.nc; c0 += 8) {
    float sv[8], dv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < s.nc) {
        sv[u] = hp[(size_t)(c0 + u) * np];
        dv[u] = cl[(size_t)(c0 + u) * s.QP];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < s.nc) {
        hp[(size_t)(c0 + u) * np] = hc;
        hc = expf(dv[u]) * hc + sv[u];
      }
    }
  }
  state[e] = hc;
}

// (c) One block per (batch, head, chunk, RB rows): y = ((C B^T) o
// tril(exp(cum_i - cum_j))) . xdt + (C o exp(cum)) . h_c.  Two warps a
// 16-row strip, each 32 columns of P at a time.
__global__ void __launch_bounds__(THREADS)
ssd_scan_output_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ Cm,
                       const float* __restrict__ cum_in,
                       const float* __restrict__ hbuf,
                       const float* __restrict__ cb, float* __restrict__ y,
                       const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int rbs = s.QP / RB;
  const int r = blockIdx.x % rbs, chunk = blockIdx.x / rbs;  // (b, h, c)
  const int c = chunk % s.nc, bh = chunk / s.nc;
  const int b = bh / s.H, h = bh - b * s.H, g = h / (s.H / s.G);
  const int t0 = c * s.Q, real = min(s.Q, s.L - t0), r0 = r * RB;
  if (r0 >= real) return;             // padding rows only: nothing to write
  const int kx = r0 + RB;             // the steps these rows read
  const int ldm = s.QP + 4, ldc = s.NP + 4, ldx = s.PP + 8;
  float* Ms = smem;                   // RB x ldm: (C B^T) o decay o dt_j
  float* Ce = Ms + RB * ldm;          // RB x ldc: C o exp(cum)
  float* Xs = Ce + RB * ldc;          // kx x ldx: x of the chunk
  float* Hs = Xs + s.QP * ldx;        // NP x ldx: the state entering c
  float* cum = Hs + s.NP * ldx;       // QP
  float* dts = cum + s.QP;            // QP: dt
  // every load in flight at once: C B^T and C raw, masked in place below
  load_rows(Ms, ldm,
            cb + ((size_t)(b * s.G + g) * s.nc + c) * s.QP * s.QP +
                (size_t)r0 * s.QP,
            s.QP, RB, RB, kx, kx);
  load_rows(Ce, ldc, Cm + ((size_t)(b * s.L + t0 + r0) * s.G + g) * s.N,
            (size_t)s.G * s.N, RB, min(RB, real - r0), s.N, s.NP);
  load_rows(Xs, ldx, x + ((size_t)(b * s.L + t0) * s.H + h) * s.P,
            (size_t)s.H * s.P, kx, real, s.P, s.PP);
  if (c > 0)
    load_rows(Hs, ldx, hbuf + (size_t)chunk * s.N * s.P, s.P, s.NP, s.N, s.P,
              s.PP);
  load_rows(cum, s.QP, cum_in + (size_t)chunk * s.QP, s.QP, 1, 1, s.QP, s.QP);
  load_dt(dts, dt, (size_t)(b * s.L + t0) * s.H + h, s.H, real, s.QP);
  cp_wait_all();
  __syncthreads();
  // rows RB apart by warp, columns by lane: no division
  for (int ii = warp; ii < RB; ii += THREADS / 32) {
    const int i = r0 + ii;
    const float ci = cum[i];
    for (int j = lane; j < kx; j += 32)
      Ms[ii * ldm + j] =
          i >= j ? Ms[ii * ldm + j] * expf(ci - cum[j]) * dts[j] : 0.0f;
    const float ei = expf(ci);
    for (int n = lane; n < s.N; n += 32) Ce[ii * ldc + n] *= ei;
  }
  __syncthreads();

  for (int task = warp; task < 2 * (s.PP / 32); task += THREADS / 32) {
    const int st = task & 1, c0 = 32 * (task >> 1);
    float acc[4][4];
    zero<4>(acc);
    warp_product<4>(
        acc, r0 + 16 * st + 16,
        [&](int rr, int kk) { return Ms[(16 * st + rr) * ldm + kk]; },
        [&](int kk, int col) { return Xs[kk * ldx + c0 + col]; });
    if (c > 0)
      warp_product<4>(
          acc, round_up(s.N, 8),
          [&](int rr, int kk) { return Ce[(16 * st + rr) * ldc + kk]; },
          [&](int kk, int col) { return Hs[kk * ldx + c0 + col]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 8 * j + 2 * t4;
      if (col >= s.P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + 16 * st + g4 + 8 * half;
        if (i < real)
          *reinterpret_cast<float2*>(
              y + ((size_t)(b * s.L + t0 + i) * s.H + h) * s.P + col) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// What a launch of (Bt, L, H, G, N, P, Q) takes: 0, 1 shared-memory bytes
// of passes (a), (c); 2, 3, 4 blocks of (a), (b), (c); 5, 6, 7 floats of
// the scratch arrays cum (Bt, H, nc, QP), hbuf (Bt, H, nc, N, P) and cb
// (Bt, G, nc, QP, QP).  -1 for another `what`.
long long ssd_scan_plan(int what, int Bt, int L, int H, int G, int N, int P,
                        int Q) {
  const Shape s(Bt, L, H, G, N, P, Q);
  switch (what) {
    case 0: return (long long)sizeof(float) * s.chunk_floats();
    case 1: return (long long)sizeof(float) * s.output_floats();
    case 2: return s.chunk_blocks();
    case 3: return s.carry_blocks();
    case 4: return s.output_blocks();
    case 5: return (long long)Bt * H * s.nc * s.QP;
    case 6: return (long long)Bt * H * s.nc * N * P;
    case 7: return (long long)Bt * G * s.nc * s.QP * s.QP;
    default: return -1;
  }
}

// xdt: (Bt, L, H, P) = x * dt; ldec: (Bt, L, H) = dt * A; Bm, Cm: (Bt, L,
// G, N); y: (Bt, L, H, P); state: (Bt, H, N, P); cum, hbuf, cb: scratch of
// ssd_scan_plan's sizes.  All f32, contiguous, 16-byte aligned; H % G == 0,
// N % 4 == 0, P % 4 == 0, 1 <= Q <= 128.  Returns the first launch error.
int ssd_scan_f32(const float* x, const float* dt, const float* A,
                 const float* Bm, const float* Cm, float* y, float* state,
                 float* cum,
                 float* hbuf, float* cb, int Bt, int L, int H, int G, int N,
                 int P, int Q, cudaStream_t stream) {
  if (Bt <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      P <= 0 || N % 4 != 0 || P % 4 != 0 || Q <= 0 || Q > 128)
    return (int)cudaErrorInvalidValue;
  const Shape s(Bt, L, H, G, N, P, Q);
  const int smem_a = (int)sizeof(float) * s.chunk_floats();
  const int smem_c = (int)sizeof(float) * s.output_floats();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_scan_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_chunk_kernel<<<(unsigned)s.chunk_blocks(), THREADS, smem_a,
                          stream>>>(x, dt, A, Bm, Cm, cum, hbuf, cb, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_carry_kernel<<<(unsigned)s.carry_blocks(), CARRY_THREADS, 0,
                          stream>>>(cum, hbuf, state, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_output_kernel<<<(unsigned)s.output_blocks(), THREADS, smem_c,
                           stream>>>(x, dt, Cm, cum, hbuf, cb, y, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
