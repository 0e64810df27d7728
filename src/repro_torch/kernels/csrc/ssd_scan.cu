// Mamba-2 SSD chunked scan: intra-chunk masked-decay products, an (N, P)
// state carried across chunks; y and the final state out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  The TPU carries the state in VMEM scratch through the
// grid's sequential chunk axis.  Blocks on this card run in parallel in no
// order, so one block owns one (batch, head) and loops over the chunks
// itself, with the state in shared memory.  For each chunk of Q steps
// (Q = min(chunk, L)):
//
//   cum  = inclusive cumsum of ldec = dt * A            (log-decay, <= 0)
//   G    = (C B^T) o tril(exp(cum_i - cum_j))            (Q x Q)
//   y    = G . xdt + (C . h) o exp(cum)                  (Q x P)
//   h    = exp(cum_Q) h + (B o exp(cum_Q - cum))^T . xdt (N x P)
//
// with xdt = x * dt formed by the wrapper, as the reference's wrapper does.
// B and C are shared per group: head h reads group h / (H / G).  The ragged
// tail of the last chunk, and the rows that round Q up to a multiple of 4
// in shared memory, are identity steps (zero x, B, C and log-decay), so
// they add nothing to y or to the state.
//
// What bounds it on this card: at the serving shapes (H = 64 heads, P = 64,
// N = 64, Q = 128, one group, B = 1) the work is about 2 * (Q^2 N + Q^2 P/2
// + 2 Q N P) = 6.3 MFLOP a chunk and head against 4 * Q * (P + 2N + 1)
// bytes of input, ~100 FLOP a byte: the f32 rate, not the memory, is the
// bound, and the inputs are f32 (the reference casts them so).  The design
// keeps one chunk's C, B^T, xdt, G and the state in shared memory (about
// 184 KB at Q = 128, through cudaFuncSetAttribute) and gives each thread a
// 4 x 4 block of every product in registers, reading the right operand as
// float4, so a shared-memory read feeds 2-4 FMAs; G . xdt stops at each
// row block's diagonal.  With B = 1 the grid is 64 blocks, fewer than the
// 132 SMs: splitting the chunk axis across blocks (a second pass to
// combine states) is later work, as are wgmma and TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Layout {
  int QP, N, P, ldbt, ldc, ldg;
  __host__ __device__ Layout(int Q, int N_, int P_)
      : QP((Q + 3) / 4 * 4), N(N_), P(P_), ldbt(QP + 4), ldc(N_ + 1),
        ldg(QP + 1) {}
  // float offsets; the float4-read arrays (Bt, Xs, Hs) come first, each a
  // multiple of 4 floats long, so every one is 16-byte aligned.
  __host__ __device__ int bt() const { return 0; }
  __host__ __device__ int xs() const { return N * ldbt; }
  __host__ __device__ int hs() const { return xs() + QP * P; }
  __host__ __device__ int cs() const { return hs() + N * P; }
  __host__ __device__ int gs() const { return cs() + QP * ldc; }
  __host__ __device__ int cum() const { return gs() + QP * ldg; }
  __host__ __device__ int ecum() const { return cum() + QP; }
  __host__ __device__ int edec() const { return ecum() + QP; }
  __host__ __device__ int floats() const { return edec() + QP; }
};

// acc[a][b] += sum_{k < K} A[(r0 + a) * lda + k] * s(k) * B[k * ldb + c0 + b],
// s(k) = scale[k] or 1; B read as float4 (c0 and ldb multiples of 4).
template <bool SCALED>
__device__ __forceinline__ void tile_product(float acc[4][4], const float* A,
                                             int lda, const float* scale,
                                             const float* B, int ldb, int r0,
                                             int c0, int K) {
  for (int kk = 0; kk < K; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(B + kk * ldb + c0);
    const float sk = SCALED ? scale[kk] : 1.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float av = SCALED ? A[(r0 + a) * lda + kk] * sk
                              : A[(r0 + a) * lda + kk];
      acc[a][0] = fmaf(av, bv.x, acc[a][0]);
      acc[a][1] = fmaf(av, bv.y, acc[a][1]);
      acc[a][2] = fmaf(av, bv.z, acc[a][2]);
      acc[a][3] = fmaf(av, bv.w, acc[a][3]);
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
}

// One block per (batch, head).  xdt: (Bt, L, H, P); ldec: (Bt, L, H);
// Bm, Cm: (Bt, L, G, N); y: (Bt, L, H, P); state: (Bt, H, N, P); all f32,
// contiguous.
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ ldec,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ state, int L,
                int H, int G, int N, int P, int Q) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(Q, N, P);
  const int QP = lay.QP;
  float* Bt = smem + lay.bt();       // N x ldbt: B^T of the chunk
  float* Xs = smem + lay.xs();       // QP x P: xdt of the chunk
  float* Hs = smem + lay.hs();       // N x P: the carried state
  float* Cs = smem + lay.cs();       // QP x ldc: C of the chunk
  float* Gs = smem + lay.gs();       // QP x ldg: (C B^T) o decay mask
  float* cum = smem + lay.cum();     // QP: inclusive log-decay prefix
  float* ecum = smem + lay.ecum();   // QP: exp(cum_i)
  float* edec = smem + lay.edec();   // QP: exp(cum_last - cum_j)

  const int bh = blockIdx.x;         // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;

  for (int e = tid; e < N * P; e += THREADS) Hs[e] = 0.0f;

  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();                 // the last chunk's reads are done
    for (int e = tid; e < QP * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      const bool real = i < Q && t0 + i < L;
      const size_t at = ((size_t)(b * L + t0 + i) * G + g) * N + n;
      Bt[n * lay.ldbt + i] = real ? Bm[at] : 0.0f;
      Cs[i * lay.ldc + n] = real ? Cm[at] : 0.0f;
    }
    for (int e = tid; e < QP * P; e += THREADS) {
      const int i = e / P, p = e - i * P;
      const bool real = i < Q && t0 + i < L;
      Xs[e] = real ? xdt[((size_t)(b * L + t0 + i) * H + h) * P + p] : 0.0f;
    }
    // Inclusive cumsum of the log-decay in warp 0: each lane sums a run of
    // consecutive steps, then the lanes scan their totals.
    if (tid < 32) {
      const int per = (QP + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, QP);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        const bool real = i < Q && t0 + i < L;
        run += real ? ldec[(size_t)(b * L + t0 + i) * H + h] : 0.0f;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += before;
    }
    __syncthreads();
    const float cum_last = cum[QP - 1];
    for (int i = tid; i < QP; i += THREADS) {
      ecum[i] = expf(cum[i]);
      edec[i] = expf(cum_last - cum[i]);
    }

    // G = (C B^T) o tril(exp(cum_i - cum_j)), 4 x 4 blocks.
    const int qt = QP / 4;
    for (int t = tid; t < qt * qt; t += THREADS) {
      const int r0 = (t / qt) * 4, c0 = (t - (t / qt) * qt) * 4;
      float acc[4][4];
      zero(acc);
      if (c0 <= r0 + 3)
        tile_product<false>(acc, Cs, lay.ldc, nullptr, Bt, lay.ldbt, r0, c0, N);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = r0 + a, j = c0 + bb;
          Gs[i * lay.ldg + j] = i >= j ? acc[a][bb] * expf(cum[i] - cum[j]) : 0.0f;
        }
    }
    __syncthreads();

    // y = G . xdt + (C . h) o exp(cum); G is zero past the diagonal, so a
    // row block stops at its last row.
    const int pt = P / 4;
    for (int t = tid; t < qt * pt; t += THREADS) {
      const int r0 = (t / pt) * 4, c0 = (t - (t / pt) * pt) * 4;
      float intra[4][4], inter[4][4];
      zero(intra);
      zero(inter);
      tile_product<false>(intra, Gs, lay.ldg, nullptr, Xs, P, r0, c0, r0 + 4);
      tile_product<false>(inter, Cs, lay.ldc, nullptr, Hs, P, r0, c0, N);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + a;
        if (i >= Q || t0 + i >= L) continue;
        float* yo = y + ((size_t)(b * L + t0 + i) * H + h) * P + c0;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) yo[bb] = intra[a][bb] + inter[a][bb] * ecum[i];
      }
    }
    __syncthreads();

    // h <- exp(cum_last) h + (B o exp(cum_last - cum))^T . xdt; each thread
    // reads and writes only its own block of h.
    const float decay = expf(cum_last);
    for (int t = tid; t < (N / 4) * pt; t += THREADS) {
      const int r0 = (t / pt) * 4, c0 = (t - (t / pt) * pt) * 4;
      float acc[4][4];
      zero(acc);
      tile_product<true>(acc, Bt, lay.ldbt, edec, Xs, P, r0, c0, QP);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float* hp = Hs + (r0 + a) * P + c0 + bb;
          *hp = decay * *hp + acc[a][bb];
        }
    }
  }
  __syncthreads();
  float* so = state + (size_t)bh * N * P;
  for (int e = tid; e < N * P; e += THREADS) so[e] = Hs[e];
}

}  // namespace

extern "C" {

// Bytes of shared memory a block needs for chunk Q and (N, P).
long long ssd_scan_smem_bytes(int Q, int N, int P) {
  return (long long)sizeof(float) * Layout(Q, N, P).floats();
}

// xdt: (Bt, L, H, P) = x * dt; ldec: (Bt, L, H) = dt * A; Bm, Cm: (Bt, L,
// G, N); y: (Bt, L, H, P); state: (Bt, H, N, P).  All f32 and contiguous;
// H % G == 0, N % 4 == 0, P % 4 == 0, 1 <= Q <= 128.
int ssd_scan_f32(const float* xdt, const float* ldec, const float* Bm,
                 const float* Cm, float* y, float* state, int Bt, int L, int H,
                 int G, int N, int P, int Q, cudaStream_t stream) {
  if (Bt <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      P <= 0 || N % 4 != 0 || P % 4 != 0 || Q <= 0 || Q > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ssd_scan_smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<Bt * H, THREADS, smem, stream>>>(xdt, ldec, Bm, Cm, y,
                                                     state, L, H, G, N, P, Q);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
