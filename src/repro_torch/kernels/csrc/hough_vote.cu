// Hough voting: rho bins of every (pixel, theta), then a weighted histogram.
//
// Replaces the TPU kernel repro/kernels/hough_vote.py::hough_vote (body
// _vote_kernel).  The TPU kernel keeps a (rho block, theta block) tile of
// the accumulator in VMEM and adds a one-hot contraction of each pixel
// block into it.  Here the tile is output-stationary in shared memory: one
// block owns (frame n, a block of bt thetas, a range of R rho bins), holds
// its hist[R][bt], votes into it with shared-memory atomics, and writes it
// out once.
//
// The rho product keeps the rounding of the reference's f32 dot (XLA's and
// torch's CPU matmul alike): rho = fadd(fma(y, sin, x * cos), z * diag).
// floor() turns any other nesting into moved votes (1046 rho bins at
// 720x1280 for the unfused (x*c + y*s) + d).  With 0/1 weights every bin is
// an integer below 2^24, so the sum is exact in any order; other weights
// may differ from the plain version in the last bits.
//
// What bounds it on this card: the output.  A compacted batch casts about
// 2-3 M votes, far fewer bytes than the (N, n_rho, T) f32 accumulator it
// must write (16.9 MB at 8 x 2938 x 180).  So every bin is written once,
// by the block that owns it, with no fill before: the tile's zeros are
// stored with its votes.  Those stores, rows of bt floats at a stride of
// T, are most of the time left (PERF.md's vote findings).  Lanes run over
// thetas (lane k of a row group keeps its cos / sin / offset in
// registers), rows are staged in shared memory a round at a time (the
// next round's loads in flight during the votes), and only rows of
// nonzero weight are staged.  A block reads its frame's edge count from
// device memory (compaction leaves it there), so the host never learns
// it.
//
// Where the grid would leave the card idle (one frame, a narrow theta
// band), the wrapper splits each frame's rows over `splits` blocks: block
// s takes rows [s * ceil(count / splits), ...) of the count read on the
// device, and adds its nonzero bins into an output the caller zeroed.  A
// tile too large for shared memory even at one theta (n_rho above 54000)
// is cut into `rho_ranges` ranges of rho bins, each block dropping votes
// outside its own.  bt, splits and rho_ranges are runtime parameters of
// this one kernel (kernels/hough_vote.py::launch_plan picks them from the
// shapes); a block is 16 warps.
//
// A call with no counts (a dense raster: every pixel a row, few of them
// edges) first gathers each frame's rows of nonzero weight into a scratch
// buffer and counts them there (hough_gather_kernel, one read of every
// weight), so that the vote's blocks, each of which walks all of its
// frame's rows, walk only those.  The gathered order is the atomics'; it
// changes the order of the adds only, as the shared atomics already do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_THREAD = 2;  // rows a thread stages a round
constexpr int STAGE_ROWS = THREADS * ROWS_PER_THREAD;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS = 8;  // rows a thread of the gather reads
constexpr int MAX_BT = 32;
constexpr int MAX_SMEM = 232448;  // opt-in dynamic shared memory a block
constexpr int MAX_DEVICES = 64;

// Shared memory of a block: the tile (rounded up to whole float4s), the
// staged rows (x, y, z, w) and one kept-row count a warp.
long long smem_bytes(long long tile) {
  return (tile + 3) / 4 * 16 + STAGE_ROWS * 16LL + WARPS * 4;
}

struct Args {
  const float* xy;
  long long xy_frame_stride;
  const float* w;
  long long w_frame_stride;
  const int32_t* counts;
  const float* trig;
  float* out;
  int P, C, T, n_rho;
  int bt, R, theta_blocks, rho_ranges, splits;
  int vector_stores;  // tile rows by float4: bt % 4 == 0, T % 4 == 0, out aligned
};

struct Gather {
  const float* xy;
  long long xy_frame_stride;
  const float* w;
  long long w_frame_stride;
  float* gxy;  // (N, P, C): each frame's kept rows first
  float* gw;   // (N, P)
  int32_t* counts;  // (N,), zeroed before the launch
  int P, C, chunks;
};

// Each frame's rows of nonzero weight (NaN included: it votes, as in the
// plain version) to the front of its scratch rows, counted in `counts`.
// A warp takes 32 consecutive rows at a time and claims their places with
// one atomic.
__global__ void __launch_bounds__(GATHER_THREADS)
hough_gather_kernel(const __grid_constant__ Gather g) {
  const int n = blockIdx.x / g.chunks;
  const long long first =
      (long long)(blockIdx.x % g.chunks) * GATHER_ROWS * GATHER_THREADS +
      threadIdx.x;
  const float* w = g.w + n * g.w_frame_stride;
  float wv[GATHER_ROWS];
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    const long long p = first + (long long)j * GATHER_THREADS;
    wv[j] = p < g.P ? w[p] : 0.0f;
  }
  const float* xy = g.xy + n * g.xy_frame_stride;
  float* gxy = g.gxy + (size_t)n * g.P * g.C;
  float* gw = g.gw + (size_t)n * g.P;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    const bool keep = wv[j] != 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (mask == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(g.counts + n, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) {
      const long long p = first + (long long)j * GATHER_THREADS;
      const int q = base + __popc(mask & ((1u << lane) - 1u));
      gw[q] = wv[j];
      for (int c = 0; c < g.C; ++c)
        gxy[(size_t)q * g.C + c] = xy[(size_t)p * g.C + c];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
hough_vote_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int bt = a.bt;
  const int tile = a.R * bt;
  float* hist = smem;
  float4* rows = reinterpret_cast<float4*>(smem + (tile + 3) / 4 * 4);
  int* warp_kept = reinterpret_cast<int*>(rows + STAGE_ROWS);

  int b = blockIdx.x;
  const int tb = b % a.theta_blocks;
  b /= a.theta_blocks;
  const int rb = b % a.rho_ranges;
  b /= a.rho_ranges;
  const int s = b % a.splits;
  const int n = b / a.splits;
  const int t0 = tb * bt, nt = min(bt, a.T - t0);
  const int r0 = rb * a.R, nr = max(0, min(a.R, a.n_rho - r0));

  float4* hist4 = reinterpret_cast<float4*>(hist);
  for (int i = threadIdx.x; i < (tile + 3) / 4; i += THREADS)
    hist4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // This block's rows: split s of the frame's first `limit`.
  const int limit = a.counts != nullptr ? max(0, min(a.counts[n], a.P)) : a.P;
  const long long share = ((long long)limit + a.splits - 1) / a.splits;
  const int lo = (int)min((long long)s * share, (long long)limit);
  const int hi = (int)min((long long)lo + share, (long long)limit);

  // Lane k of each group of bt lanes votes theta t0 + k for the whole loop.
  // Where bt divides a warp, the warp's gpw groups take rows from gpw
  // segments of the round's staged rows, so that lanes of one theta rarely
  // hit one bin at once (neighbouring edge rows often share it).  A
  // segment holds an odd number of rows, so that the groups' 16-byte row
  // loads fall on other banks.
  const int k = threadIdx.x % bt, slot = threadIdx.x / bt;
  const int slots = THREADS / bt;
  const int gpw = 32 % bt == 0 ? 32 / bt : 1;
  const int seg = slot % gpw, first = slot / gpw, step = slots / gpw;
  const bool voter = slot < slots && k < nt;
  float cs = 0.0f, sn = 0.0f, off = 0.0f;
  if (voter) {
    cs = a.trig[t0 + k];
    sn = a.trig[a.T + t0 + k];
    if (a.C == 3) off = a.trig[2 * a.T + t0 + k];
  }
  const float* xy = a.xy + n * a.xy_frame_stride;
  const float* w = a.w + n * a.w_frame_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // One round's raw rows in registers; w = 0 past `hi` (not staged).
  float4 v[ROWS_PER_THREAD];
  auto fetch = [&](int base) {
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int p = base + j * THREADS + threadIdx.x;
      if (p < hi) {
        const float* q = xy + (size_t)p * a.C;
        v[j] = make_float4(q[0], q[1], a.C == 3 ? q[2] : 0.0f, w[p]);
      } else {
        v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  };

  // The tile counts in int32 while every weight seen is +1 or -1 (the main
  // paths' 0/1 weights): a shared int add is one ATOMS whose result no
  // lane waits for, where the f32 add is a compare-and-swap loop.  The
  // first other weight turns the tile into f32 in place (each count is an
  // integer, exact below 2^24) and the block goes on in f32.
  bool counting = true;
  int* tally = reinterpret_cast<int*>(hist);
  // Each staged row of the round: theta t0 + k of its bin, into the tile.
  // The reference keeps floor(rho) in [0, (float)n_rho); as ints that is
  // [0, top), rho past 2^31 converting to INT_MAX and below -2^31 to
  // INT_MIN, and NaN (which converts to 0) dropped by its own test.  Four
  // rows at a time, for the latency.
  const int top = (int)min((long long)a.n_rho, (long long)ceilf((float)a.n_rho));
  const unsigned vr = (unsigned)max(0, min(nr, top - r0));
  auto vote = [&](auto add, int total) {
    auto one = [&](const float4 r) {
      float rho = __fmaf_rn(r.y, sn, __fmul_rn(r.x, cs));
      if (a.C == 3) rho = __fadd_rn(rho, __fmul_rn(r.z, off));
      const unsigned j = (unsigned)__float2int_rd(rho) - (unsigned)r0;
      if (j < vr && !isnan(rho)) add((int)j * bt + k, r.w);
    };
    const int Q = ((total + gpw - 1) / gpw) | 1;  // odd: segments on other banks
    const float4* mine = rows + seg * Q;
    const int end = min(Q, total - seg * Q);
    int p = first;
    for (; p + 3 * step < end; p += 4 * step) {
      const float4 q0 = mine[p], q1 = mine[p + step];
      const float4 q2 = mine[p + 2 * step], q3 = mine[p + 3 * step];
      one(q0);
      one(q1);
      one(q2);
      one(q3);
    }
    for (; p < end; p += step) one(mine[p]);
  };

  if (lo < hi) fetch(lo);
  for (int base = lo; base < hi; base += STAGE_ROWS) {
    // Stage the round's rows of nonzero weight (a weight of 0 casts no
    // vote; NaN does, as in the plain version), warp by warp.
    bool keep[ROWS_PER_THREAD];
    unsigned mask[ROWS_PER_THREAD];
    int kept = 0, other = 0;
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      keep[j] = v[j].w != 0.0f;
      other |= keep[j] && fabsf(v[j].w) != 1.0f;
      mask[j] = __ballot_sync(0xffffffffu, keep[j]);
      kept += __popc(mask[j]);
    }
    if (lane == 0) warp_kept[warp] = kept;
    __syncthreads();
    int pos = 0, total = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      const int c = warp_kept[q];
      pos += q < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      if (keep[j]) rows[pos + __popc(mask[j] & below)] = v[j];
      pos += __popc(mask[j]);
    }
    if (__syncthreads_or(other) && counting) {
      for (int i = threadIdx.x; i < tile; i += THREADS)
        hist[i] = (float)tally[i];
      counting = false;
      __syncthreads();
    }
    if (base + STAGE_ROWS < hi) fetch(base + STAGE_ROWS);

    if (voter) {
      if (counting)
        vote([&](int i, float wt) { atomicAdd(tally + i, (int)wt); }, total);
      else
        vote([&](int i, float wt) { atomicAdd(hist + i, wt); }, total);
    }
    __syncthreads();
  }
  __syncthreads();

  // The tile out: rows of nt floats at a stride of T.  One split stores
  // every bin, zeros included; several add their nonzero bins.
  float* o = a.out + ((size_t)n * a.n_rho + r0) * a.T + t0;
  auto bin_at = [&](int i) { return counting ? (float)tally[i] : hist[i]; };
  if (a.splits == 1 && a.vector_stores) {
    const int nv = nt / 4;
    const int per = THREADS / nv;
    if (threadIdx.x < per * nv) {
      const int c = threadIdx.x % nv;
      for (int r = threadIdx.x / nv; r < nr; r += per) {
        const int i = (r * bt) / 4 + c;
        float4 val;
        if (counting) {
          const int4 t = reinterpret_cast<const int4*>(tally)[i];
          val = make_float4((float)t.x, (float)t.y, (float)t.z, (float)t.w);
        } else {
          val = hist4[i];
        }
        *reinterpret_cast<float4*>(o + (size_t)r * a.T + 4 * c) = val;
      }
    }
  } else {
    const int per = THREADS / nt;
    if (threadIdx.x < per * nt) {
      const int c = threadIdx.x % nt;
      for (int r = threadIdx.x / nt; r < nr; r += per) {
        const float val = bin_at(r * bt + c);
        if (a.splits == 1)
          o[(size_t)r * a.T + c] = val;
        else if (val != 0.0f)
          atomicAdd(o + (size_t)r * a.T + c, val);
      }
    }
  }
}

// The launch's grid and shared memory; false where the parameters do not
// fit the kernel.
bool plan(int N, int T, int n_rho, int bt, int splits, int rho_ranges,
          long long* blocks, long long* smem, int* R, int* theta_blocks) {
  if (bt < 1 || bt > MAX_BT || splits < 1 || rho_ranges < 1 || n_rho < 1 ||
      rho_ranges > n_rho)
    return false;
  *theta_blocks = (T + bt - 1) / bt;
  *R = (n_rho + rho_ranges - 1) / rho_ranges;
  *blocks = (long long)N * splits * rho_ranges * *theta_blocks;
  *smem = smem_bytes((long long)*R * bt);
  return *smem <= MAX_SMEM && *blocks < (1LL << 31);
}

// The gather's blocks for N frames of P rows.
long long gather_blocks(int N, int P) {
  return (long long)N *
         ((P + GATHER_ROWS * GATHER_THREADS - 1) / (GATHER_ROWS * GATHER_THREADS));
}

}  // namespace

extern "C" {

// The launch plan of hough_vote_f32 at these parameters: out[0..5] = grid
// blocks, threads, shared bytes, R (rho bins a block), theta blocks, and
// the gather's blocks (a call with no counts).  Returns 0, or
// cudaErrorInvalidValue where the kernel does not take them.
int hough_vote_plan(int N, int P, int T, int n_rho, int bt, int splits,
                    int rho_ranges, long long* out) {
  long long blocks = 0, smem = 0;
  int R = 0, theta_blocks = 0;
  if (!plan(N, T, n_rho, bt, splits, rho_ranges, &blocks, &smem, &R,
            &theta_blocks))
    return (int)cudaErrorInvalidValue;
  out[0] = blocks;
  out[1] = THREADS;
  out[2] = smem;
  out[3] = R;
  out[4] = theta_blocks;
  out[5] = gather_blocks(N, P);
  return 0;
}

// xy: f32 rows of C in {2, 3} floats, frame n at xy + n * xy_frame_stride
// (0 for one raster shared by every frame); w: f32, frame n at
// w + n * w_frame_stride; counts: int32 (N,) edge counts or NULL for all P
// rows; trig: f32 (C, T); out: f32 (N, n_rho, T), any contents when
// splits == 1 (every bin is stored), zeroed by the caller otherwise;
// scratch: with no counts, N * P * (C + 1) floats and N int32s of device
// memory (the gathered rows, their weights, their counts), else unused.
int hough_vote_f32(const float* xy, long long xy_frame_stride, const float* w,
                   long long w_frame_stride, const int32_t* counts,
                   const float* trig, float* out, int N, int P, int C, int T,
                   int n_rho, int bt, int splits, int rho_ranges,
                   float* scratch, cudaStream_t stream) {
  Args a{xy, xy_frame_stride, w, w_frame_stride, counts, trig, out,
         P, C, T, n_rho, bt, 0, 0, rho_ranges, splits, 0};
  long long blocks = 0, smem = 0;
  if (C < 2 || C > 3 ||
      (counts == nullptr &&
       (scratch == nullptr || gather_blocks(N, P) >= (1LL << 31))) ||
      !plan(N, T, n_rho, bt, splits, rho_ranges, &blocks, &smem, &a.R,
            &a.theta_blocks))
    return (int)cudaErrorInvalidValue;
  a.vector_stores = bt % 4 == 0 && T % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (blocks == 0) return (int)cudaGetLastError();
  if (counts == nullptr && P > 0) {
    Gather g{xy, xy_frame_stride, w, w_frame_stride, scratch,
             scratch + (size_t)N * P * C, nullptr, P, C,
             (P + GATHER_ROWS * GATHER_THREADS - 1) /
                 (GATHER_ROWS * GATHER_THREADS)};
    g.counts = reinterpret_cast<int32_t*>(g.gw + (size_t)N * P);
    cudaError_t e = cudaMemsetAsync(g.counts, 0, sizeof(int32_t) * N, stream);
    if (e != cudaSuccess) return (int)e;
    hough_gather_kernel<<<(unsigned)gather_blocks(N, P), GATHER_THREADS, 0,
                          stream>>>(g);
    a.xy = g.gxy;
    a.xy_frame_stride = (long long)P * C;
    a.w = g.gw;
    a.w_frame_stride = P;
    a.counts = g.counts;
  }
  if (smem > 48 * 1024) {
    // Raised once a device to the largest size asked so far, so that a
    // warm call only launches.
    static std::atomic<int> raised[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES ||
        raised[dev].load(std::memory_order_relaxed) < (int)smem) {
      e = cudaFuncSetAttribute(hough_vote_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES)
        raised[dev].store((int)smem, std::memory_order_relaxed);
    }
  }
  hough_vote_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
