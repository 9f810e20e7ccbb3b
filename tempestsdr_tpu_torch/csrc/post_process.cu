// The frame post-process of the default order as three launches, for
// Hopper (sm_90a): autogain's statistics and the f64 collapse in one read of
// the frame, both sweet-spot searches (one thread block a frame and axis),
// the IIR centre tracking and the PLL, then normalize, autoshift or
// markers, the motion-blur IIR and the SNR's sums in one elementwise pass.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the JAX package's
// post-process chain (tempestsdr_tpu/stream/pipeline.py
// _post_process_default_order) into a few fusions of its own. PyTorch runs
// the same chain as about 240 small kernels a frame (ops/frame.py,
// ops/sync.py), each a node of the step's CUDA graph and a launch of 1-2 us;
// that chain was most of a block's device time at 8 x 16 MS/s. It stays as
// the plain version (stream/pipeline.py _post_process_default_order), which
// the CPU runs and this kernel is held to on the card.
//
// Computes, for each frame f [H, W] of a stack of B (frame b at
// frame + b*frame_stride; every carry one value per frame):
//
//   stats:  hprof[i] = sum_j f[i,j], wprof[j] = sum_i f[i,j] (f64), and over
//           the pixels with |v| <= 250 (not special) min, max and sum, the
//           min and max seeded with f[0,0] as autogain_run does;
//   search: autogain's IIR (lastmin2, lastmax2, f32), the mean; for each
//           profile the circular 5-tap blur, the doubled f64 cumulative sum,
//           the five candidate strips' window sums and metric, first-wins
//           argmax, the reference's id-off-by-one, the IIR centre tracking
//           (floor remainder, round half to even, the blend as one fma);
//           then framerate_pll from the x axis' velocity;
//   apply:  out = screen*mb + norm*(1 - mb), norm = (f - min)/span at the
//           pixel autoshift gathers (or f's own, with the markers set where
//           they fall), and sum (f-mean)^2 and sum (f-mean) for the SNR,
//           finished by the last thread block of the frame.
//
// Every product, sum and quotient that the plain chain takes as a separate
// PyTorch op is rounded alone here (__fmul_rn, __fadd_rn, __fdiv_rn and
// their f64 forms: no contraction), so given the same min and max the
// frames equal the plain chain's bit for bit, and at default Params (no
// autoshift) they do not depend on the search at all. The centre's blend is
// the fused multiply-add that the JAX step's compiled blend contracts and
// ops/sync.py _fused_blend emulates. The sums are taken in a fixed order of
// their own (partials per tile, finished in index order; a block scan for
// the cumulative sums): on every replay the search sees the same profile,
// which may differ from the plain chain's in its last bits, the latitude the
// card's torch.sum and torch.cumsum already take. No float atomics: the one
// atomic counts the SNR pass's finished blocks.
//
// Bound on this card: memory. A frame is read by the stats pass and again
// by the apply pass (from the 50 MB L2 where it fits); the screen is read,
// and the new screen and the emitted frame (a copy of it, which the step's
// IF node would otherwise make) are written: 4 * H*W*4 bytes in the bound,
// 8.5 MB at 628 x 849 (2.5 us at 3.35 TB/s) and 34 MB at 628 x 3397 (10.2
// us). The search reads a few hundred kB of partials and runs about
// 5*(H+W) f64 metrics of two IEEE divisions each, on two thread blocks.
//
// Design against that: the stats pass tiles a frame into row tiles of at
// most kMaxRows rows by column tiles of 1024 columns (256 threads, four
// columns each, coalesced 4-byte loads: a line of an odd width is not
// 16-byte aligned); a thread issues every load of its tile before it sums,
// keeps its column sums in registers and its row sums in shared memory, so
// one read of the frame gives both profiles; about 32 row tiles a frame
// keep the partials small. The search runs one thread block of 512 threads
// per frame and axis (x with autogain and the PLL, y alone), the partials
// finished eight loads at a time; its profile and cumulative sum (3n + 1
// doubles an axis of n pixels) live in a global scratch, read back through
// L1 and L2, so no width runs out of shared memory (a superresolution
// pipeline at 256 MS/s has 13,588 pixels a line: 326 kB an axis). The
// apply pass is 2048 pixels a thread block, its SNR partials finished by the
// frame's last block (a counter the search zeroes). Measured on an NVIDIA
// H100 80GB HBM3 at 700.00 W, in a CUDA graph of 16 chained
// post-processes: 0.030 ms a frame at 628 x 849 (stats 0.009, search
// 0.012, apply 0.008), 0.062 ms at 628 x 3397 (0.010, 0.031, 0.020) and
// 0.221 ms at 628 x 13588 (0.028, 0.113, 0.077), against 0.53, 0.51 and
// 1.06 ms for the plain chain in the same graph (PERF.md). What keeps them
// above the bound is latency: a frame's work is a few microseconds of
// traffic spread over three dependent launches, and the search, which
// grows with the width, runs on two SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrors kernels/post_process.py _Args field for field. Outside the
// anonymous namespace: the C entry point takes it, and a type of internal
// linkage would take the entry point's external linkage with it.
struct Args {
  // inputs
  const float* frame;
  const float* screen;
  const float* motionblur;
  const float* ag_min;
  const float* ag_max;
  const int* sx_size;
  const int* sx_dx;
  const int* sy_size;
  const int* sy_dx;
  const double* pll_avg;
  const float* pll_delta;
  // outputs
  float* out;
  float* out2;  // a second copy of out (the emitted frame), or null
  float* ag_min_out;
  float* ag_max_out;
  float* ag_snr_out;
  int* sx_size_out;
  int* sx_dx_out;
  int* sx_vx_out;
  int* sy_size_out;
  int* sy_dx_out;
  int* sy_vx_out;
  double* pll_avg_out;
  unsigned char* pll_locked_out;
  float* pll_delta_out;
  // scratch
  double* colpart;    // [B, n_rtiles, W]
  double* rowpart;    // [B, n_ctiles, H]
  float* tile_min;    // [B, n_rtiles * n_ctiles]
  float* tile_max;
  double* tile_sum;
  double* sq_part;    // [B, apply_blocks, 2]
  float* apply_par;   // [B, 4]: min, span, mean
  int* done;          // [B]: apply blocks finished
  double* search;     // [B, 3 (W + H) + 2]: each axis' profile and doubled cumulative sum
  long long batch;
  long long frame_stride;
  long long mb_stride;  // 0: one motion blur for every frame
  double blur[5];
  double coeff_x;
  double coeff_y;
  int h;
  int w;
  int rows_per_tile;
  int n_rtiles;
  int n_ctiles;
  int apply_blocks;
  int minsize_x;
  int minsize_y;
  int pll_enabled;
  int mode;  // 0: plain, 1: autoshift, 2: markers
  float ag_keep;  // 1 - NORMALISATION_LOWPASS_COEFF, as f32
  float ag_norm;  // NORMALISATION_LOWPASS_COEFF, as f32
  float max_delta;
  float marker;
};

namespace {

constexpr int kStatsThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColTile = kStatsThreads * kColsPerThread;  // columns of a stats tile
constexpr int kMaxRows = 20;  // rows of a stats tile at most (the row buffer's depth)
constexpr int kSearchThreads = 512;
constexpr int kApplyThreads = 256;
constexpr int kApplyItems = 8;
constexpr int kApplyTile = kApplyThreads * kApplyItems;  // pixels of an apply block
constexpr float kSpecial = 250.0f;  // dsp.c:57, |v| beyond it is a debug marker
constexpr float kBig = 3.4e38f;     // autogain_run's stand-in for a special pixel
constexpr unsigned kFull = 0xffffffffu;

// min and max that propagate a NaN, as torch's amin, amax, minimum, maximum
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ double warp_sum(double v) {  // lane 0 holds the sum
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// (a at ia) replaces (b at ib) as a running argmax: the larger value, a NaN
// above every number, the first index among equals (torch.argmax).
__device__ __forceinline__ bool beats(double a, int ia, double b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ int floor_mod(long long x, int n) {
  long long r = x % n;
  return (int)(r < 0 ? r + n : r);
}

__global__ void __launch_bounds__(kStatsThreads) post_process_stats_kernel(const Args a) {
  __shared__ double rows[kMaxRows][kStatsThreads];
  __shared__ float wmin[kStatsThreads / 32], wmax[kStatsThreads / 32];
  __shared__ double wsum[kStatsThreads / 32];
  const int b = blockIdx.y;
  const int ct = blockIdx.x % a.n_ctiles, rt = blockIdx.x / a.n_ctiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rt * a.rows_per_tile, r1 = min(r0 + a.rows_per_tile, a.h);
  const int c0 = ct * kColTile + tid;
  const float* f = a.frame + b * a.frame_stride;
  double col[kColsPerThread];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) col[q] = 0.0;
  // every load of the tile first (kMaxRows * kColsPerThread in flight a
  // thread), then the sums in row order
  float v[kMaxRows][kColsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int c = c0 + q * kStatsThreads;
      v[k][q] = r0 + k < r1 && c < a.w ? __ldg(f + (long long)(r0 + k) * a.w + c) : 0.0f;
    }
  }
  float lo = kBig, hi = -kBig;
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    if (r0 + k >= r1) break;
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      if (c0 + q * kStatsThreads < a.w) {
        const float x = v[k][q];
        const double dx = (double)x;
        col[q] = __dadd_rn(col[q], dx);
        acc = __dadd_rn(acc, dx);
        if (!(x > kSpecial || x < -kSpecial)) {
          lo = nan_min(lo, x);
          hi = nan_max(hi, x);
          sum = __dadd_rn(sum, dx);
        }
      }
    }
    rows[k][tid] = acc;
  }
  double* cp = a.colpart + ((long long)b * a.n_rtiles + rt) * a.w;
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int c = c0 + q * kStatsThreads;
    if (c < a.w) cp[c] = col[q];
  }
  __syncthreads();
  // each warp finishes rows warp, warp + 8, ... of the tile, in a fixed order
  double* rp = a.rowpart + ((long long)b * a.n_ctiles + ct) * a.h;
  for (int i = warp; i < r1 - r0; i += kStatsThreads / 32) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < kStatsThreads / 32; ++k) v = __dadd_rn(v, rows[i][lane + 32 * k]);
    v = warp_sum(v);
    if (lane == 0) rp[r0 + i] = v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = nan_min(lo, __shfl_down_sync(kFull, lo, o));
    hi = nan_max(hi, __shfl_down_sync(kFull, hi, o));
    sum = __dadd_rn(sum, __shfl_down_sync(kFull, sum, o));
  }
  if (lane == 0) {
    wmin[warp] = lo;
    wmax[warp] = hi;
    wsum[warp] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kStatsThreads / 32; ++k) {
      lo = nan_min(lo, wmin[k]);
      hi = nan_max(hi, wmax[k]);
      sum = __dadd_rn(sum, wsum[k]);
    }
    const long long t = (long long)b * a.n_rtiles * a.n_ctiles + blockIdx.x;
    a.tile_min[t] = lo;
    a.tile_max[t] = hi;
    a.tile_sum[t] = sum;
  }
}

struct Track {
  int size, dx, vx;
};

// One detection round (ops/sync.py find_the_sweet_spot) on the profile in
// prof[0, n), every thread of the block taking part; csum holds 2n + 1
// doubles. Both are global memory of this block's own: __syncthreads orders
// the block's global accesses as it does its shared ones. Returns the new
// carry to every thread.
__device__ Track search_axis(const Args& a, double* prof, double* csum, int n, int minsize,
                             double coeff, int size_in, int dx_in) {
  __shared__ double red_v[5][kSearchThreads / 32];
  __shared__ int red_i[5][kSearchThreads / 32];
  __shared__ double scan_w[kSearchThreads / 32];
  __shared__ Track result;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kSearchThreads / 32;

  // the circular blur, summed from the leftmost tap as gaussian_blur_circular
  for (int j = tid; j < n; j += kSearchThreads) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < 5; ++k) v = __dadd_rn(v, __dmul_rn(a.blur[k], prof[floor_mod(j + k - 2, n)]));
    csum[1 + j] = v;
    csum[1 + n + j] = v;
  }
  if (tid == 0) csum[0] = 0.0;
  __syncthreads();

  // inclusive scan of csum[1, 2n]: a chunk a thread, the chunks' totals
  // scanned across the block
  const int m2 = 2 * n, per = (m2 + kSearchThreads - 1) / kSearchThreads;
  const int lo = 1 + min(tid * per, m2), hi = 1 + min((tid + 1) * per, m2);
  double own = 0.0;
  for (int i = lo; i < hi; ++i) own = __dadd_rn(own, csum[i]);
  double incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = __dadd_rn(y, incl);
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) scan_w[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kWarps ? scan_w[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = __dadd_rn(y, t);
    }
    double e = __shfl_up_sync(kFull, t, 1);
    if (lane == 0) e = 0.0;
    if (lane < kWarps) scan_w[lane] = e;
  }
  __syncthreads();
  double run = __dadd_rn(scan_w[warp], excl);  // scan_w[0] and lane 0's excl are 0
  for (int i = lo; i < hi; ++i) {
    run = __dadd_rn(run, csum[i]);
    csum[i] = run;
  }
  __syncthreads();
  const double total = csum[n];

  // the probe set {curr, curr-4, curr+4, curr>>1, curr<<1} (_candidate_sizes)
  const int ms = max(minsize, 1), size2 = n >> 1;
  const int curr = min(max(size_in, ms), size2);
  const int cand[5] = {curr, curr - 4, curr + 4, curr >> 1, curr << 1};
  int safe[5];
  bool valid[5];
  double den[5], s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    valid[i] = i == 0 || (cand[i] >= ms && cand[i] < size2 && cand[i] != curr);
    safe[i] = valid[i] ? cand[i] : curr;
    s[i] = (double)safe[i];
    den[i] = __dsub_rn((double)n, s[i]);
  }
  double best[5];
  int at[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    best[i] = -INFINITY;
    at[i] = 0x7fffffff;
  }
  for (int j = tid; j < n; j += kSearchThreads) {
    const double base = csum[j];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const double w = __dsub_rn(csum[safe[i] + j], base);
      double m = __dsub_rn(__ddiv_rn(__dsub_rn(total, w), den[i]), __ddiv_rn(w, s[i]));
      m = __dmul_rn(m, m);
      if (beats(m, j, best[i], at[i])) {
        best[i] = m;
        at[i] = j;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    for (int o = 16; o > 0; o >>= 1) {
      const double v = __shfl_down_sync(kFull, best[i], o);
      const int k = __shfl_down_sync(kFull, at[i], o);
      if (beats(v, k, best[i], at[i])) {
        best[i] = v;
        at[i] = k;
      }
    }
    if (lane == 0) {
      red_v[i][warp] = best[i];
      red_i[i][warp] = at[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    // lane i < 5 takes candidate i's winner over the warps
    double bv = -INFINITY;
    int bi = 0x7fffffff;
    if (lane < 5) {
      for (int k = 0; k < kWarps; ++k) {
        if (beats(red_v[lane][k], red_i[lane][k], bv, bi)) {
          bv = red_v[lane][k];
          bi = red_i[lane][k];
        }
      }
    }
    // the winning candidate: first-wins argmax of the valid ones' maxima
    int win = 0, win_at = __shfl_sync(kFull, bi, 0);
    double fw = __shfl_sync(kFull, bv, 0);
#pragma unroll
    for (int i = 1; i < 5; ++i) {
      const double v = __shfl_sync(kFull, bv, i);
      const int k = __shfl_sync(kFull, bi, i);
      const double fi = valid[i] ? v : -INFINITY;
      if (beats(fi, i, fw, win)) {
        fw = fi;
        win = i;
        win_at = k;
      }
    }
    int size = safe[0];
#pragma unroll
    for (int i = 1; i < 5; ++i) size = win == i ? safe[i] : size;
    const int start = max(win_at - 1, 0);  // the reference's id-off-by-one (:46-56)
    // IIR centre tracking with wraparound (_iir_track, syncdetector.c:101-118)
    const int h2 = n / 2;
    int dxnl = floor_mod((long long)start + size / 2, n);
    const int rawdiff = dxnl - dx_in;
    const int dx0 = rawdiff > h2 ? dx_in + n : dx_in;
    if (rawdiff < -h2) dxnl += n;
    const double y = __dmul_rn(__dsub_rn(1.0, coeff), (double)dx0);
    const double blended = fma((double)dxnl, coeff, y);
    const int dx1 = floor_mod((long long)rint(blended), n);
    const int rawvx = dx1 - dx0;
    if (lane == 0) {
      result.size = size;
      result.dx = dx1;
      result.vx = rawvx > h2 ? n - rawvx : (rawvx < -h2 ? -n - rawvx : rawvx);
    }
  }
  __syncthreads();
  return result;
}

// prof[i] = sum over t < tiles of part[t * stride + i], t in order, for
// i < n; eight loads in flight a thread.
__device__ void finish_sums(const double* part, long long stride, int tiles, int n,
                            double* prof) {
  for (int i = threadIdx.x; i < n; i += kSearchThreads) {
    const double* p = part + i;
    double v = 0.0;
    int t = 0;
    for (; t + 8 <= tiles; t += 8) {
      double x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = p[(t + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) v = __dadd_rn(v, x[u]);
    }
    for (; t < tiles; ++t) v = __dadd_rn(v, p[t * stride]);
    prof[i] = v;
  }
}

// One thread block a frame and axis: blockIdx.y 0 finishes autogain, the x
// axis (the column sums) and the PLL, 1 the y axis (the row sums).
__global__ void __launch_bounds__(kSearchThreads) post_process_search_kernel(const Args a) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  // x: prof [W], csum [2W + 1]; y after it: prof [H], csum [2H + 1]
  double* prof = a.search + (long long)b * (3 * (a.w + a.h) + 2) +
                 (blockIdx.y == 1 ? 3 * a.w + 1 : 0);
  double* csum = prof + (blockIdx.y == 1 ? a.h : a.w);
  const long long tiles = (long long)a.n_rtiles * a.n_ctiles;

  if (blockIdx.y == 1) {
    finish_sums(a.rowpart + (long long)b * a.n_ctiles * a.h, a.h, a.n_ctiles, a.h, prof);
    __syncthreads();
    const Track sy =
        search_axis(a, prof, csum, a.h, a.minsize_y, a.coeff_y, a.sy_size[b], a.sy_dx[b]);
    if (tid == 0) {
      a.sy_size_out[b] = sy.size;
      a.sy_dx_out[b] = sy.dx;
      a.sy_vx_out[b] = sy.vx;
    }
    return;
  }

  // autogain: the tiles' min, max and sum finished by warp 0
  if (tid < 32) {
    float lo = kBig, hi = -kBig;
    double sum = 0.0;
    for (long long t = b * tiles + lane; t < (b + 1) * tiles; t += 32) {
      lo = nan_min(lo, a.tile_min[t]);
      hi = nan_max(hi, a.tile_max[t]);
      sum = __dadd_rn(sum, a.tile_sum[t]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = nan_min(lo, __shfl_down_sync(kFull, lo, o));
      hi = nan_max(hi, __shfl_down_sync(kFull, hi, o));
      sum = __dadd_rn(sum, __shfl_down_sync(kFull, sum, o));
    }
    if (lane == 0) {
      const float f0 = a.frame[b * a.frame_stride];
      const float cur_min = nan_min(lo, f0), cur_max = nan_max(hi, f0);
      const float mx = __fadd_rn(__fmul_rn(a.ag_keep, a.ag_max[b]), __fmul_rn(a.ag_norm, cur_max));
      const float mn = __fadd_rn(__fmul_rn(a.ag_keep, a.ag_min[b]), __fmul_rn(a.ag_norm, cur_min));
      a.ag_min_out[b] = mn;
      a.ag_max_out[b] = mx;
      a.apply_par[4 * b] = mn;
      a.apply_par[4 * b + 1] = mx == mn ? 1.0f : __fsub_rn(mx, mn);
      a.apply_par[4 * b + 2] = __fdiv_rn(__double2float_rn(sum), (float)((long long)a.h * a.w));
      a.done[b] = 0;
    }
  }

  finish_sums(a.colpart + (long long)b * a.n_rtiles * a.w, a.w, a.n_rtiles, a.w, prof);
  __syncthreads();
  const Track sx = search_axis(a, prof, csum, a.w, a.minsize_x, a.coeff_x, a.sx_size[b], a.sx_dx[b]);
  if (tid == 0) {
    a.sx_size_out[b] = sx.size;
    a.sx_dx_out[b] = sx.dx;
    a.sx_vx_out[b] = sx.vx;
    // framerate_pll (syncdetector.c:133-153) from the x axis' velocity
    const double vx = (double)sx.vx;
    const double avg = __dadd_rn(__dmul_rn(a.pll_avg[b], 0.99), __dmul_rn(0.01, vx));
    const bool locked = avg < 0.5 && avg > -0.5;
    float delta = a.pll_delta[b];
    if (a.pll_enabled) {
      double diff = locked ? __dmul_rn(avg, 1e-6) : __dmul_rn(vx, 1e-5);
      if (sx.vx == 0) diff = 0.0;
      delta = __fsub_rn(delta, __double2float_rn(diff));
      delta = delta < -a.max_delta ? -a.max_delta : delta;
      delta = delta > a.max_delta ? a.max_delta : delta;
    }
    a.pll_avg_out[b] = avg;
    a.pll_locked_out[b] = locked ? 1 : 0;
    a.pll_delta_out[b] = delta;
  }
}

__global__ void __launch_bounds__(kApplyThreads) post_process_apply_kernel(const Args a) {
  __shared__ double w2[kApplyThreads / 32], w1[kApplyThreads / 32];
  __shared__ bool last;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long npx = (long long)a.h * a.w;
  const float* f = a.frame + b * a.frame_stride;
  const float* scr = a.screen + b * npx;
  float* out = a.out + b * npx;
  float* out2 = a.out2 == nullptr ? nullptr : a.out2 + b * npx;
  const float mn = a.apply_par[4 * b], span = a.apply_par[4 * b + 1];
  const float mean = a.apply_par[4 * b + 2];
  const float mb = a.motionblur[b * a.mb_stride];
  const float keep = __fsub_rn(1.0f, mb);
  const int dx = a.sx_dx_out[b], dy = a.sy_dx_out[b];
  double s2 = 0.0, s1 = 0.0;
  const long long first = (long long)blockIdx.x * kApplyTile + tid;
#pragma unroll
  for (int it = 0; it < kApplyItems; ++it) {
    const long long e = first + (long long)it * kApplyThreads;
    if (e >= npx) break;
    float v, x;
    if (a.mode == 0) {
      v = f[e];
      x = __fdiv_rn(__fsub_rn(v, mn), span);
    } else {
      const int i = (int)(e / a.w), j = (int)(e - (long long)i * a.w);
      if (a.mode == 1) {
        v = f[(long long)floor_mod((long long)i + dy, a.h) * a.w + floor_mod((long long)j + dx, a.w)];
        x = __fdiv_rn(__fsub_rn(v, mn), span);
      } else {
        v = f[e];
        x = (j == dx || i == dy) ? a.marker : __fdiv_rn(__fsub_rn(v, mn), span);
      }
    }
    const float o = __fadd_rn(__fmul_rn(scr[e], mb), __fmul_rn(x, keep));
    out[e] = o;
    if (out2 != nullptr) out2[e] = o;
    const float d = __fsub_rn(v, mean);
    s2 = __dadd_rn(s2, (double)__fmul_rn(d, d));
    s1 = __dadd_rn(s1, (double)d);
  }
  s2 = warp_sum(s2);
  s1 = warp_sum(s1);
  if (lane == 0) {
    w2[warp] = s2;
    w1[warp] = s1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kApplyThreads / 32; ++k) {
      s2 = __dadd_rn(s2, w2[k]);
      s1 = __dadd_rn(s1, w1[k]);
    }
    double* part = a.sq_part + ((long long)b * a.apply_blocks + blockIdx.x) * 2;
    part[0] = s2;
    part[1] = s1;
    __threadfence();
    last = atomicAdd(a.done + b, 1) == a.apply_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the frame's last block: the SNR from every block's partials, in order
  __threadfence();
  s2 = 0.0;
  s1 = 0.0;
  const double* parts = a.sq_part + (long long)b * a.apply_blocks * 2;
  for (int k = tid; k < a.apply_blocks; k += kApplyThreads) {
    s2 = __dadd_rn(s2, __ldcg(parts + 2 * k));
    s1 = __dadd_rn(s1, __ldcg(parts + 2 * k + 1));
  }
  s2 = warp_sum(s2);
  s1 = warp_sum(s1);
  __syncthreads();
  if (lane == 0) {
    w2[warp] = s2;
    w1[warp] = s1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kApplyThreads / 32; ++k) {
      s2 = __dadd_rn(s2, w2[k]);
      s1 = __dadd_rn(s1, w1[k]);
    }
    // autogain_run's SNR: var over every pixel, the mean of the others over
    // the full size (dsp.c:60-88), in f32 as the plain chain
    const float n = (float)npx, sum2 = __double2float_rn(s2), sum3 = __double2float_rn(s1);
    const float var = __fdiv_rn(__fsub_rn(sum2, __fdiv_rn(__fmul_rn(sum3, sum3), n)),
                                (float)(npx - 1));
    const float clamped = var < 1e-30f ? 1e-30f : var;
    a.ag_snr_out[b] = __fdiv_rn(mean, __fsqrt_rn(clamped));
  }
}

}  // namespace

// The tiling the wrapper sizes its scratch by: columns of a stats tile, its
// rows at most, pixels of an apply block.
extern "C" void tsdr_post_process_tiles(int* out) {
  out[0] = kColTile;
  out[1] = kMaxRows;
  out[2] = kApplyTile;
}

// Launches the three kernels on `stream` for a stack of a->batch frames;
// returns the cudaError_t of the first launch that failed (0 = ok).
extern "C" int tsdr_post_process(const Args* args, void* stream) {
  const Args a = *args;
  if (a.batch <= 0 || a.batch > 65535 || a.h < 1 || a.w < 1 || a.rows_per_tile < 1 ||
      a.rows_per_tile > kMaxRows || (long long)a.n_rtiles * a.rows_per_tile < a.h ||
      (long long)a.n_ctiles * kColTile < a.w ||
      (long long)a.apply_blocks * kApplyTile < (long long)a.h * a.w || a.mode < 0 || a.mode > 2 ||
      a.mb_stride < 0 || a.mb_stride > 1)
    return 1;  // cudaErrorInvalidValue
  cudaStream_t s = (cudaStream_t)stream;
  post_process_stats_kernel<<<dim3((unsigned)(a.n_rtiles * a.n_ctiles), (unsigned)a.batch),
                              kStatsThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  post_process_search_kernel<<<dim3((unsigned)a.batch, 2), kSearchThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  post_process_apply_kernel<<<dim3((unsigned)a.apply_blocks, (unsigned)a.batch), kApplyThreads, 0,
                              s>>>(a);
  return (int)cudaGetLastError();
}
