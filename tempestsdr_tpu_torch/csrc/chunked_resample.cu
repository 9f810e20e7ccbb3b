// K3 and K4: the chunked box resampler for any rate, for Hopper (sm_90a).
//
// K3 replaces the TPU kernel tempestsdr_tpu/pallas/resample_kernel.py
// `_kernel` (box_resample_pallas); K4 replaces `_kernel_w` in the same file
// (box_resample_pallas_windows). Both compute, for every pixel
// p = t*256 + r of one block (tile t of 256 pixels, pixel r in the tile):
//
//   pos    = frac_t + r*inv                                   (f32)
//   out[p] = rate * sum_j overlap([pos, pos + inv), [j, j+1)) * win_t[j]
//
// masked to 0 at p >= n_out, where win_t is the tile's window of w_in
// envelope samples starting at sample start_t + taps of x_ext, and
// start_t + frac_t the tile's first window start from the exact int64
// fixed-point phase (FRAC_BITS = 40). The block's carries, n_out and the
// new phase, come out of the same launch, computed as
// ops/resample.py resample_counts does (block 0 writes them).
//
// K3 takes x_ext and builds each tile's base and window itself from device
// scalars: no host round trip, and no padded copy of x_ext (samples past
// its end read as 0, as the TPU wrapper's zero padding gave). Its fracs
// are f32, formed in the kernel from the exact int64 residual; the TPU
// kernel's 24-bit fixed-point fracs were a scalar-memory constraint of the
// TPU and are gone. K4 takes the windows already gathered (windows
// f32[n_tiles, w_in], fracs f32[n_tiles], as the XLA gather fed the TPU
// kernel) and does the weights and the reduction; gather_windows_kernel,
// also here, is that gather as one launch.
//
// Bound on this card: memory. K3 reads x_ext once and writes the pixels
// once (about 9.6 MB per 64 MS/s block, ~2.9 us at 3.35 TB/s); K4 reads the
// windows (3.4 MB) and writes the pixels (6.4 MB); the gather reads x_ext
// (3.1 MB) and writes the windows. The TPU kernel evaluated
// all w_in (136) window samples for every pixel: ~1.3 GFLOP per 64 MS/s
// block, compute-bound here (~20 us at the f32 rate). A pixel's window
// [pos, pos + inv) touches only the samples floor(pos) .. floor(pos + inv),
// ceil(inv) + 1 at most, so each thread sums those in ascending order and
// skips the rest, whose weights are exactly 0: the result equals a
// sequential loop over the whole window. The TPU's tree reduction adds the
// same terms in another association, which matters only when a window
// spans three or more samples (inv > 1); tolerance against the plain
// chunked form is 3e-4 either way.
//
// At a block's size a launch is not a stream at the memory rate: measured
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md), an empty launch between
// two events is 5 us, a plain float4 copy of the same bytes 9 us at the
// 64 MS/s geometry, and what a design decides is how many
// thread blocks are started and what each goes through before its first
// load and between its loads and its stores.
//
// Design of K3: one thread block per group of `tiles` consecutive 256-pixel
// tiles (8 where shared memory allows: the wrapper picks `tiles` so that a
// group's window fits at any rate), 256 threads: 784 and 449 blocks at the
// 64 and 8 MS/s geometries, all resident in one wave, where one tile per
// block made 6,267 blocks in six waves; it measured faster than fewer blocks
// walking several groups each behind a ring of window buffers. A group's
// window is one contiguous stretch of x_ext (w_grp samples from the first
// tile's start), staged into shared memory once (staged_window.cuh): 16-byte
// asynchronous copies from the 16-byte boundary below it, whatever the
// alignment of x_ext; checked 4-byte loads where it leaves x_ext; nothing
// for a group with no complete pixel, which stores zeros. Each thread takes
// four consecutive pixels of one tile at a time, one 16-byte store. No
// thread waits on a 64-bit division: pixels are masked by a per-group count
// that needs the quotient only in the one group n_out falls into, and one
// thread of block 0 computes the carries while the copies are in flight.
//
// The 256-pixel tile stays the unit of the f32 ramp: each tile's start and
// frac come from the exact int64 base and pos restarts at every tile, so
// every pixel is what a one-tile-per-block kernel gives, bit for bit.
//
// Design of K4: K3's, on rows instead of a stretch of x_ext. One thread
// block per group of `tiles` consecutive tiles (8, which is also the TPU
// kernel's own grouping; fewer where shared memory asks), so 784 and 449
// blocks in one wave where one tile per block made 6,267. The wrapper pads
// w_in to a multiple of 4 samples, so every row starts on a 16-byte
// boundary and a group's rows are one contiguous stretch of `windows`,
// staged once with the same 16-byte asynchronous copies (checked loads for
// the last, partial group). Four consecutive pixels of one tile per thread
// and step, one 16-byte store; pixels masked by the per-group count, and a
// group of complete pixels (nearly all) takes the same loop compiled with
// no masks; one thread of block 0 writes the carries while the copies are
// in flight; no barrier waits on the division. The padding columns hold the
// envelope's next samples or 0 and no complete pixel reaches them (its
// window ends inside the unpadded w_in at any rate within the wrapper's 2 %
// slack).
//
// Design of the gather: one thread per 16-byte piece of `windows`, flat over
// all rows (row = piece / (w_in / 4)): each thread forms its row's exact
// int64 base, start and clipped first sample idx0 = clamp(start + taps, 0,
// x_len), reads four consecutive samples of x_ext (0 past its end, as the
// plain form's zero padding gives; neighbouring threads read neighbouring
// 16 bytes) and stores them as one float4; the thread of a row's first piece
// also writes the row's frac with the clip folded in. No padded copy of
// x_ext and no index matrix.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_window.cuh"

namespace {

constexpr int kTileP = 256;  // pixels per tile: the unit of the f32 ramp
constexpr int kThreads = 256;  // K3's
constexpr int kWinThreads = 256;  // K4's
constexpr int kMaxGroup = 8;  // tiles per group at most (K4's staged fracs)
constexpr int kGatherThreads = 128;
constexpr int kFracBits = 40;
constexpr float kInvScale = 1.0f / (float)(1LL << kFracBits);

// exact carries (ops/resample.py resample_counts); a negative numerator (a
// drop skip draining past this block) gives n_out = 0
__device__ __forceinline__ long long block_carries(long long phase, long long inv,
                                                   long long n_samples, int* n_out_p,
                                                   long long* new_phase_p) {
  const long long size_fix = n_samples << kFracBits;
  const long long num = size_fix - phase;
  const long long n_out = num > 0 ? num / inv : 0;
  if (blockIdx.x == 0) {
    *n_out_p = (int)n_out;
    *new_phase_p = phase + n_out * inv - size_fix;
  }
  return n_out;
}

// sum_j overlap([pos, end), [j, j+1)) * win[j] over the samples with a
// nonzero overlap, j = floor(pos) .. floor(end), inside [0, w_in)
__device__ __forceinline__ float box_sum(const float* win, int w_in, float pos, float inv) {
  const float end = __fadd_rn(pos, inv);
  const int j0 = max((int)floorf(pos), 0);
  const int j1 = min((int)floorf(end), w_in - 1);
  float acc = 0.0f;
  for (int j = j0; j <= j1; ++j) {
    const float jf = (float)j;
    const float w = fmaxf(__fsub_rn(fminf(end, __fadd_rn(jf, 1.0f)), fmaxf(pos, jf)), 0.0f);
    acc = __fadd_rn(acc, __fmul_rn(w, win[j]));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 8)
chunked_resample_kernel(const float* __restrict__ x, long long x_len,
                        const long long* __restrict__ phase_p,
                        const long long* __restrict__ inv_p, long long n_samples,
                        float* __restrict__ out, int* __restrict__ n_out_p,
                        long long* __restrict__ new_phase_p, long long max_pix, int taps,
                        int w_in, int tiles, int w_grp) {
  extern __shared__ __align__(16) float slot[];  // the group's window
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long num = (n_samples << kFracBits) - phase;
  const int tid = threadIdx.x;
  const int group_pix = tiles * kTileP;

  // exact group base: arithmetic >> is floor for negative phases
  const long long p0 = (long long)blockIdx.x * group_pix;
  const int lim = tsdr::valid_pixels(p0, group_pix, num, inv);
  const long long start0 = (phase + p0 * inv) >> kFracBits;
  if (lim > 0) tsdr::stage_window(slot, x, x_len, start0 + taps, w_grp, tid, kThreads);

  if (blockIdx.x == 0 && tid == 0) block_carries(phase, inv, n_samples, n_out_p, new_phase_p);

  const float inv_f = __fmul_rn(__ll2float_rn(inv), kInvScale);
  const float rate = __fdiv_rn(1.0f, inv_f);
  const float* grp = slot + tsdr::window_offset(x, start0 + taps);

  tsdr::cp_async_wait_all();
  __syncthreads();

  for (int q0 = 4 * tid; q0 < group_pix; q0 += 4 * kThreads) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (q0 < lim) {  // lim == 0: the window was not staged and is not read
      // the tile's own exact base; its window starts d samples into the group's
      const long long base = phase + (p0 + (q0 & ~(kTileP - 1))) * inv;
      const long long start = base >> kFracBits;
      const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)), kInvScale);
      const int d = (int)(start - start0);
      const int w = min(w_in, w_grp - d);
      const int r0 = q0 & (kTileP - 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u < lim) {
          const float pos = __fadd_rn(frac, __fmul_rn((float)(r0 + u), inv_f));
          v[u] = __fmul_rn(box_sum(grp + d, w, pos, inv_f), rate);
        }
      }
    }
    tsdr::store4(out, p0 + q0, max_pix, v);
  }
}

// K4's pixels of one group from its staged rows `grp` and fracs: four
// consecutive pixels of one tile per thread and step, one 16-byte store.
// kMasked: only pixels below `lim` (and max_pix) are computed, the others
// store 0; a group with lim == 0 was not staged and is not read.
template <bool kMasked>
__device__ __forceinline__ void group_pixels(const float* grp, const float* s_frac, int w_in,
                                             float inv_f, float rate, int group_pix, int lim,
                                             float* __restrict__ out, long long p0,
                                             long long max_pix) {
  for (int q0 = 4 * threadIdx.x; q0 < group_pix; q0 += 4 * kWinThreads) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!kMasked || (q0 < lim && p0 + q0 < max_pix)) {
      const int tl = q0 / kTileP;
      const float frac = s_frac[tl];
      const float* win = grp + tl * w_in;
      const int r0 = q0 & (kTileP - 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!kMasked || q0 + u < lim) {
          const float pos = __fadd_rn(frac, __fmul_rn((float)(r0 + u), inv_f));
          v[u] = __fmul_rn(box_sum(win, w_in, pos, inv_f), rate);
        }
      }
    }
    if (kMasked)
      tsdr::store4(out, p0 + q0, max_pix, v);
    else
      *reinterpret_cast<float4*>(out + p0 + q0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kWinThreads, 8)
windows_resample_kernel(const float* __restrict__ windows, const float* __restrict__ fracs,
                        const long long* __restrict__ phase_p,
                        const long long* __restrict__ inv_p, long long n_samples,
                        float* __restrict__ out, int* __restrict__ n_out_p,
                        long long* __restrict__ new_phase_p, long long max_pix,
                        long long n_tiles, int w_in, int tiles) {
  extern __shared__ __align__(16) float slot[];  // the group's rows
  __shared__ float s_frac[kMaxGroup];
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long num = (n_samples << kFracBits) - phase;
  const int tid = threadIdx.x;
  const int group_pix = tiles * kTileP;

  const long long p0 = (long long)blockIdx.x * group_pix;
  const int lim = tsdr::valid_pixels(p0, group_pix, num, inv);
  const long long t0 = (long long)blockIdx.x * tiles;
  const long long row0 = t0 * w_in;  // the group's rows: one stretch of `windows`
  if (lim > 0) {
    tsdr::stage_window(slot, windows, n_tiles * w_in, row0, tiles * w_in, tid, kWinThreads);
    if (tid < tiles && t0 + tid < n_tiles) s_frac[tid] = fracs[t0 + tid];
  }

  if (blockIdx.x == 0 && tid == 0) block_carries(phase, inv, n_samples, n_out_p, new_phase_p);

  const float inv_f = __fmul_rn(__ll2float_rn(inv), kInvScale);
  const float rate = __fdiv_rn(1.0f, inv_f);
  const float* grp = slot + tsdr::window_offset(windows, row0);

  tsdr::cp_async_wait_all();
  __syncthreads();

  // a whole group of complete pixels (all but the group n_out falls into
  // and those past it) takes the loop with no masks
  if (lim == group_pix && p0 + group_pix <= max_pix)
    group_pixels<false>(grp, s_frac, w_in, inv_f, rate, group_pix, lim, out, p0, max_pix);
  else
    group_pixels<true>(grp, s_frac, w_in, inv_f, rate, group_pix, lim, out, p0, max_pix);
}

__global__ void __launch_bounds__(kGatherThreads)
gather_windows_kernel(const float* __restrict__ x, long long x_len,
                      const long long* __restrict__ phase_p,
                      const long long* __restrict__ inv_p, float* __restrict__ windows,
                      float* __restrict__ fracs, long long pieces, int taps, int w_in) {
  const long long i = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  if (i >= pieces) return;
  const int w4 = w_in >> 2;  // w_in is a multiple of 4
  const long long t = i / w4;
  const int c = (int)(i - t * w4);

  // the tile's exact base, and its window start clipped into x_ext as if
  // zero-padded by w_in samples, with the clip folded into the frac
  const long long base = *phase_p + (t * kTileP) * *inv_p;
  const long long start = base >> kFracBits;
  const long long idx0 = min(max(start + taps, 0LL), x_len);
  if (c == 0) {
    const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)), kInvScale);
    fracs[t] = __fadd_rn(frac, __ll2float_rn(start + taps - idx0));
  }
  const long long j = idx0 + 4 * c;
  float4 v;
  v.x = j < x_len ? x[j] : 0.0f;
  v.y = j + 1 < x_len ? x[j + 1] : 0.0f;
  v.z = j + 2 < x_len ? x[j + 2] : 0.0f;
  v.w = j + 3 < x_len ? x[j + 3] : 0.0f;
  reinterpret_cast<float4*>(windows)[i] = v;
}

}  // namespace

extern "C" int tsdr_chunked_tile() { return kTileP; }

// Launches K3 on `stream`, one thread block per group of `tiles` tiles, each
// group with a window of w_grp samples (w_in: one tile's); returns the
// cudaError_t of the launch (0 = ok). `out` must be 16-byte aligned (a fresh
// torch allocation is).
extern "C" int tsdr_chunked_resample(const float* x, long long x_len, const long long* phase,
                                     const long long* inv, long long n_samples, float* out,
                                     int* n_out, long long* new_phase, long long max_pix,
                                     int taps, int w_in, int tiles, int w_grp, void* stream) {
  if (max_pix <= 0 || w_in <= 0 || tiles <= 0 || w_grp < w_in || ((uintptr_t)out & 15) != 0)
    return 1;  // cudaErrorInvalidValue
  const long long group_pix = (long long)tiles * kTileP;
  const long long groups = (max_pix + group_pix - 1) / group_pix;
  const size_t smem = (size_t)tsdr::slot_floats(w_grp) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chunked_resample_kernel<<<(unsigned)groups, kThreads, smem, (cudaStream_t)stream>>>(
      x, x_len, phase, inv, n_samples, out, n_out, new_phase, max_pix, taps, w_in, tiles, w_grp);
  return (int)cudaGetLastError();
}

// Launches K4 on `stream` over n_tiles = ceil(max_pix / 256) window rows of
// w_in samples, one thread block per group of `tiles` rows. `out` must be
// 16-byte aligned (a fresh torch allocation is).
extern "C" int tsdr_windows_resample(const float* windows, const float* fracs,
                                     const long long* phase, const long long* inv,
                                     long long n_samples, float* out, int* n_out,
                                     long long* new_phase, long long max_pix, int w_in,
                                     int tiles, void* stream) {
  if (max_pix <= 0 || w_in <= 0 || tiles <= 0 || tiles > kMaxGroup || ((uintptr_t)out & 15) != 0)
    return 1;
  const long long n_tiles = (max_pix + kTileP - 1) / kTileP;
  const long long groups = (n_tiles + tiles - 1) / tiles;
  const size_t smem = (size_t)tsdr::slot_floats(tiles * w_in) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        windows_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  windows_resample_kernel<<<(unsigned)groups, kWinThreads, smem, (cudaStream_t)stream>>>(
      windows, fracs, phase, inv, n_samples, out, n_out, new_phase, max_pix, n_tiles, w_in, tiles);
  return (int)cudaGetLastError();
}

// Launches the gather of K4's inputs on `stream`: windows f32[n_tiles, w_in]
// and fracs f32[n_tiles] from x_ext. w_in must be a multiple of 4 and
// `windows` 16-byte aligned.
extern "C" int tsdr_gather_windows(const float* x, long long x_len, const long long* phase,
                                   const long long* inv, float* windows, float* fracs,
                                   long long n_tiles, int taps, int w_in, void* stream) {
  if (n_tiles <= 0 || w_in <= 0 || (w_in & 3) != 0 || ((uintptr_t)windows & 15) != 0) return 1;
  const long long pieces = n_tiles * (w_in >> 2);
  const long long blocks = (pieces + kGatherThreads - 1) / kGatherThreads;
  gather_windows_kernel<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      x, x_len, phase, inv, windows, fracs, pieces, taps, w_in);
  return (int)cudaGetLastError();
}
