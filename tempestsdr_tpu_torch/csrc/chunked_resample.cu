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
// TPU and are gone. K4 takes the windows already gathered by plain torch
// indexing (windows f32[n_tiles, w_in], fracs f32[n_tiles], as the XLA
// gather fed the TPU kernel) and does the weights and the reduction.
//
// Bound on this card: memory. K3 reads x_ext once and writes the pixels
// once (about 9.6 MB per 64 MS/s block, ~2.9 us at 3.35 TB/s); K4 reads the
// windows (3.4 MB) and writes the pixels (6.4 MB). The TPU kernel evaluated
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
// Design of K4: one thread block per 256-pixel tile, one thread per pixel;
// it reads its window row straight from device memory (each row is
// contiguous and read by all 256 threads of its block, so it comes from
// device memory about once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_window.cuh"

namespace {

constexpr int kTileP = 256;  // pixels per tile: the unit of the f32 ramp (and K4's thread block)
constexpr int kThreads = 256;  // K3's
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

__device__ __forceinline__ void store_pixel(float* out, long long max_pix, long long n_out,
                                            float acc, float rate) {
  const long long p = (long long)blockIdx.x * kTileP + threadIdx.x;
  if (p < max_pix) out[p] = p < n_out ? __fmul_rn(acc, rate) : 0.0f;
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

__global__ void __launch_bounds__(kTileP)
windows_resample_kernel(const float* __restrict__ windows, const float* __restrict__ fracs,
                        const long long* __restrict__ phase_p,
                        const long long* __restrict__ inv_p, long long n_samples,
                        float* __restrict__ out, int* __restrict__ n_out_p,
                        long long* __restrict__ new_phase_p, long long max_pix, int w_in) {
  __shared__ long long s_n_out;
  const long long inv = *inv_p;
  if (threadIdx.x == 0) s_n_out = block_carries(*phase_p, inv, n_samples, n_out_p, new_phase_p);
  __syncthreads();

  const float* win = windows + (long long)blockIdx.x * w_in;
  const float inv_f = __fmul_rn(__ll2float_rn(inv), kInvScale);
  const float rate = __fdiv_rn(1.0f, inv_f);
  const float pos = __fadd_rn(fracs[blockIdx.x], __fmul_rn((float)threadIdx.x, inv_f));
  store_pixel(out, max_pix, s_n_out, box_sum(win, w_in, pos, inv_f), rate);
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

// Launches K4 on `stream` over n_tiles = ceil(max_pix / 256) window rows.
extern "C" int tsdr_windows_resample(const float* windows, const float* fracs,
                                     const long long* phase, const long long* inv,
                                     long long n_samples, float* out, int* n_out,
                                     long long* new_phase, long long max_pix, int w_in,
                                     void* stream) {
  if (max_pix <= 0 || w_in <= 0) return 1;
  const long long blocks = (max_pix + kTileP - 1) / kTileP;
  windows_resample_kernel<<<(unsigned)blocks, kTileP, 0, (cudaStream_t)stream>>>(
      windows, fracs, phase, inv, n_samples, out, n_out, new_phase, max_pix, w_in);
  return (int)cudaGetLastError();
}
