// K1: the m == 2 strided box resampler, for Hopper (sm_90a).
//
// Replaces the TPU kernel tempestsdr_tpu/pallas/strided_kernel.py `_kernel`
// (launched by box_resample_strided_pallas). Computes, for every pixel
// p = c*2T + 2s + b of one block (chunk c of T samples, sample s, parity b):
//
//   W[j]   = x_ext[start_c - margin + taps + j]          (0 outside x_ext)
//   rel    = margin + frac_c + s*(2*inv - 1)  (+ inv for b == 1), in f32
//   out[p] = rate * sum_t overlap([rel, rel+inv), [t, t+1)) * W[s + t]
//
// masked to 0 at p >= n_out, with the chunk base start_c + frac_c taken
// from the exact int64 fixed-point phase (FRAC_BITS = 40) inside the kernel.
// The kernel also computes the block's carries, n_out = max(floor((n<<40 -
// phase)/inv), 0) and new_phase = phase + n_out*inv - (n<<40), exactly as
// ops/resample.py resample_counts does, so a block costs one launch.
//
// Bound on this card: memory. Each block reads its envelope once and writes
// its pixels once: (n + taps)*4 B in, max_pix*4 B out — about 9.6 MB per
// block at the 64 MS/s geometry, ~3 us at 3.35 TB/s. The arithmetic (two
// overlap weights per pixel) is far below the f32 rate. At that size a
// launch is not a stream at the memory rate: measured on an NVIDIA H100 80GB
// HBM3 at 700.00 W (PERF.md), an empty launch between two events is 5 us of
// the kernel's ~10 us, a plain float4 copy of the same bytes takes what the
// kernel takes, and what is left to a design is the chain a thread block
// goes through (scalars, window, barrier, compute, store) and how many
// blocks go through it at once.
//
// Design against that: one thread block per chunk of T = 1024 samples, 128
// threads, small enough (8 to an SM) that the 784 and 449 blocks of the 64
// and 8 MS/s geometries are all resident in one wave, which measured faster
// than fewer blocks walking several chunks each behind a ring of window
// buffers. A block stages its chunk's window into shared memory once
// (staged_window.cuh): 16-byte asynchronous copies from the 16-byte boundary
// below the window, whatever the alignment of x_ext; checked 4-byte loads
// where the window leaves x_ext (the first and last chunk of a block of
// samples); nothing for a chunk with no complete pixel, which stores zeros.
// Each thread takes two adjacent samples at a time, four adjacent pixels,
// one 16-byte store. No thread waits on a 64-bit division: pixels are masked
// by a per-chunk count that needs the quotient only in the one chunk that
// n_out falls into, and one thread of block 0 computes the carries while
// the copies are in flight.
//
// The chunk of T = 1024 samples stays the unit of the f32 ramp (rel above
// restarts from the exact base at every chunk). A pixel's window
// [rel, rel + inv) is shorter than one sample, so of the taps_eff taps only
// t = floor(rel) and floor(rel) + 1 can overlap it; the kernel evaluates the
// TPU kernel's overlap formula at those two and skips the rest, whose
// weights are exactly 0 — the sum is bit-identical to the full tap loop.
// taps_eff (the wrapper's margin) sizes the window for the whole PLL
// headroom, so no block needs the TPU kernel's fallback to the plain form.
//
// The range entry (tsdr_strided_resample_range) runs the same kernel over
// one time shard's pixels of a block (parallel/timeshard.py), the problem
// the JAX package's box_resample_range_strided states: x is the shard's
// [taps halo | S samples | taps halo], the phase is the shard's shifted
// window-start phase, and the pixel mask comes from a device count of valid
// pixels instead of from the carries' numerator; it writes no carries (the
// step computes them once for the block). One flag of the template
// separates the two; the block entry's code is what it was.
//
// Also here: tsdr_noop and tsdr_copy_floor, the two floors a launch of this
// size is read against (an empty launch; a float4 copy of the same bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_window.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // samples per chunk: the unit of the f32 ramp
constexpr int kFracBits = 40;

__device__ __forceinline__ float overlap(float rel, float end, int t) {
  const float tf = (float)t;
  return fmaxf(__fsub_rn(fminf(end, tf + 1.0f), fmaxf(rel, tf)), 0.0f);
}

// acc = sum_t overlap(t) * win[s + t] over the two taps that can be nonzero
__device__ __forceinline__ float box(const float* win, int s, float rel, float end,
                                     int taps_eff) {
  const int i0 = min(max((int)rel, 0), taps_eff - 2);
  float acc = __fmul_rn(overlap(rel, end, i0), win[s + i0]);
  return __fadd_rn(acc, __fmul_rn(overlap(rel, end, i0 + 1), win[s + i0 + 1]));
}

// kRange == false: one block, n_valid_p unused, the carries written.
// kRange == true: one shard's range, n_samples and the carries unused.
template <bool kRange>
__global__ void __launch_bounds__(kThreads, 8)
strided_resample_kernel(const float* __restrict__ x, long long x_len,
                        const long long* __restrict__ phase_p,
                        const long long* __restrict__ inv_p,
                        long long n_samples, const long long* __restrict__ n_valid_p,
                        float* __restrict__ out,
                        int* __restrict__ n_out_p, long long* __restrict__ new_phase_p,
                        long long max_pix, int taps, int margin, int taps_eff) {
  extern __shared__ __align__(16) float slot[];  // the chunk's window
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long size_fix = n_samples << kFracBits;
  const long long num = size_fix - phase;
  const int tid = threadIdx.x;

  // exact chunk base: arithmetic >> is floor for negative phases
  const long long p0 = (long long)blockIdx.x * (2LL * kTile);
  int lim;
  if constexpr (kRange) {
    lim = (int)min(max(*n_valid_p - p0, 0LL), 2LL * kTile);
  } else {
    lim = tsdr::valid_pixels(p0, 2 * kTile, num, inv);
  }
  const long long base = phase + p0 * inv;
  const long long start = base >> kFracBits;
  const long long w0 = start - margin + taps;  // the window's first sample in x
  if (lim > 0) tsdr::stage_window(slot, x, x_len, w0, kTile + taps_eff, tid, kThreads);

  if (!kRange && blockIdx.x == 0 && tid == 0) {
    // exact carries; a negative numerator (a drop skip draining past this
    // block) gives n_out = 0 under floor division, as it does here
    const long long n_out = num > 0 ? num / inv : 0;
    *n_out_p = (int)n_out;
    *new_phase_p = phase + n_out * inv - size_fix;
  }

  const float inv_f = __fmul_rn(__ll2float_rn(inv), 1.0f / (float)(1LL << kFracBits));
  const float rate = __fdiv_rn((float)(1LL << kFracBits), __ll2float_rn(inv));
  const float delta2 = (float)(2.0 * (double)inv * (1.0 / (double)(1LL << kFracBits)) - 1.0);
  const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)),
                               1.0f / (float)(1LL << kFracBits));
  const float rel0 = __fadd_rn((float)margin, frac);
  const float* win = slot + tsdr::window_offset(x, w0);

  tsdr::cp_async_wait_all();
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kTile / (2 * kThreads); ++it) {
    const int s0 = 2 * (tid + it * kThreads);
    float v[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u;
      v[2 * u] = v[2 * u + 1] = 0.0f;
      if (2 * s < lim) {  // lim == 0: the window was not staged and is not read
        // same formula and order as the TPU kernel: (margin + frac) + s*delta2
        const float rel_e = __fadd_rn(rel0, __fmul_rn((float)s, delta2));
        const float rel_o = __fadd_rn(rel_e, inv_f);
        v[2 * u] = __fmul_rn(box(win, s, rel_e, rel_o, taps_eff), rate);
        if (2 * s + 1 < lim)
          v[2 * u + 1] = __fmul_rn(box(win, s, rel_o, __fadd_rn(rel_o, inv_f), taps_eff), rate);
      }
    }
    tsdr::store4(out, p0 + 2LL * s0, max_pix, v);
  }
}

__global__ void noop_kernel() {}

// each input float4 read once, each output float4 written once; the output
// is about twice the input, as K1's pixels are to its samples
__global__ void __launch_bounds__(kThreads)
copy_floor_kernel(const float4* __restrict__ in, long long n_in4, float4* __restrict__ out,
                  long long n_out4) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long n = max(n_in4, (n_out4 + 1) / 2);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float4 v = i < n_in4 ? in[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (2 * i < n_out4) out[2 * i] = v;
    if (2 * i + 1 < n_out4) out[2 * i + 1] = v;
  }
}

// SMs of the current device (0 if the query fails), asked once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

}  // namespace

extern "C" int tsdr_strided_resample_tile() { return kTile; }

// Launches K1 on `stream`, one thread block per chunk; returns the
// cudaError_t of the launch (0 = ok). `out` must be 16-byte aligned (a fresh
// torch allocation is).
extern "C" int tsdr_strided_resample(const float* x, long long x_len,
                                     const long long* phase, const long long* inv,
                                     long long n_samples, float* out, int* n_out,
                                     long long* new_phase, long long max_pix,
                                     int taps, int margin, int taps_eff,
                                     void* stream) {
  if (max_pix <= 0 || ((uintptr_t)out & 15) != 0)
    return 1;  // cudaErrorInvalidValue: nothing would write the carries
  const long long chunks = (max_pix + 2LL * kTile - 1) / (2LL * kTile);
  const size_t smem = (size_t)tsdr::slot_floats(kTile + taps_eff) * sizeof(float);
  strided_resample_kernel<false><<<(unsigned)chunks, kThreads, smem, (cudaStream_t)stream>>>(
      x, x_len, phase, inv, n_samples, nullptr, out, n_out, new_phase, max_pix, taps, margin,
      taps_eff);
  return (int)cudaGetLastError();
}

// Launches K1 over one time shard's pixels: pixel i of `out` (i < max_pix)
// is the box integral over [eff_phase + i*inv, + inv) of x's segment samples
// (x[taps + s] is segment sample s; samples outside x read as 0), zero at
// i >= *n_valid. eff_phase, inv and n_valid are int64 device scalars; no
// carries. Returns the cudaError_t of the launch.
extern "C" int tsdr_strided_resample_range(const float* x, long long x_len,
                                           const long long* eff_phase, const long long* inv,
                                           const long long* n_valid, float* out,
                                           long long max_pix, int taps, int margin,
                                           int taps_eff, void* stream) {
  if (max_pix <= 0 || ((uintptr_t)out & 15) != 0) return 1;  // cudaErrorInvalidValue
  const long long chunks = (max_pix + 2LL * kTile - 1) / (2LL * kTile);
  const size_t smem = (size_t)tsdr::slot_floats(kTile + taps_eff) * sizeof(float);
  strided_resample_kernel<true><<<(unsigned)chunks, kThreads, smem, (cudaStream_t)stream>>>(
      x, x_len, eff_phase, inv, 0, n_valid, out, nullptr, nullptr, max_pix, taps, margin,
      taps_eff);
  return (int)cudaGetLastError();
}

// An empty kernel: what a launch costs between two events.
extern "C" int tsdr_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// A grid-stride float4 copy that reads n_in floats and writes n_out floats
// (whole 16-byte pieces; both pointers 16-byte aligned), 8 thread blocks per
// SM: what a stream of K1's bytes reaches on this card with no arithmetic
// and no staging.
extern "C" int tsdr_copy_floor(const float* in, long long n_in, float* out, long long n_out,
                               void* stream) {
  const int sms = sm_count();
  if (sms <= 0 || (((uintptr_t)in | (uintptr_t)out) & 15) != 0) return 1;
  copy_floor_kernel<<<sms * 8, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(in), n_in / 4, reinterpret_cast<float4*>(out), n_out / 4);
  return (int)cudaGetLastError();
}
