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
// overlap weights per pixel) is far below the f32 rate.
//
// Design against that bound: one thread block per chunk of T = 1024
// samples stages its window (T + taps_eff floats) in shared memory with
// coalesced loads, so each envelope value comes from device memory about
// once. Each of the 256 threads then takes 4 samples, strided by 256 so
// that neighbouring threads write neighbouring pixel pairs (one 8-byte
// store per sample, directly in pixel order: the TPU's lane roll,
// row-carry select and 0/1 interleave matmul have no counterpart here).
// A pixel's window [rel, rel + inv) is shorter than one sample, so of the
// taps_eff taps only t = floor(rel) and floor(rel) + 1 can overlap it; the
// kernel evaluates the TPU kernel's overlap formula at those two and skips
// the rest, whose weights are exactly 0 — the sum is bit-identical to the
// full tap loop. taps_eff (the wrapper's margin) sizes the window for the
// whole PLL headroom, so no block needs the TPU kernel's fallback to the
// plain form; the phase and the rate are read from device scalars and the
// carries written back, so a launch never waits on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // samples per thread block
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

__global__ void __launch_bounds__(kThreads)
strided_resample_kernel(const float* __restrict__ x, long long x_len,
                        const long long* __restrict__ phase_p,
                        const long long* __restrict__ inv_p,
                        long long n_samples, float* __restrict__ out,
                        int* __restrict__ n_out_p, long long* __restrict__ new_phase_p,
                        long long max_pix, int taps, int margin, int taps_eff) {
  extern __shared__ float win[];  // kTile + taps_eff samples
  __shared__ long long s_n_out;
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long c = blockIdx.x;
  if (threadIdx.x == 0) {
    // exact carries; a negative numerator (a drop skip draining past this
    // block) gives n_out = 0 under floor division, as it does here
    const long long size_fix = n_samples << kFracBits;
    const long long num = size_fix - phase;
    const long long n_out = num > 0 ? num / inv : 0;
    s_n_out = n_out;
    if (c == 0) {
      *n_out_p = (int)n_out;
      *new_phase_p = phase + n_out * inv - size_fix;
    }
  }

  // exact chunk base: arithmetic >> is floor for negative phases
  const long long base = phase + c * (2LL * kTile) * inv;
  const long long start = base >> kFracBits;
  const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)),
                               1.0f / (float)(1LL << kFracBits));

  const long long w0 = start - margin + taps;
  for (int j = threadIdx.x; j < kTile + taps_eff; j += kThreads) {
    const long long i = w0 + j;
    win[j] = (i >= 0 && i < x_len) ? x[i] : 0.0f;
  }
  __syncthreads();
  const long long n_out = s_n_out;

  const float inv_f = __fmul_rn(__ll2float_rn(inv), 1.0f / (float)(1LL << kFracBits));
  const float rate = __fdiv_rn((float)(1LL << kFracBits), __ll2float_rn(inv));
  const float delta2 = (float)(2.0 * (double)inv * (1.0 / (double)(1LL << kFracBits)) - 1.0);
  const float rel0 = __fadd_rn((float)margin, frac);

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x + k * kThreads;
    // same formula and order as the TPU kernel: (margin + frac) + s*delta2
    const float rel_e = __fadd_rn(rel0, __fmul_rn((float)s, delta2));
    const float rel_o = __fadd_rn(rel_e, inv_f);
    const float acc_e = box(win, s, rel_e, rel_o, taps_eff);
    const float acc_o = box(win, s, rel_o, __fadd_rn(rel_o, inv_f), taps_eff);
    const long long p = c * (2LL * kTile) + 2LL * s;
    const float ve = p < n_out ? __fmul_rn(acc_e, rate) : 0.0f;
    const float vo = p + 1 < n_out ? __fmul_rn(acc_o, rate) : 0.0f;
    if (p + 1 < max_pix) {
      *reinterpret_cast<float2*>(out + p) = make_float2(ve, vo);
    } else if (p < max_pix) {
      out[p] = ve;
    }
  }
}

}  // namespace

extern "C" int tsdr_strided_resample_tile() { return kTile; }

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int tsdr_strided_resample(const float* x, long long x_len,
                                     const long long* phase, const long long* inv,
                                     long long n_samples, float* out, int* n_out,
                                     long long* new_phase, long long max_pix,
                                     int taps, int margin, int taps_eff,
                                     void* stream) {
  if (max_pix <= 0) return 1;  // cudaErrorInvalidValue: nothing would write the carries
  const long long blocks = (max_pix + 2LL * kTile - 1) / (2LL * kTile);
  const size_t smem = (size_t)(kTile + taps_eff) * sizeof(float);
  strided_resample_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, x_len, phase, inv, n_samples, out, n_out, new_phase, max_pix, taps, margin,
      taps_eff);
  return (int)cudaGetLastError();
}
