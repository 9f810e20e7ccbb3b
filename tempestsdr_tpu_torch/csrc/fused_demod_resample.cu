// K2 and K2': fused byte decode + AM demod + m == 2 strided box resample,
// for Hopper (sm_90a).
//
// K2 replaces the TPU kernel tempestsdr_tpu/pallas/fused_kernel.py
// `_kernel_u32` (with `_decode` and `_decode_u32`; fused_demod_resample),
// K2' the packed-u16 layout of the same function,
// bench/fused_u16_probe.py `_kernel` (fused_demod_resample_u16). From one
// block's raw interleaved uint8/int8 IQ (raw[2e] = I, raw[2e + 1] = Q of
// sample e), the previous block's envelope tail and the int64 phase, one
// launch writes
//
//   env[e]  = sqrt(a*a + b*b) * (1/128),  a, b = the pair's bytes as
//             integers (u8: v - 128; i8: (v ^ 128) - 128)
//   pixels  = K1's m == 2 strided box resample of x_ext = concat(tail, env)
//   n_out, new_phase = the block's exact carries
//
// a*a + b*b is an exact integer and 1/128 a power of two, so with
// correctly rounded __fmul_rn / __fadd_rn / __fsqrt_rn (no FMA contraction,
// no fast math) env equals the port's am_demod(normalize_iq(raw)) on the
// card bit for bit. The pixels are K1's (strided_resample.cu) to the bit:
// the same tiles of 1024 samples, margin, taps_eff, f32 ramp and two-tap
// overlap sum, on a window decoded from the raw bytes into shared memory
// instead of read from an envelope in device memory. Window samples
// [-taps, 0) come from `tail`, those past the block read as 0, as in K1.
//
// Bound on this card: memory. Raw bytes read once (2n B), env written once
// (4n B), pixels written once (4*max_pix B): about 11.1 MB per 64 MS/s
// block, ~3.3 us at 3.35 TB/s, against ~12.7 MB (+ a launch) for the
// unfused demod kernels + K1. The arithmetic is a few operations per
// sample and pixel, far below the f32 rate.
//
// At a block's size a launch is not a stream at the memory rate: measured
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md), an empty launch between
// two events is 5 us, a float4 copy of the same bytes takes 11 us at the
// 64 MS/s geometry, and the kernel takes what that copy takes.
//
// Design: one thread block of 256 threads per tile of 1024 samples, all
// blocks resident in one wave at the 64 and 8 MS/s geometries. The tile
// decodes its window (1024 + taps_eff + 1 samples, which covers the whole
// PLL headroom, so no fallback branch) from device memory into shared
// memory, and, separately, the 1024 envelope samples it owns, which it
// writes to env four at a time, one 16-byte store: each env sample is
// written exactly once, by its owner, while windows overlap and drift away
// from the owned range along the block (the window starts
// phase + 1024c*(2*inv - 1) - margin samples from tile c's owned range: 6
// samples over a block at the nominal 64 MS/s rate, 680 at the nominal
// 8 MS/s rate, 1,600 at the PLL's ends). The owned samples' stores are
// issued before the barrier the window waits at. Each thread then takes two
// adjacent samples at a time, four adjacent pixels, one 16-byte store. No
// thread waits on a 64-bit division: pixels are masked by a per-tile count
// that needs the quotient only in the one tile n_out falls into, and one
// thread of block 0 computes the carries. A tile with no complete pixel
// decodes no window and stores zero pixels.
//
// Measured against this design and not taken, each slower at one geometry
// or both (PERF.md): 128 threads; the window's raw pairs staged with 16-byte
// asynchronous copies and decoded from shared memory (a second barrier);
// 16-byte loads of eight pairs a thread; copying the owned samples from the
// decoded window instead of decoding them a second time (their stores then
// wait for the barrier).
//
// The two variants differ only in how many IQ pairs one load decodes — the
// card's counterpart of the TPU's u32-vs-u16 window layouts:
//   K2  (kPairs = 2): one 4-byte load, two samples;
//   K2' (kPairs = 1): one 2-byte load, one sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // samples per thread block: the unit of the f32 ramp
constexpr int kFracBits = 40;

__device__ __forceinline__ float mag(unsigned i, unsigned q, unsigned flip) {
  const float a = (float)((int)(i ^ flip) - 128);
  const float b = (float)((int)(q ^ flip) - 128);
  return __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))), 0.0078125f);
}

__device__ __forceinline__ float mag_pair(unsigned v, unsigned flip) {
  return mag(v & 0xFFu, (v >> 8) & 0xFFu, flip);
}

// x_ext sample of envelope index e outside the raw block: the tail or 0
__device__ __forceinline__ float outside(const float* tail, long long e, int taps) {
  return (e < 0 && e >= -taps) ? tail[taps + e] : 0.0f;
}

// decodes the adjacent samples (e, e + 1), e even, from the pairs at p
// (4-byte aligned): one load (K2) or two (K2')
template <int kPairs>
__device__ __forceinline__ void decode2(const uint16_t* p, unsigned flip, float& v0, float& v1) {
  if (kPairs == 2) {
    const unsigned v = *reinterpret_cast<const uint32_t*>(p);
    v0 = mag_pair(v, flip);
    v1 = mag_pair(v >> 16, flip);
  } else {
    v0 = mag_pair(p[0], flip);
    v1 = mag_pair(p[1], flip);
  }
}

// as in strided_resample.cu
__device__ __forceinline__ float overlap(float rel, float end, int t) {
  const float tf = (float)t;
  return fmaxf(__fsub_rn(fminf(end, tf + 1.0f), fmaxf(rel, tf)), 0.0f);
}

__device__ __forceinline__ float box(const float* win, int s, float rel, float end,
                                     int taps_eff) {
  const int i0 = min(max((int)rel, 0), taps_eff - 2);
  float acc = __fmul_rn(overlap(rel, end, i0), win[s + i0]);
  return __fadd_rn(acc, __fmul_rn(overlap(rel, end, i0 + 1), win[s + i0 + 1]));
}

template <int kPairs>
__global__ void __launch_bounds__(kThreads, 4)
fused_kernel(const uint16_t* __restrict__ raw, unsigned flip, const float* __restrict__ tail,
             const long long* __restrict__ phase_p, const long long* __restrict__ inv_p,
             long long n_samples, float* __restrict__ env, float* __restrict__ out,
             int* __restrict__ n_out_p, long long* __restrict__ new_phase_p,
             long long max_pix, int taps, int margin, int taps_eff) {
  extern __shared__ __align__(16) float win_f[];  // kTile + taps_eff + 1 samples
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long n = n_samples;  // even
  const long long c = blockIdx.x;
  const int tid = threadIdx.x;
  const long long size_fix = n << kFracBits;
  const long long num = size_fix - phase;

  // the tile's window, as K1's: x_ext indices from start - margin + taps,
  // i.e. envelope indices from start - margin; decoded from the even
  // envelope index e0 at or below it so that two pairs stay 4-byte aligned
  const long long p0 = c * (2LL * kTile);
  const int lim = tsdr::valid_pixels(p0, 2 * kTile, num, inv);
  const long long base = phase + p0 * inv;
  const long long start = base >> kFracBits;
  const int par = (int)((start - margin) & 1);
  const long long e0 = start - margin - par;
  const int w_len = kTile + taps_eff + 1;

  if (c == 0 && tid == 0) {
    // exact carries; a negative numerator (a drop skip draining past this
    // block) gives n_out = 0
    const long long n_out = num > 0 ? num / inv : 0;
    *n_out_p = (int)n_out;
    *new_phase_p = phase + n_out * inv - size_fix;
  }

  if (lim > 0) {
    for (int m = tid; 2 * m < w_len; m += kThreads) {
      const long long e = e0 + 2 * m;  // even: the pair (e, e + 1) is inside [0, n) or outside
      float v0, v1;
      if (e >= 0 && e < n) {
        decode2<kPairs>(raw + e, flip, v0, v1);
      } else {
        v0 = outside(tail, e, taps);
        v1 = outside(tail, e + 1, taps);
      }
      win_f[2 * m] = v0;
      if (2 * m + 1 < w_len) win_f[2 * m + 1] = v1;
    }
  }

  // the envelope samples this tile owns, four to a store
  const long long own = c * kTile;
  for (int q = tid; q < kTile / 4; q += kThreads) {
    const long long e = own + 4 * q;
    if (e < n) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      decode2<kPairs>(raw + e, flip, v[0], v[1]);
      if (e + 2 < n) decode2<kPairs>(raw + e + 2, flip, v[2], v[3]);
      tsdr::store4(env, e, n, v);
    }
  }

  const float inv_f = __fmul_rn(__ll2float_rn(inv), 1.0f / (float)(1LL << kFracBits));
  const float rate = __fdiv_rn((float)(1LL << kFracBits), __ll2float_rn(inv));
  const float delta2 = (float)(2.0 * (double)inv * (1.0 / (double)(1LL << kFracBits)) - 1.0);
  const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)),
                               1.0f / (float)(1LL << kFracBits));
  const float rel0 = __fadd_rn((float)margin, frac);
  __syncthreads();

  // K1's resample on the window (win[j] = x_ext[start - margin + taps + j])
  const float* win = win_f + par;
#pragma unroll
  for (int it = 0; it < kTile / (2 * kThreads); ++it) {
    const int s0 = 2 * (tid + it * kThreads);
    float v[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u;
      v[2 * u] = v[2 * u + 1] = 0.0f;
      if (2 * s < lim) {  // lim == 0: the window was not decoded and is not read
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

}  // namespace

extern "C" int tsdr_fused_tile() { return kTile; }

// Launches K2 (pairs = 2) or K2' (pairs = 1) on `stream`; returns the
// cudaError_t of the launch (0 = ok). raw must be 4-byte aligned, n_samples
// even, and env and out 16-byte aligned (fresh torch allocations are).
extern "C" int tsdr_fused_demod_resample(const void* raw, int is_signed, int pairs,
                                         const float* tail, const long long* phase,
                                         const long long* inv, long long n_samples,
                                         float* env, float* out, int* n_out,
                                         long long* new_phase, long long max_pix, int taps,
                                         int margin, int taps_eff, void* stream) {
  if (max_pix <= 0 || n_samples <= 0 || (n_samples & 1) || (pairs != 1 && pairs != 2) ||
      ((uintptr_t)raw & 3) != 0 || (((uintptr_t)env | (uintptr_t)out) & 15) != 0) {
    return 1;  // cudaErrorInvalidValue
  }
  const long long pix_blocks = (max_pix + 2LL * kTile - 1) / (2LL * kTile);
  const long long env_blocks = (n_samples + kTile - 1) / kTile;
  const long long blocks = pix_blocks > env_blocks ? pix_blocks : env_blocks;
  const size_t smem = (size_t)(kTile + taps_eff + 1) * sizeof(float);
  const unsigned flip = is_signed ? 128u : 0u;
  const uint16_t* r = static_cast<const uint16_t*>(raw);
  if (pairs == 2) {
    fused_kernel<2><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        r, flip, tail, phase, inv, n_samples, env, out, n_out, new_phase, max_pix, taps,
        margin, taps_eff);
  } else {
    fused_kernel<1><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        r, flip, tail, phase, inv, n_samples, env, out, n_out, new_phase, max_pix, taps,
        margin, taps_eff);
  }
  return (int)cudaGetLastError();
}
