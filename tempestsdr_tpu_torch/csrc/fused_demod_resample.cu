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
// Design: one thread block of 256 threads per tile of 1024 samples. The
// tile decodes its window (1024 + taps_eff samples, which covers the whole
// PLL headroom, so no fallback branch) into shared memory, and, separately,
// the 1024 envelope samples it owns, which it writes to env: each env
// sample is written exactly once, by its owner, while windows overlap and
// drift away from the owned range along the block. The two variants differ
// only in how many IQ pairs a thread loads at once — the card's counterpart
// of the TPU's u32-vs-u16 window layouts:
//   K2  (kPairs = 2): one 4-byte load, two samples, per thread and step;
//   K2' (kPairs = 1): one 2-byte load, one sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // samples per thread block
constexpr int kFracBits = 40;

__device__ __forceinline__ float mag(unsigned i, unsigned q, unsigned flip) {
  const float a = (float)((int)(i ^ flip) - 128);
  const float b = (float)((int)(q ^ flip) - 128);
  return __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))), 0.0078125f);
}

// x_ext sample of envelope index e, for e outside the pairs a thread loads
__device__ __forceinline__ float sample_at(const uint8_t* raw, const float* tail, long long e,
                                           long long n, int taps, unsigned flip) {
  if (e >= 0 && e < n) {
    const unsigned v = *reinterpret_cast<const uint16_t*>(raw + 2 * e);
    return mag(v & 0xFFu, v >> 8, flip);
  }
  if (e < 0 && e >= -taps) return tail[taps + e];
  return 0.0f;
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
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint8_t* __restrict__ raw, unsigned flip, const float* __restrict__ tail,
             const long long* __restrict__ phase_p, const long long* __restrict__ inv_p,
             long long n_samples, float* __restrict__ env, float* __restrict__ out,
             int* __restrict__ n_out_p, long long* __restrict__ new_phase_p,
             long long max_pix, int taps, int margin, int taps_eff) {
  extern __shared__ float win_raw[];  // kTile + taps_eff + 1 samples
  __shared__ long long s_n_out;
  const long long phase = *phase_p;
  const long long inv = *inv_p;  // > 0
  const long long n = n_samples;  // even
  const long long c = blockIdx.x;
  if (threadIdx.x == 0) {
    const long long size_fix = n << kFracBits;
    const long long num = size_fix - phase;
    const long long n_out = num > 0 ? num / inv : 0;
    s_n_out = n_out;
    if (c == 0) {
      *n_out_p = (int)n_out;
      *new_phase_p = phase + n_out * inv - size_fix;
    }
  }

  // the tile's window, as K1's: x_ext indices from w0 = start - margin + taps,
  // i.e. envelope indices from w0 - taps; staged from the even envelope
  // index e0 <= w0 - taps so that pairs stay 4-byte aligned
  const long long base = phase + c * (2LL * kTile) * inv;
  const long long start = base >> kFracBits;
  const float frac = __fmul_rn(__ll2float_rn(base - (start << kFracBits)),
                               1.0f / (float)(1LL << kFracBits));
  const int par = (int)((start - margin) & 1);
  const long long e0 = start - margin - par;
  const int w_len = kTile + taps_eff + 1;
  if (kPairs == 2) {
    for (int m = threadIdx.x; 2 * m < w_len; m += kThreads) {
      const long long e = e0 + 2 * m;  // even: the pair (e, e+1) is inside [0, n) or outside
      float v0, v1;
      if (e >= 0 && e < n) {
        const unsigned v = *reinterpret_cast<const uint32_t*>(raw + 2 * e);
        v0 = mag(v & 0xFFu, (v >> 8) & 0xFFu, flip);
        v1 = mag((v >> 16) & 0xFFu, v >> 24, flip);
      } else {
        v0 = sample_at(raw, tail, e, n, taps, flip);
        v1 = sample_at(raw, tail, e + 1, n, taps, flip);
      }
      win_raw[2 * m] = v0;
      if (2 * m + 1 < w_len) win_raw[2 * m + 1] = v1;
    }
  } else {
    for (int k = threadIdx.x; k < w_len; k += kThreads) {
      win_raw[k] = sample_at(raw, tail, e0 + k, n, taps, flip);
    }
  }

  // the envelope samples this tile owns
  const long long own = c * kTile;
  if (kPairs == 2) {
    for (int m = threadIdx.x; m < kTile / 2; m += kThreads) {
      const long long e = own + 2 * m;
      if (e < n) {
        const unsigned v = *reinterpret_cast<const uint32_t*>(raw + 2 * e);
        *reinterpret_cast<float2*>(env + e) =
            make_float2(mag(v & 0xFFu, (v >> 8) & 0xFFu, flip), mag((v >> 16) & 0xFFu, v >> 24, flip));
      }
    }
  } else {
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const long long e = own + k;
      if (e < n) {
        const unsigned v = *reinterpret_cast<const uint16_t*>(raw + 2 * e);
        env[e] = mag(v & 0xFFu, v >> 8, flip);
      }
    }
  }
  __syncthreads();

  // K1's resample on the staged window (win[j] = x_ext[w0 + j])
  const float* win = win_raw + par;
  const long long n_out = s_n_out;
  const float inv_f = __fmul_rn(__ll2float_rn(inv), 1.0f / (float)(1LL << kFracBits));
  const float rate = __fdiv_rn((float)(1LL << kFracBits), __ll2float_rn(inv));
  const float delta2 = (float)(2.0 * (double)inv * (1.0 / (double)(1LL << kFracBits)) - 1.0);
  const float rel0 = __fadd_rn((float)margin, frac);

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x + k * kThreads;
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

extern "C" int tsdr_fused_tile() { return kTile; }

// Launches K2 (pairs = 2) or K2' (pairs = 1) on `stream`; returns the
// cudaError_t of the launch (0 = ok). raw must be 4-byte aligned and
// n_samples even.
extern "C" int tsdr_fused_demod_resample(const void* raw, int is_signed, int pairs,
                                         const float* tail, const long long* phase,
                                         const long long* inv, long long n_samples,
                                         float* env, float* out, int* n_out,
                                         long long* new_phase, long long max_pix, int taps,
                                         int margin, int taps_eff, void* stream) {
  if (max_pix <= 0 || n_samples <= 0 || (n_samples & 1) || (pairs != 1 && pairs != 2)) {
    return 1;  // cudaErrorInvalidValue
  }
  const long long pix_blocks = (max_pix + 2LL * kTile - 1) / (2LL * kTile);
  const long long env_blocks = (n_samples + kTile - 1) / kTile;
  const long long blocks = pix_blocks > env_blocks ? pix_blocks : env_blocks;
  const size_t smem = (size_t)(kTile + taps_eff + 1) * sizeof(float);
  const unsigned flip = is_signed ? 128u : 0u;
  const uint8_t* r = static_cast<const uint8_t*>(raw);
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
