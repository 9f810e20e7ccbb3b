// Window staging for the resample kernels K1, K3 and K4, for Hopper, and the
// pixel mask and 16-byte store they share with K2.
//
// A thread block of K1, K3 or K4 stages one window of floats into shared
// memory (K1: a chunk's envelope window, K3: a group of tiles', K4: a
// group's rows of gathered windows), waits for it once and computes from
// it. The window goes as 16-byte asynchronous copies (cp.async.cg, all
// threads) from the 16-byte boundary at or below its first sample, whatever
// the alignment of the input itself; a window that leaves the input (the
// first and last of a block of samples) goes as checked 4-byte loads. The
// host statement of the same rules is kernels/window_plan.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tsdr {

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem_src) : "memory");
}

// waits until every asynchronous copy this thread has issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats of the buffer for a window of `len` samples: up to 3 samples ahead
// of the window (the round-down to 16 bytes) and the length rounded up to
// whole 16-byte pieces
__host__ __device__ __forceinline__ int slot_floats(int len) { return (len + 6) & ~3; }

// where x[w0] lands in a buffer staged by stage_window: 0..3
__device__ __forceinline__ int window_offset(const float* x, long long w0) {
  const int mis = (int)(((uintptr_t)x >> 2) & 3);  // x past a 16-byte boundary, in floats
  return (int)((w0 + mis) & 3);
}

// Stages x[w0, w0 + len) into `slot` so that slot[off + j] = x[w0 + j] with
// off = window_offset(x, w0); samples outside [0, x_len) read as 0. The
// staged range starts at the 16-byte boundary at or below x + w0 and ends on
// one. When it lies inside x it goes as 16-byte asynchronous copies,
// otherwise as checked 4-byte loads. Either way the buffer is complete after
// the caller's cp_async_wait_all and __syncthreads.
__device__ __forceinline__ void stage_window(float* slot, const float* __restrict__ x,
                                             long long x_len, long long w0, int len, int tid,
                                             int nthreads) {
  const int off = window_offset(x, w0);
  const long long a = w0 - off;  // first staged sample; x + a is 16-byte aligned
  const int n4 = (off + len + 3) >> 2;
  if (a >= 0 && a + 4LL * n4 <= x_len) {
    const float* src = x + a;
    for (int j = tid; j < n4; j += nthreads) cp_async16(slot + 4 * j, src + 4 * j);
  } else {
    for (int j = tid; j < 4 * n4; j += nthreads) {
      const long long i = a + j;
      slot[j] = (i >= 0 && i < x_len) ? x[i] : 0.0f;
    }
  }
}

// Of `total` pixels numbered from p0, how many are complete (p < n_out) this
// block of samples: min(max(n_out - p0, 0), total) with n_out =
// max(floor(num / inv), 0), without dividing unless the boundary n_out falls
// inside (p0, p0 + total): p < floor(num / inv) is (p + 1)*inv <= num.
__device__ __forceinline__ int valid_pixels(long long p0, int total, long long num,
                                            long long inv) {
  if ((p0 + 1) * inv > num) return 0;  // covers num <= 0
  if ((p0 + total) * inv <= num) return total;
  return (int)(num / inv - p0);
}

// Four consecutive pixels v to out[p .. p + 3]: one 16-byte store (p is a
// multiple of 4 and out 16-byte aligned), scalar at the max_pix edge.
__device__ __forceinline__ void store4(float* __restrict__ out, long long p, long long max_pix,
                                       const float (&v)[4]) {
  if (p + 4 <= max_pix) {
    *reinterpret_cast<float4*>(out + p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (p + u < max_pix) out[p + u] = v[u];
  }
}

}  // namespace tsdr
