// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (nvcc -shared, loaded with ctypes by
// repro_torch/kernels/build.py). A launcher takes raw device pointers and
// the caller's CUDA stream, launches, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Most B columns (marginal / potential columns) one launch reduces. The
// solvers run B = 1; the per-column running state lives in registers.
constexpr int kMaxCols = 8;

// Online log-sum-exp state: the sum is  acc * exp(mx).  An empty state is
// (mx = -inf, acc = 0). -inf entries are the LSE identity and are skipped,
// so an all -inf row or column stays empty and reads back as exactly -inf
// (the _finite_or_zero pin of the TPU kernels); NaN entries poison acc.
__device__ __forceinline__ void lse_push(float& mx, float& acc, float x) {
  if (x > mx) {
    acc = acc * expf(mx - x) + 1.0f;
    mx = x;
  } else if (x != -INFINITY) {
    acc += expf(x - mx);
  }
}

// Merge two online states (the butterfly step of a warp reduction).
__device__ __forceinline__ void lse_merge(float& mx, float& acc, float mx2,
                                          float acc2) {
  const float m = fmaxf(mx, mx2);
  if (m == -INFINITY) {
    acc += acc2;
    return;
  }
  acc = acc * expf(mx - m) + acc2 * expf(mx2 - m);
  mx = m;
}

__device__ __forceinline__ float lse_value(float mx, float acc) {
  return acc == 0.0f ? -INFINITY : mx + logf(acc);
}

// Factor storage: float, or bfloat16 (precision="bf16"). Every kernel
// widens a stored element to float on load and accumulates in float; the
// widening of a bf16 is exact (its bits are the float's top 16 bits).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float load_factor(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_factor(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Elements of T in one 16-byte vector load: 4 floats or 8 bfloat16.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The 16 bytes at p (16-byte aligned) widened to kVec<T> floats.
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // little-endian: the low half comes first
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// N consecutive floats of 16-byte aligned shared memory, as float4 loads.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
