// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (nvcc -shared, loaded with ctypes by
// repro_torch/kernels/build.py). A launcher takes raw device pointers and
// the caller's CUDA stream, launches, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
