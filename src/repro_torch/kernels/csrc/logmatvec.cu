// Log-domain factored Sinkhorn operators: the log contract, the log
// half-step and the single-column row LSE log_matvec.
//
// log_feature_contract replaces the TPU kernels in
// src/repro/kernels/logmatvec.py, _log_contract_kernel and its split-k twin
// _log_contract_splitk_kernel (launched by _log_contract_impl /
// _log_contract_splitk_impl):
//
//   t[k, c] = LSE_i( log_w[i, k] + s[i, c] )        (n, r), (n, B) -> (r, B)
//
// The TPU reduces n on a sequential grid axis into a revisited output
// block. CTAs on Hopper run in no order, so the reduction is split: each
// CTA owns a slab of rows and a tile of r, and writes its partial LSE to a
// (n_splits, r, B) scratch buffer; a second small launch combines the
// partials with an exact two-pass LSE (one warp per output, a fixed lane
// assignment and shuffle tree). No atomics, so the result is deterministic.
//
// log_halfstep replaces _log_halfstep_kernel (launched by
// _log_halfstep_impl):
//
//   out[j, c] = scale * ( lmarg[j, c] - LSE_k( log_w[j, k] + t[k, c] ) )
//
// one warp per output row; scale = eps gives the potential update and
// scale = -1 with lmarg = 0 the raw LSE of the convergence check.
//
// log_matvec replaces _log_matvec_kernel (launched by _log_matvec_impl):
//
//   out[j] = LSE_k( log_m[j, k] + t[k] )                 (m, r), (r,) -> (m,)
//
// one warp per row, t staged in shared memory, with the TPU kernel's exact
// row max: a first pass over the row takes the max, pinned to 0 where it
// is not finite (_finite_or_zero, so an all -inf row gives -inf), a second
// pass sums exp(x - max). The second pass reads the row again, from the
// L1 or the L2; the bound counts one read.
//
// The factor log_w is stored as float or as bfloat16 (precision="bf16",
// half the bytes); each kernel is a template on that storage type T,
// widens every element to float on load and accumulates in float.
//
// Bound on the H100: all three read the (n, r) factor once, 64 MiB in float
// at n = 16384, r = 1024, which is more than the 50 MB L2, so each launch
// streams it from device memory (about 20 us at 3.35 TB/s; half that in
// bf16). One expf per entry (16.8 M) is far below the SFU rate, so all
// three are bound by bytes. Loads are coalesced along r and many are kept
// in flight per thread: on the solver's path (B = 1, rows a multiple of 16
// bytes, 16-byte aligned) the kernels read 16-byte vectors (4 floats or 8
// bf16), eight per thread at a time; other shapes take a scalar path with
// the same arithmetic per entry. The contract's wrapper also takes the
// scalar path where r is too small for the vectors of a row to fill a CTA
// (r < 1024 in bf16, as at the training batches' r = 128).
#include "common.cuh"

namespace {

constexpr int kContractThreads = 128;
constexpr int kContractChunk = 64;     // rows of s staged per pass
constexpr int kCombineWarps = 8;
constexpr int kHalfstepWarps = 8;
constexpr int kUnroll = 8;             // loads in flight per thread

// Scalar path: thread k owns column k of log_w, any B <= kMaxCols.
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
log_contract_partial_kernel(const T* __restrict__ log_w,
                            const float* __restrict__ s,
                            float* __restrict__ partial, int n, int r, int B,
                            int rows_per_split) {
  __shared__ float s_sh[kContractChunk * kMaxCols];
  const int k = blockIdx.x * kContractThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int i_begin = split * rows_per_split;
  const int i_end = min(n, i_begin + rows_per_split);

  float mx[kMaxCols], acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    mx[c] = -INFINITY;
    acc[c] = 0.0f;
  }

  for (int base = i_begin; base < i_end; base += kContractChunk) {
    const int rows = min(kContractChunk, i_end - base);
    for (int e = threadIdx.x; e < rows * B; e += kContractThreads)
      s_sh[e] = s[(size_t)base * B + e];
    __syncthreads();
    if (k < r) {
      const T* col = log_w + (size_t)base * r + k;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = load_factor(col + (size_t)(i + u) * r);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (c < B) lse_push(mx[c], acc[c], w[u] + s_sh[(i + u) * B + c]);
        }
      }
      for (; i < rows; ++i) {
        const float w = load_factor(col + (size_t)i * r);
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < B) lse_push(mx[c], acc[c], w + s_sh[i * B + c]);
      }
    }
    __syncthreads();
  }

  if (k >= r) return;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (c < B) partial[((size_t)split * r + k) * B + c] = lse_value(mx[c], acc[c]);
}

// Vector path (B == 1, rows of a multiple of 16 bytes, aligned): thread q
// owns the V = kVec<T> columns V*q .. V*q + V-1 and reads them as one
// 16-byte vector per row.
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
log_contract_partial_vec_kernel(const T* __restrict__ log_w,
                                const float* __restrict__ s,
                                float* __restrict__ partial, int n, int r,
                                int rows_per_split) {
  constexpr int V = kVec<T>;
  __shared__ float s_sh[kContractChunk];
  const int q = blockIdx.x * kContractThreads + threadIdx.x;
  const int rv = r / V;
  const int split = blockIdx.y;
  const int i_begin = split * rows_per_split;
  const int i_end = min(n, i_begin + rows_per_split);
  const uint4* wv = reinterpret_cast<const uint4*>(log_w);

  float mx[V], acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mx[e] = -INFINITY;
    acc[e] = 0.0f;
  }

  for (int base = i_begin; base < i_end; base += kContractChunk) {
    const int rows = min(kContractChunk, i_end - base);
    for (int e = threadIdx.x; e < rows; e += kContractThreads)
      s_sh[e] = s[base + e];
    __syncthreads();
    if (q < rv) {
      const uint4* col = wv + (size_t)base * rv + q;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(col + (size_t)(i + u) * rv);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float w[V];
          unpack16(raw[u], w);
          const float sv = s_sh[i + u];
#pragma unroll
          for (int e = 0; e < V; ++e) lse_push(mx[e], acc[e], w[e] + sv);
        }
      }
      for (; i < rows; ++i) {
        float w[V];
        unpack16(__ldg(col + (size_t)i * rv), w);
        const float sv = s_sh[i];
#pragma unroll
        for (int e = 0; e < V; ++e) lse_push(mx[e], acc[e], w[e] + sv);
      }
    }
    __syncthreads();
  }

  if (q >= rv) return;
  float* out = partial + (size_t)split * r + (size_t)V * q;
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(out + e) =
        make_float4(lse_value(mx[e], acc[e]), lse_value(mx[e + 1], acc[e + 1]),
                    lse_value(mx[e + 2], acc[e + 2]),
                    lse_value(mx[e + 3], acc[e + 3]));
}

// Exact LSE over the split axis of the partials, one warp per output: the
// joint max first, then the shifted sum, each over a fixed lane assignment
// and shuffle tree. A split whose partial is -inf drops out; if every
// partial is -inf the result is -inf.
__global__ void __launch_bounds__(kCombineWarps * 32)
log_contract_combine_kernel(const float* __restrict__ partial,
                            float* __restrict__ t, int n_splits, int size) {
  const int e = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= size) return;
  float mx = -INFINITY;
  for (int p = lane; p < n_splits; p += 32)
    mx = fmaxf(mx, partial[(size_t)p * size + e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float acc = 0.0f;
  for (int p = lane; p < n_splits; p += 32) {
    const float v = partial[(size_t)p * size + e];
    if (v != -INFINITY) acc += expf(v - mx);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) t[e] = lse_value(mx, acc);
}

__device__ __forceinline__ void warp_lse_merge(float& mx, float& acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mx2 = __shfl_xor_sync(0xffffffffu, mx, off);
    const float acc2 = __shfl_xor_sync(0xffffffffu, acc, off);
    lse_merge(mx, acc, mx2, acc2);
  }
}

// One warp per output row. Vector path when B == 1 and rows are 16-byte
// vectors (vec != 0): lane l reads vectors l, l + 32, ... of the row.
template <typename T>
__global__ void __launch_bounds__(kHalfstepWarps * 32)
log_halfstep_kernel(const T* __restrict__ log_w,
                    const float* __restrict__ t,
                    const float* __restrict__ lmarg, float* __restrict__ out,
                    int m, int r, int B, float scale, int vec) {
  constexpr int V = kVec<T>;
  extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  for (int e = threadIdx.x; e < r * B; e += kHalfstepWarps * 32) t_sh[e] = t[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x * kHalfstepWarps + warp; j < m;
       j += gridDim.x * kHalfstepWarps) {
    if (vec) {
      const int rv = r / V;
      const uint4* row = reinterpret_cast<const uint4*>(log_w) + (size_t)j * rv;
      float mx = -INFINITY, acc = 0.0f;
      int k = lane;
      for (; k + 32 * (kUnroll - 1) < rv; k += 32 * kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(row + k + 32 * u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float w[V], tv[V];
          unpack16(raw[u], w);
          load_floats(t_sh + (size_t)V * (k + 32 * u), tv);
#pragma unroll
          for (int e = 0; e < V; ++e) lse_push(mx, acc, w[e] + tv[e]);
        }
      }
      for (; k < rv; k += 32) {
        float w[V], tv[V];
        unpack16(__ldg(row + k), w);
        load_floats(t_sh + (size_t)V * k, tv);
#pragma unroll
        for (int e = 0; e < V; ++e) lse_push(mx, acc, w[e] + tv[e]);
      }
      warp_lse_merge(mx, acc);
      if (lane == 0) out[j] = scale * (lmarg[j] - lse_value(mx, acc));
      continue;
    }
    const T* row = log_w + (size_t)j * r;
    float mx[kMaxCols], acc[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      mx[c] = -INFINITY;
      acc[c] = 0.0f;
    }
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < r; k += 32 * kUnroll) {
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = load_factor(row + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < B) lse_push(mx[c], acc[c], w[u] + t_sh[(k + 32 * u) * B + c]);
      }
    }
    for (; k < r; k += 32) {
      const float w = load_factor(row + k);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < B) lse_push(mx[c], acc[c], w + t_sh[k * B + c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < B) warp_lse_merge(mx[c], acc[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < B) {
          const size_t o = (size_t)j * B + c;
          out[o] = scale * (lmarg[o] - lse_value(mx[c], acc[c]));
        }
    }
  }
}

// Calls f(x) for every entry x = log_m[j, k] + t[k] of row j that lane
// owns: 16-byte vectors l, l + 32, ... of the row (eight in flight) when
// vec != 0, else elements l, l + 32, ...
template <typename T, typename F>
__device__ __forceinline__ void for_row_entries(const T* __restrict__ log_m,
                                                const float* t_sh, size_t j,
                                                int r, int lane, int vec,
                                                F&& f) {
  constexpr int V = kVec<T>;
  if (vec) {
    const int rv = r / V;
    const uint4* row = reinterpret_cast<const uint4*>(log_m) + j * rv;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < rv; k += 32 * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(row + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float w[V], tv[V];
        unpack16(raw[u], w);
        load_floats(t_sh + (size_t)V * (k + 32 * u), tv);
#pragma unroll
        for (int e = 0; e < V; ++e) f(w[e] + tv[e]);
      }
    }
    for (; k < rv; k += 32) {
      float w[V], tv[V];
      unpack16(__ldg(row + k), w);
      load_floats(t_sh + (size_t)V * k, tv);
#pragma unroll
      for (int e = 0; e < V; ++e) f(w[e] + tv[e]);
    }
    return;
  }
  const T* row = log_m + j * r;
  for (int k = lane; k < r; k += 32) f(load_factor(row + k) + t_sh[k]);
}

template <typename T>
__global__ void __launch_bounds__(kHalfstepWarps * 32)
log_matvec_kernel(const T* __restrict__ log_m, const float* __restrict__ t,
                  float* __restrict__ out, int m, int r, int vec) {
  extern __shared__ float4 t_sh4[];  // (r,)
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  for (int e = threadIdx.x; e < r; e += kHalfstepWarps * 32) t_sh[e] = t[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x * kHalfstepWarps + warp; j < m;
       j += gridDim.x * kHalfstepWarps) {
    float mx = -INFINITY;
    for_row_entries(log_m, t_sh, j, r, lane, vec,
                    [&](float x) { mx = fmaxf(mx, x); });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (!isfinite(mx)) mx = 0.0f;
    float acc = 0.0f;
    for_row_entries(log_m, t_sh, j, r, lane, vec,
                    [&](float x) { acc += expf(x - mx); });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[j] = mx + logf(acc);
  }
}

template <typename T>
int log_matvec_launch_t(const T* log_m, const float* t, float* out, int m,
                        int r, int vec, int grid, cudaStream_t stream) {
  if (vec && r % kVec<T> != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)r * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        log_matvec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_matvec_kernel<T><<<grid, kHalfstepWarps * 32, smem, stream>>>(
      log_m, t, out, m, r, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int contract_launch(const T* log_w, const float* s, float* partial, float* t,
                    int n, int r, int B, int n_splits, int rows_per_split,
                    int vec, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  if (vec && (B != 1 || r % V != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = vec ? V * kContractThreads : kContractThreads;
  const dim3 grid((r + cols - 1) / cols, n_splits);
  if (vec) {
    log_contract_partial_vec_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        log_w, s, partial, n, r, rows_per_split);
  } else {
    log_contract_partial_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        log_w, s, partial, n, r, B, rows_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = r * B;
  log_contract_combine_kernel<<<(size + kCombineWarps - 1) / kCombineWarps,
                                kCombineWarps * 32, 0, stream>>>(
      partial, t, n_splits, size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halfstep_launch(const T* log_w, const float* t, const float* lmarg,
                    float* out, int m, int r, int B, float scale, int vec,
                    int grid, cudaStream_t stream) {
  if (vec && (B != 1 || r % kVec<T> != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)r * B * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        log_halfstep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_halfstep_kernel<T><<<grid, kHalfstepWarps * 32, smem, stream>>>(
      log_w, t, lmarg, out, m, r, B, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log_w is float (bf16 == 0) or bfloat16 (bf16 != 0). vec != 0 selects the
// 16-byte vector path; the caller passes it only for B == 1, rows of a
// multiple of 16 bytes and a 16-byte aligned log_w. Columns per CTA:
// 128 * (16 / element size) on the vector path, 128 on the scalar path.
REPRO_EXPORT int log_feature_contract_launch(const void* log_w, int bf16,
                                             const float* s, float* partial,
                                             float* t, int n, int r, int B,
                                             int n_splits,
                                             int rows_per_split, int vec,
                                             cudaStream_t stream) {
  if (bf16)
    return contract_launch(static_cast<const __nv_bfloat16*>(log_w), s,
                           partial, t, n, r, B, n_splits, rows_per_split, vec,
                           stream);
  return contract_launch(static_cast<const float*>(log_w), s, partial, t, n,
                         r, B, n_splits, rows_per_split, vec, stream);
}

REPRO_EXPORT int log_halfstep_launch(const void* log_w, int bf16,
                                     const float* t, const float* lmarg,
                                     float* out, int m, int r, int B,
                                     float scale, int vec, int grid,
                                     cudaStream_t stream) {
  if (bf16)
    return halfstep_launch(static_cast<const __nv_bfloat16*>(log_w), t, lmarg,
                           out, m, r, B, scale, vec, grid, stream);
  return halfstep_launch(static_cast<const float*>(log_w), t, lmarg, out, m,
                         r, B, scale, vec, grid, stream);
}

// log_m is float (bf16 == 0) or bfloat16 (bf16 != 0); vec != 0 selects the
// 16-byte vector path (rows of a multiple of 16 bytes, 16-byte aligned).
REPRO_EXPORT int log_matvec_launch(const void* log_m, int bf16,
                                   const float* t, float* out, int m, int r,
                                   int vec, int grid, cudaStream_t stream) {
  if (bf16)
    return log_matvec_launch_t(static_cast<const __nv_bfloat16*>(log_m), t,
                               out, m, r, vec, grid, stream);
  return log_matvec_launch_t(static_cast<const float*>(log_m), t, out, m, r,
                             vec, grid, stream);
}
