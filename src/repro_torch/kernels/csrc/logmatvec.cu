// Log-domain factored Sinkhorn operators: the log contract and the log
// half-step.
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
// Bound on the H100: both read the (n, r) f32 factor once, 64 MiB at
// n = 16384, r = 1024, which is more than the 50 MB L2, so each launch
// streams it from device memory (about 20 us at 3.35 TB/s). One expf per
// entry (16.8 M) is far below the SFU rate, so both are bound by bytes.
// Loads are coalesced along r and many are kept in flight per thread: on
// the solver's path (B = 1, r a multiple of 4, 16-byte aligned rows) both
// kernels read float4 vectors, eight per thread at a time; other shapes
// take a scalar path with the same arithmetic per entry.
#include "common.cuh"

namespace {

constexpr int kContractThreads = 128;
constexpr int kContractChunk = 64;     // rows of s staged per pass
constexpr int kCombineWarps = 8;
constexpr int kHalfstepWarps = 8;
constexpr int kUnroll = 8;             // loads in flight per thread

// Scalar path: thread k owns column k of log_w, any B <= kMaxCols.
__global__ void __launch_bounds__(kContractThreads)
log_contract_partial_kernel(const float* __restrict__ log_w,
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
      const float* col = log_w + (size_t)base * r + k;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(col + (size_t)(i + u) * r);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (c < B) lse_push(mx[c], acc[c], w[u] + s_sh[(i + u) * B + c]);
        }
      }
      for (; i < rows; ++i) {
        const float w = __ldg(col + (size_t)i * r);
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

// Vector path (B == 1, r % 4 == 0, aligned rows): thread q owns columns
// 4q .. 4q+3 and reads them as one float4 per row.
__global__ void __launch_bounds__(kContractThreads)
log_contract_partial_vec_kernel(const float* __restrict__ log_w,
                                const float* __restrict__ s,
                                float* __restrict__ partial, int n, int r,
                                int rows_per_split) {
  __shared__ float s_sh[kContractChunk];
  const int q = blockIdx.x * kContractThreads + threadIdx.x;
  const int r4 = r >> 2;
  const int split = blockIdx.y;
  const int i_begin = split * rows_per_split;
  const int i_end = min(n, i_begin + rows_per_split);
  const float4* w4 = reinterpret_cast<const float4*>(log_w);

  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int base = i_begin; base < i_end; base += kContractChunk) {
    const int rows = min(kContractChunk, i_end - base);
    for (int e = threadIdx.x; e < rows; e += kContractThreads)
      s_sh[e] = s[base + e];
    __syncthreads();
    if (q < r4) {
      const float4* col = w4 + (size_t)base * r4 + q;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        float4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(col + (size_t)(i + u) * r4);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float sv = s_sh[i + u];
          lse_push(mx[0], acc[0], w[u].x + sv);
          lse_push(mx[1], acc[1], w[u].y + sv);
          lse_push(mx[2], acc[2], w[u].z + sv);
          lse_push(mx[3], acc[3], w[u].w + sv);
        }
      }
      for (; i < rows; ++i) {
        const float4 w = __ldg(col + (size_t)i * r4);
        const float sv = s_sh[i];
        lse_push(mx[0], acc[0], w.x + sv);
        lse_push(mx[1], acc[1], w.y + sv);
        lse_push(mx[2], acc[2], w.z + sv);
        lse_push(mx[3], acc[3], w.w + sv);
      }
    }
    __syncthreads();
  }

  if (q >= r4) return;
  float4 out;
  out.x = lse_value(mx[0], acc[0]);
  out.y = lse_value(mx[1], acc[1]);
  out.z = lse_value(mx[2], acc[2]);
  out.w = lse_value(mx[3], acc[3]);
  reinterpret_cast<float4*>(partial + (size_t)split * r)[q] = out;
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

// One warp per output row. Vector path when B == 1 and rows are float4
// aligned (vec != 0): lane l reads float4 l, l + 32, ... of the row.
__global__ void __launch_bounds__(kHalfstepWarps * 32)
log_halfstep_kernel(const float* __restrict__ log_w,
                    const float* __restrict__ t,
                    const float* __restrict__ lmarg, float* __restrict__ out,
                    int m, int r, int B, float scale, int vec) {
  extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  for (int e = threadIdx.x; e < r * B; e += kHalfstepWarps * 32) t_sh[e] = t[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x * kHalfstepWarps + warp; j < m;
       j += gridDim.x * kHalfstepWarps) {
    if (vec) {
      const int r4 = r >> 2;
      const float4* row = reinterpret_cast<const float4*>(log_w) + (size_t)j * r4;
      float mx = -INFINITY, acc = 0.0f;
      int k = lane;
      for (; k + 32 * (kUnroll - 1) < r4; k += 32 * kUnroll) {
        float4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(row + k + 32 * u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 tv = t_sh4[k + 32 * u];
          lse_push(mx, acc, w[u].x + tv.x);
          lse_push(mx, acc, w[u].y + tv.y);
          lse_push(mx, acc, w[u].z + tv.z);
          lse_push(mx, acc, w[u].w + tv.w);
        }
      }
      for (; k < r4; k += 32) {
        const float4 w = __ldg(row + k);
        const float4 tv = t_sh4[k];
        lse_push(mx, acc, w.x + tv.x);
        lse_push(mx, acc, w.y + tv.y);
        lse_push(mx, acc, w.z + tv.z);
        lse_push(mx, acc, w.w + tv.w);
      }
      warp_lse_merge(mx, acc);
      if (lane == 0) out[j] = scale * (lmarg[j] - lse_value(mx, acc));
      continue;
    }
    const float* row = log_w + (size_t)j * r;
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
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(row + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < B) lse_push(mx[c], acc[c], w[u] + t_sh[(k + 32 * u) * B + c]);
      }
    }
    for (; k < r; k += 32) {
      const float w = __ldg(row + k);
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

}  // namespace

// vec != 0 selects the float4 path; the caller passes it only for B == 1,
// r % 4 == 0 and a 16-byte aligned log_w. Columns per CTA: 4 * 128 on the
// vector path, 128 on the scalar path.
REPRO_EXPORT int log_feature_contract_launch(const float* log_w,
                                             const float* s, float* partial,
                                             float* t, int n, int r, int B,
                                             int n_splits,
                                             int rows_per_split, int vec,
                                             cudaStream_t stream) {
  if (vec && (B != 1 || r % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = vec ? 4 * kContractThreads : kContractThreads;
  const dim3 grid((r + cols - 1) / cols, n_splits);
  if (vec) {
    log_contract_partial_vec_kernel<<<grid, kContractThreads, 0, stream>>>(
        log_w, s, partial, n, r, rows_per_split);
  } else {
    log_contract_partial_kernel<<<grid, kContractThreads, 0, stream>>>(
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

REPRO_EXPORT int log_halfstep_launch(const float* log_w, const float* t,
                                     const float* lmarg, float* out, int m,
                                     int r, int B, float scale, int vec,
                                     int grid, cudaStream_t stream) {
  if (vec && (B != 1 || r % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)r * B * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        log_halfstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  log_halfstep_kernel<<<grid, kHalfstepWarps * 32, smem, stream>>>(
      log_w, t, lmarg, out, m, r, B, scale, vec);
  return static_cast<int>(cudaGetLastError());
}
