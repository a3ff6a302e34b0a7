// Device code shared by the scaling-space feature kernels of kermatvec.cu
// (flat buffers) and paged.cu (paged buffers): the contract's accumulation
// over a run of rows, its partial store and fixed-order combine, and the
// one-warp row dot product of the half-step and the matvec. Each source
// keeps its own kernels and entry points; only the paged ones look at a
// page table.
//
// The contract accumulates t = xi^T u over rows [i_begin, i_end) in chunks
// of kContractChunk rows of u staged in shared memory. Every thread of a
// CTA calls it with the same bounds (it synchronises the CTA). Loads are
// coalesced along r and kUnroll are kept in flight per thread: a scalar
// path, thread k owning column k of xi and kMaxCols columns of u, and a
// vector path (B == 1, 16-byte rows), thread q owning the kVec<T> columns
// of its 16-byte vector. Partials combine over the split axis in the order
// split = 0, 1, ... (one warp per output, fixed lanes and shuffle tree), so
// a rerun is bit-identical.
//
// The row kernels take one warp per row against t staged in shared memory:
// the vector path reads vectors lane, lane + 32, ... of the row; the scalar
// path elements lane, lane + 32, ... for kMaxCols columns of t at a time.
// The half-step's divide (kDivide) is IEEE float32 (__fdiv_rn).
#pragma once

#include "common.cuh"

namespace feature_ops {

constexpr int kContractThreads = 128;
constexpr int kContractChunk = 64;     // rows of u staged per pass
constexpr int kCombineWarps = 8;
constexpr int kRowWarps = 8;
constexpr int kUnroll = 8;             // loads in flight per thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Scalar path: acc[c] += sum over rows i of xi[i, k] * u[i, c0 + c].
template <typename T>
__device__ __forceinline__ void contract_rows(
    const T* __restrict__ xi, const float* __restrict__ u, float* u_sh,
    float (&acc)[kMaxCols], int k, int r, int B, int c0, int nc,
    int i_begin, int i_end) {
  for (int base = i_begin; base < i_end; base += kContractChunk) {
    const int rows = min(kContractChunk, i_end - base);
    for (int e = threadIdx.x; e < rows * nc; e += kContractThreads) {
      const int i = e / nc;
      u_sh[e] = u[(size_t)(base + i) * B + c0 + (e - i * nc)];
    }
    __syncthreads();
    if (k < r) {
      const T* col = xi + (size_t)base * r + k;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        float w[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) w[q] = load_factor(col + (size_t)(i + q) * r);
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (c < nc) acc[c] = fmaf(w[q], u_sh[(i + q) * nc + c], acc[c]);
        }
      }
      for (; i < rows; ++i) {
        const float w = load_factor(col + (size_t)i * r);
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < nc) acc[c] = fmaf(w, u_sh[i * nc + c], acc[c]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void contract_store(
    float* __restrict__ partial, const float (&acc)[kMaxCols], int split,
    int k, int r, int B, int c0, int nc) {
  if (k >= r) return;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (c < nc) partial[((size_t)split * r + k) * B + c0 + c] = acc[c];
}

// Vector path (B == 1): acc[e] += sum over rows i of xi[i, V*q + e] * u[i].
template <typename T>
__device__ __forceinline__ void contract_rows_vec(
    const T* __restrict__ xi, const float* __restrict__ u, float* u_sh,
    float (&acc)[kVec<T>], int q, int rv, int i_begin, int i_end) {
  constexpr int V = kVec<T>;
  const uint4* xv = reinterpret_cast<const uint4*>(xi);
  for (int base = i_begin; base < i_end; base += kContractChunk) {
    const int rows = min(kContractChunk, i_end - base);
    for (int e = threadIdx.x; e < rows; e += kContractThreads) u_sh[e] = u[base + e];
    __syncthreads();
    if (q < rv) {
      const uint4* col = xv + (size_t)base * rv + q;
      int i = 0;
      for (; i + kUnroll <= rows; i += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int p = 0; p < kUnroll; ++p) raw[p] = __ldg(col + (size_t)(i + p) * rv);
#pragma unroll
        for (int p = 0; p < kUnroll; ++p) {
          float w[V];
          unpack16(raw[p], w);
          const float uv = u_sh[i + p];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(w[e], uv, acc[e]);
        }
      }
      for (; i < rows; ++i) {
        float w[V];
        unpack16(__ldg(col + (size_t)i * rv), w);
        const float uv = u_sh[i];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(w[e], uv, acc[e]);
      }
    }
    __syncthreads();
  }
}

template <int V>
__device__ __forceinline__ void contract_store_vec(
    float* __restrict__ partial, const float (&acc)[V], int split, int q,
    int r, int rv) {
  if (q >= rv) return;
  float* out = partial + (size_t)split * r + (size_t)V * q;
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(out + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
}

// Sum over the split axis of the partials, one warp per output: lane l
// adds splits l, l + 32, ... in order, then a fixed shuffle tree.
__device__ __forceinline__ void contract_combine(
    const float* __restrict__ partial, float* __restrict__ t, int n_splits,
    int size) {
  const int e = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= size) return;
  float acc = 0.0f;
  for (int p = lane; p < n_splits; p += 32) acc += partial[(size_t)p * size + e];
  acc = warp_sum(acc);
  if (lane == 0) t[e] = acc;
}

// t (r, B) into the CTA's shared memory.
__device__ __forceinline__ void stage_t(const float* __restrict__ t,
                                        float* t_sh, int size) {
  for (int e = threadIdx.x; e < size; e += kRowWarps * 32) t_sh[e] = t[e];
  __syncthreads();
}

template <bool kDivide>
__device__ __forceinline__ float finish(const float* marg, size_t o, float kv) {
  if constexpr (kDivide) {
    return __fdiv_rn(marg[o], kv);
  } else {
    return kv;
  }
}

// Row j of out, computed by the whole warp: marg[j] / (xi[j] . t) or
// xi[j] . t, for every column of t.
template <typename T, bool kDivide>
__device__ __forceinline__ void row_dot(
    const T* __restrict__ xi, const float* t_sh,
    const float* __restrict__ marg, float* __restrict__ out, int j, int r,
    int B, int vec, int lane) {
  constexpr int V = kVec<T>;
  if (vec) {
    const int rv = r / V;
    const uint4* row = reinterpret_cast<const uint4*>(xi) + (size_t)j * rv;
    float acc = 0.0f;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < rv; k += 32 * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int p = 0; p < kUnroll; ++p) raw[p] = __ldg(row + k + 32 * p);
#pragma unroll
      for (int p = 0; p < kUnroll; ++p) {
        float w[V], tv[V];
        unpack16(raw[p], w);
        load_floats(t_sh + (size_t)V * (k + 32 * p), tv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = fmaf(w[e], tv[e], acc);
      }
    }
    for (; k < rv; k += 32) {
      float w[V], tv[V];
      unpack16(__ldg(row + k), w);
      load_floats(t_sh + (size_t)V * k, tv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc = fmaf(w[e], tv[e], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[j] = finish<kDivide>(marg, j, acc);
    return;
  }
  const T* row = xi + (size_t)j * r;
  for (int c0 = 0; c0 < B; c0 += kMaxCols) {
    const int nc = min(kMaxCols, B - c0);
    float acc[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < r; k += 32 * kUnroll) {
      float w[kUnroll];
#pragma unroll
      for (int p = 0; p < kUnroll; ++p) w[p] = load_factor(row + k + 32 * p);
#pragma unroll
      for (int p = 0; p < kUnroll; ++p) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < nc) acc[c] = fmaf(w[p], t_sh[(k + 32 * p) * B + c0 + c], acc[c]);
      }
    }
    for (; k < r; k += 32) {
      const float w = load_factor(row + k);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < nc) acc[c] = fmaf(w, t_sh[k * B + c0 + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < nc) acc[c] = warp_sum(acc[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < nc) {
          const size_t o = (size_t)j * B + c0 + c;
          out[o] = finish<kDivide>(marg, o, acc[c]);
        }
    }
  }
}

// The row kernels' dynamic shared memory for t, opted in above 48 KiB.
template <typename Kernel>
int reserve_t_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace feature_ops
