// Scaling-space factored Sinkhorn operators: the feature contract, the
// fused half-step and the feature matvec.
//
// feature_contract replaces the TPU kernels in src/repro/kernels/
// kermatvec.py, _feature_contract_kernel and its split-k twin
// _feature_contract_splitk_kernel (launched by _feature_contract_impl /
// _feature_contract_splitk_impl):
//
//   t[k, c] = sum_i xi[i, k] * u[i, c]              (n, r), (n, B) -> (r, B)
//
// The TPU reduces n on a sequential grid axis into a revisited output
// block. CTAs on Hopper run in no order, so the reduction is split: each
// CTA owns a slab of rows and a tile of r and writes its partial sums to a
// (n_splits, r, B) scratch buffer; a second small launch adds the partials
// in the order split = 0, 1, ... (one warp per output, a fixed lane
// assignment and shuffle tree). No atomics, so a rerun is bit-identical.
//
// sinkhorn_halfstep replaces _halfstep_kernel and feature_matvec replaces
// _matvec_kernel (both launched by _matvec_like_call):
//
//   out[j, c] = marg[j, c] / sum_k xi[j, k] * t[k, c]    (the half-step)
//   out[j, c] =              sum_k xi[j, k] * t[k, c]    (the matvec)
//
// one row kernel with a compile-time flag for the divide; one warp per
// row, t staged once per CTA in shared memory, each row's dot product
// reduced by a fixed shuffle tree. The divide is IEEE float32
// (__fdiv_rn): a zero-weight atom on a positive row gives exactly 0, an
// all-zero row gives inf, or NaN where marg is 0, as float32 does. Rows are
// not padded: bounds checks replace the JAX package's pad-with-1 rows.
//
// The factor xi is stored as float or as bfloat16 (precision="bf16", half
// the bytes); each kernel is a template on that storage type T, widens
// every element to float on load and accumulates with float FMAs. No
// tensor cores: the reference accumulates in true float32 (compute_f32).
//
// Bound on the H100: every launch reads the (n, r) factor once, 64 MiB in
// float at n = 16384, r = 1024, more than the 50 MB L2, so it streams from
// device memory (about 20 us at 3.35 TB/s; half that in bf16). Two flops
// an entry (33.6 M) are far below the float32 rate, so all three are bound
// by bytes. Loads are coalesced along r and many are kept in flight per
// thread: with B = 1, rows of a multiple of 16 bytes and a 16-byte aligned
// factor, the kernels read 16-byte vectors (4 floats or 8 bf16), eight per
// thread at a time; other shapes take a scalar path with the same
// arithmetic. The contract's wrapper takes the scalar path, one column a
// thread, also where a row's vectors do not fill a CTA (r < 512 in float,
// r < 1024 in bf16). Any B runs: the scalar paths take the columns in
// chunks of kMaxCols.
#include "common.cuh"

namespace {

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

// Scalar path: thread k owns column k of xi and the columns
// c0 .. c0 + nc - 1 of u (c0 = kMaxCols * blockIdx.z).
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
feature_contract_partial_kernel(const T* __restrict__ xi,
                                const float* __restrict__ u,
                                float* __restrict__ partial, int n, int r,
                                int B, int rows_per_split) {
  __shared__ float u_sh[kContractChunk * kMaxCols];
  const int k = blockIdx.x * kContractThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * kMaxCols;
  const int nc = min(kMaxCols, B - c0);
  const int i_begin = split * rows_per_split;
  const int i_end = min(n, i_begin + rows_per_split);

  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;

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

  if (k >= r) return;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (c < nc) partial[((size_t)split * r + k) * B + c0 + c] = acc[c];
}

// Vector path (B == 1, rows of a multiple of 16 bytes, aligned): thread q
// owns the V = kVec<T> columns V*q .. V*q + V-1 and reads them as one
// 16-byte vector per row.
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
feature_contract_partial_vec_kernel(const T* __restrict__ xi,
                                    const float* __restrict__ u,
                                    float* __restrict__ partial, int n, int r,
                                    int rows_per_split) {
  constexpr int V = kVec<T>;
  __shared__ float u_sh[kContractChunk];
  const int q = blockIdx.x * kContractThreads + threadIdx.x;
  const int rv = r / V;
  const int split = blockIdx.y;
  const int i_begin = split * rows_per_split;
  const int i_end = min(n, i_begin + rows_per_split);
  const uint4* xv = reinterpret_cast<const uint4*>(xi);

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;

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

  if (q >= rv) return;
  float* out = partial + (size_t)split * r + (size_t)V * q;
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(out + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
}

// Sum over the split axis of the partials, one warp per output: lane l
// adds splits l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kCombineWarps * 32)
feature_contract_combine_kernel(const float* __restrict__ partial,
                                float* __restrict__ t, int n_splits,
                                int size) {
  const int e = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= size) return;
  float acc = 0.0f;
  for (int p = lane; p < n_splits; p += 32) acc += partial[(size_t)p * size + e];
  acc = warp_sum(acc);
  if (lane == 0) t[e] = acc;
}

template <bool kDivide>
__device__ __forceinline__ float finish(const float* marg, size_t o, float kv) {
  if constexpr (kDivide) {
    return __fdiv_rn(marg[o], kv);
  } else {
    return kv;
  }
}

// One warp per row. Vector path when B == 1 and rows are 16-byte vectors
// (vec != 0): lane l reads vectors l, l + 32, ... of the row. Scalar path:
// lane l reads elements l, l + 32, ... for kMaxCols columns of t at a time.
template <typename T, bool kDivide>
__global__ void __launch_bounds__(kRowWarps * 32)
feature_rows_kernel(const T* __restrict__ xi, const float* __restrict__ t,
                    const float* __restrict__ marg, float* __restrict__ out,
                    int n, int r, int B, int vec) {
  constexpr int V = kVec<T>;
  extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  for (int e = threadIdx.x; e < r * B; e += kRowWarps * 32) t_sh[e] = t[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x * kRowWarps + warp; j < n;
       j += gridDim.x * kRowWarps) {
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
      continue;
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
}

template <typename T>
int contract_launch(const T* xi, const float* u, float* partial, float* t,
                    int n, int r, int B, int n_splits, int rows_per_split,
                    int vec, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  if (vec && (B != 1 || r % V != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = vec ? V * kContractThreads : kContractThreads;
  if (vec) {
    const dim3 grid((r + cols - 1) / cols, n_splits);
    feature_contract_partial_vec_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        xi, u, partial, n, r, rows_per_split);
  } else {
    const dim3 grid((r + cols - 1) / cols, n_splits,
                    (B + kMaxCols - 1) / kMaxCols);
    feature_contract_partial_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        xi, u, partial, n, r, B, rows_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = r * B;
  feature_contract_combine_kernel<<<(size + kCombineWarps - 1) / kCombineWarps,
                                    kCombineWarps * 32, 0, stream>>>(
      partial, t, n_splits, size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDivide>
int rows_launch(const T* xi, const float* t, const float* marg, float* out,
                int n, int r, int B, int vec, int grid, cudaStream_t stream) {
  if (vec && (B != 1 || r % kVec<T> != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)r * B * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        feature_rows_kernel<T, kDivide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  feature_rows_kernel<T, kDivide><<<grid, kRowWarps * 32, smem, stream>>>(
      xi, t, marg, out, n, r, B, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi is float (bf16 == 0) or bfloat16 (bf16 != 0). vec != 0 selects the
// 16-byte vector path; the caller passes it only for B == 1, rows of a
// multiple of 16 bytes and a 16-byte aligned xi. Columns per CTA:
// 128 * (16 / element size) on the vector path, 128 on the scalar path.
REPRO_EXPORT int feature_contract_launch(const void* xi, int bf16,
                                         const float* u, float* partial,
                                         float* t, int n, int r, int B,
                                         int n_splits, int rows_per_split,
                                         int vec, cudaStream_t stream) {
  if (bf16)
    return contract_launch(static_cast<const __nv_bfloat16*>(xi), u, partial,
                           t, n, r, B, n_splits, rows_per_split, vec, stream);
  return contract_launch(static_cast<const float*>(xi), u, partial, t, n, r,
                         B, n_splits, rows_per_split, vec, stream);
}

REPRO_EXPORT int sinkhorn_halfstep_launch(const void* xi, int bf16,
                                          const float* t, const float* marg,
                                          float* out, int n, int r, int B,
                                          int vec, int grid,
                                          cudaStream_t stream) {
  if (bf16)
    return rows_launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(xi), t, marg, out, n, r, B, vec,
        grid, stream);
  return rows_launch<float, true>(static_cast<const float*>(xi), t, marg, out,
                                  n, r, B, vec, grid, stream);
}

REPRO_EXPORT int feature_matvec_launch(const void* xi, int bf16,
                                       const float* t, float* out, int n,
                                       int r, int B, int vec, int grid,
                                       cudaStream_t stream) {
  if (bf16)
    return rows_launch<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(xi), t, nullptr, out, n, r, B, vec,
        grid, stream);
  return rows_launch<float, false>(static_cast<const float*>(xi), t, nullptr,
                                   out, n, r, B, vec, grid, stream);
}
