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
// reduced by a fixed shuffle tree. The accumulation loops, the combine and
// the row dot product are in feature_ops.cuh, shared with paged.cu. The divide is IEEE float32
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
#include "feature_ops.cuh"

namespace {

using namespace feature_ops;

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
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
  contract_rows(xi, u, u_sh, acc, k, r, B, c0, nc, i_begin,
                min(n, i_begin + rows_per_split));
  contract_store(partial, acc, split, k, r, B, c0, nc);
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
  const int split = blockIdx.y;
  const int i_begin = split * rows_per_split;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  contract_rows_vec(xi, u, u_sh, acc, q, r / V, i_begin,
                    min(n, i_begin + rows_per_split));
  contract_store_vec(partial, acc, split, q, r, r / V);
}

__global__ void __launch_bounds__(kCombineWarps * 32)
feature_contract_combine_kernel(const float* __restrict__ partial,
                                float* __restrict__ t, int n_splits,
                                int size) {
  contract_combine(partial, t, n_splits, size);
}

template <typename T, bool kDivide>
__global__ void __launch_bounds__(kRowWarps * 32)
feature_rows_kernel(const T* __restrict__ xi, const float* __restrict__ t,
                    const float* __restrict__ marg, float* __restrict__ out,
                    int n, int r, int B, int vec) {
  extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  stage_t(t, t_sh, r * B);
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * kRowWarps + (threadIdx.x >> 5); j < n;
       j += gridDim.x * kRowWarps)
    row_dot<T, kDivide>(xi, t_sh, marg, out, j, r, B, vec, lane);
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
  const int err = reserve_t_smem(feature_rows_kernel<T, kDivide>, smem);
  if (err != 0) return err;
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
