// Paged scaling-space operators: the contract, half-step and matvec over a
// fixed-capacity feature buffer carved into pages of page_size rows, with
// a per-page live-slot count page_live (int32, one per page).
//
// paged_contract_partial_kernel / paged_contract_partial_vec_kernel (and
// the combine) replace the TPU kernel _paged_contract_kernel in
// src/repro/kernels/paged.py (launched by _paged_contract_impl):
//
//   t[k, c] = sum over live pages p, rows i of p:  xi[i, k] * u[i, c]
//                                                   (C, r), (C, B) -> (r, B)
//
// The TPU walks the pages on a sequential grid axis, predicated on the
// scalar-prefetched live count, and accumulates into one revisited output
// block. Here, as in kermatvec.cu, each CTA owns a slab of whole pages and
// a tile of r and writes its partial sums to a (n_splits, r, B) scratch
// buffer; a second launch adds the partials in the order split = 0, 1, ...
// (one warp per output, fixed lanes and shuffle tree). No atomics, so a
// rerun is bit-identical. A CTA reads page_live[p] (one int32 load, the
// same address for every thread) and walks only the runs of consecutive
// live pages: the xi and u rows of a dead page are never read, so whatever
// they hold never reaches t. A slab whose pages are all dead writes zeros.
//
// paged_rows_kernel replaces _paged_halfstep_kernel (kDivide) and
// _paged_matvec_kernel (both launched by _paged_rows_call):
//
//   out[j, c] = marg[j, c] / sum_k xi[j, k] * t[k, c]   (the half-step)
//   out[j, c] =              sum_k xi[j, k] * t[k, c]   (the matvec)
//
// on the rows of live pages, and exactly 0 on the rows of dead pages. One
// warp per row, t staged once per CTA in shared memory; the warp reads its
// page's live count first and, on a dead page, writes zeros and reads
// nothing else. On live pages the divide is IEEE float32 (__fdiv_rn): a
// dead slot of a live page has marg = 0 on a positive row and gives 0.
// Rows are not padded: bounds checks replace the JAX package's pads.
//
// xi is stored as float or bfloat16 (precision="bf16"); every kernel is a
// template on that storage type, widens on load and accumulates in float
// FMAs. No tensor cores: the reference accumulates in true float32.
//
// Bound on the H100: each launch reads the live pages of the (C, r) factor
// once: at C = 32768, r = 1024 in float that is 128 MiB with every page
// live (about 40 us at 3.35 TB/s), half and a quarter of it at 50% and 25%
// of pages live. Two flops an entry are far below the float32 rate, so
// all three are bound by the bytes of the live pages. The accumulation
// loops, the combine and the row dot product are kermatvec.cu's, from
// feature_ops.cuh, so the loads are the same: coalesced along r, 16-byte
// vectors (4 floats or 8 bf16) eight at a time per thread where B = 1 and
// rows are 16-byte aligned, a scalar path with the same arithmetic
// otherwise, and the contract's wrapper takes the scalar path also where a
// row's vectors do not fill a CTA (r < 512 in float, r < 1024 in bf16).
#include "feature_ops.cuh"

namespace {

using namespace feature_ops;

// The first live page at or after p (p_end if none) and, in run_end, one
// past the run of consecutive live pages that starts there.
__device__ __forceinline__ int next_live_run(const int* __restrict__ live,
                                             int p, int p_end, int& run_end) {
  while (p < p_end && __ldg(live + p) == 0) ++p;
  int q = p;
  while (q < p_end && __ldg(live + q) != 0) ++q;
  run_end = q;
  return p;
}

// Scalar path: thread k owns column k of xi and the columns
// c0 .. c0 + nc - 1 of u (c0 = kMaxCols * blockIdx.z).
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
paged_contract_partial_kernel(const T* __restrict__ xi,
                              const float* __restrict__ u,
                              const int* __restrict__ page_live,
                              float* __restrict__ partial, int r, int B,
                              int page_size, int n_pages,
                              int pages_per_split) {
  __shared__ float u_sh[kContractChunk * kMaxCols];
  const int k = blockIdx.x * kContractThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * kMaxCols;
  const int nc = min(kMaxCols, B - c0);
  const int p_begin = split * pages_per_split;
  const int p_end = min(n_pages, p_begin + pages_per_split);
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
  int run_end;
  for (int p = next_live_run(page_live, p_begin, p_end, run_end); p < p_end;
       p = next_live_run(page_live, run_end, p_end, run_end))
    contract_rows(xi, u, u_sh, acc, k, r, B, c0, nc, p * page_size,
                  run_end * page_size);
  contract_store(partial, acc, split, k, r, B, c0, nc);
}

// Vector path (B == 1, rows of a multiple of 16 bytes, aligned): thread q
// owns the V = kVec<T> columns V*q .. V*q + V-1 and reads them as one
// 16-byte vector per row.
template <typename T>
__global__ void __launch_bounds__(kContractThreads)
paged_contract_partial_vec_kernel(const T* __restrict__ xi,
                                  const float* __restrict__ u,
                                  const int* __restrict__ page_live,
                                  float* __restrict__ partial, int r,
                                  int page_size, int n_pages,
                                  int pages_per_split) {
  constexpr int V = kVec<T>;
  __shared__ float u_sh[kContractChunk];
  const int q = blockIdx.x * kContractThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int p_begin = split * pages_per_split;
  const int p_end = min(n_pages, p_begin + pages_per_split);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  int run_end;
  for (int p = next_live_run(page_live, p_begin, p_end, run_end); p < p_end;
       p = next_live_run(page_live, run_end, p_end, run_end))
    contract_rows_vec(xi, u, u_sh, acc, q, r / V, p * page_size,
                      run_end * page_size);
  contract_store_vec(partial, acc, split, q, r, r / V);
}

__global__ void __launch_bounds__(kCombineWarps * 32)
paged_contract_combine_kernel(const float* __restrict__ partial,
                              float* __restrict__ t, int n_splits, int size) {
  contract_combine(partial, t, n_splits, size);
}

// One warp per row; a row of a dead page gets exact zeros and reads
// nothing else.
template <typename T, bool kDivide>
__global__ void __launch_bounds__(kRowWarps * 32)
paged_rows_kernel(const T* __restrict__ xi, const float* __restrict__ t,
                  const float* __restrict__ marg,
                  const int* __restrict__ page_live, float* __restrict__ out,
                  int n, int r, int B, int page_size, int vec) {
  extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
  float* t_sh = reinterpret_cast<float*>(t_sh4);
  stage_t(t, t_sh, r * B);
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * kRowWarps + (threadIdx.x >> 5); j < n;
       j += gridDim.x * kRowWarps) {
    if (__ldg(page_live + j / page_size) == 0) {
      for (int c = lane; c < B; c += 32) out[(size_t)j * B + c] = 0.0f;
      continue;
    }
    row_dot<T, kDivide>(xi, t_sh, marg, out, j, r, B, vec, lane);
  }
}

template <typename T>
int contract_launch(const T* xi, const float* u, const int* page_live,
                    float* partial, float* t, int r, int B, int page_size,
                    int n_pages, int n_splits, int pages_per_split, int vec,
                    cudaStream_t stream) {
  constexpr int V = kVec<T>;
  if (vec && (B != 1 || r % V != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = vec ? V * kContractThreads : kContractThreads;
  if (vec) {
    const dim3 grid((r + cols - 1) / cols, n_splits);
    paged_contract_partial_vec_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        xi, u, page_live, partial, r, page_size, n_pages, pages_per_split);
  } else {
    const dim3 grid((r + cols - 1) / cols, n_splits,
                    (B + kMaxCols - 1) / kMaxCols);
    paged_contract_partial_kernel<T><<<grid, kContractThreads, 0, stream>>>(
        xi, u, page_live, partial, r, B, page_size, n_pages, pages_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = r * B;
  paged_contract_combine_kernel<<<(size + kCombineWarps - 1) / kCombineWarps,
                                  kCombineWarps * 32, 0, stream>>>(
      partial, t, n_splits, size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDivide>
int rows_launch(const T* xi, const float* t, const float* marg,
                const int* page_live, float* out, int n, int r, int B,
                int page_size, int vec, int grid, cudaStream_t stream) {
  if (vec && (B != 1 || r % kVec<T> != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)r * B * sizeof(float);
  const int err = reserve_t_smem(paged_rows_kernel<T, kDivide>, smem);
  if (err != 0) return err;
  paged_rows_kernel<T, kDivide><<<grid, kRowWarps * 32, smem, stream>>>(
      xi, t, marg, page_live, out, n, r, B, page_size, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi is float (bf16 == 0) or bfloat16 (bf16 != 0); page_live holds n_pages
// int32 live counts and the buffer has n_pages * page_size rows. vec != 0
// selects the 16-byte vector path; the caller passes it only for B == 1,
// rows of a multiple of 16 bytes and a 16-byte aligned xi. Each of the
// n_splits CTAs along y takes pages_per_split whole pages.
REPRO_EXPORT int paged_feature_contract_launch(
    const void* xi, int bf16, const float* u, const int* page_live,
    float* partial, float* t, int r, int B, int page_size, int n_pages,
    int n_splits, int pages_per_split, int vec, cudaStream_t stream) {
  if (bf16)
    return contract_launch(static_cast<const __nv_bfloat16*>(xi), u,
                           page_live, partial, t, r, B, page_size, n_pages,
                           n_splits, pages_per_split, vec, stream);
  return contract_launch(static_cast<const float*>(xi), u, page_live, partial,
                         t, r, B, page_size, n_pages, n_splits,
                         pages_per_split, vec, stream);
}

REPRO_EXPORT int paged_halfstep_launch(const void* xi, int bf16,
                                       const float* t, const float* marg,
                                       const int* page_live, float* out,
                                       int n, int r, int B, int page_size,
                                       int vec, int grid,
                                       cudaStream_t stream) {
  if (bf16)
    return rows_launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(xi), t, marg, page_live, out, n, r,
        B, page_size, vec, grid, stream);
  return rows_launch<float, true>(static_cast<const float*>(xi), t, marg,
                                  page_live, out, n, r, B, page_size, vec,
                                  grid, stream);
}

REPRO_EXPORT int paged_feature_matvec_launch(const void* xi, int bf16,
                                             const float* t,
                                             const int* page_live, float* out,
                                             int n, int r, int B,
                                             int page_size, int vec, int grid,
                                             cudaStream_t stream) {
  if (bf16)
    return rows_launch<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(xi), t, nullptr, page_live, out, n,
        r, B, page_size, vec, grid, stream);
  return rows_launch<float, false>(static_cast<const float*>(xi), t, nullptr,
                                   page_live, out, n, r, B, page_size, vec,
                                   grid, stream);
}
