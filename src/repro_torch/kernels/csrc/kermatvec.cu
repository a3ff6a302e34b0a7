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
// block. CTAs on Hopper run in no order, so the reduction is split, in one
// launch of at most one wave (the SM count times the occupancy the runtime
// reports; kernels/kermatvec.py:_contract_plan; two CTAs an SM measured
// best): each CTA of 256 threads reduces a slab of rows and writes a
// partial to a
// (splits, r, B) buffer; after a grid barrier every CTA adds a slice of
// the outputs over the splits, in a fixed order (grid_combine). The launch
// is cooperative, so the runtime refuses a grid that cannot be resident at
// once instead of letting the barrier hang. Adding the partials by the
// last CTA to finish (an integer ticket) left one SM reading all of them
// after the last slab, 5-6 us at the solve shape; spread over the grid the
// adds take one L2 round trip. No atomics, and every sum has a fixed
// order, so a rerun is bit-identical whichever CTA finishes last.
//
// Inside a CTA the threads form row groups of `tile` threads: with B = 1
// and 16-byte rows, `tile` = r / V vectors of V = 16 / sizeof(T) columns
// (one 16-byte load a row per thread, 128 bytes in flight); otherwise one
// column a thread and kMaxCols columns of u at a time (the scalar path,
// any B, in chunks on blockIdx.z). Group g takes rows g, g + groups, ...
// of the slab, so a CTA is full at any r (r = 256 in float: 4 groups of
// 64 threads); rows wider than 256 slots tile r across blockIdx.y. Each
// lane reads u[i] itself (a broadcast within its group), and the groups
// are added by a fixed pairwise tree in shared memory.
//
// sinkhorn_halfstep replaces _halfstep_kernel and feature_matvec replaces
// _matvec_kernel (both launched by _matvec_like_call):
//
//   out[j, c] = marg[j, c] / sum_k xi[j, k] * t[k, c]    (the half-step)
//   out[j, c] =              sum_k xi[j, k] * t[k, c]    (the matvec)
//
// one row kernel with a compile-time flag for the divide; one warp per
// row, t staged once per CTA in shared memory, each row's dot product
// reduced by a fixed shuffle tree. The row dot product is in
// feature_ops.cuh, shared with paged.cu. The divide is IEEE float32
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
// factor, the kernels read 16-byte vectors (4 floats or 8 bf16); other
// shapes take a scalar path with the same arithmetic. Any B runs: the
// scalar paths take the columns in chunks of kMaxCols.
#include <cooperative_groups.h>

#include "feature_ops.cuh"

namespace {

using namespace feature_ops;

constexpr int kFlatThreads = 256;     // threads of a flat-contract CTA

struct ContractArgs {
  const void* xi;          // (n, r), T
  const float* u;          // (n, B)
  float* partial;          // (splits, r, B)
  float* t;                // (r, B)
  int n, r, B;
  int splits, rows_per_split;
  int tile, groups;        // threads of a row group; row groups of a CTA
  int combine;             // 0: slabs only, t not formed (phase 3 times it)
};

// The flat contract: one launch, one wave. CTA (split, column tile, column
// chunk) reduces the rows [split * rows_per_split, ...) of its slab. Its
// 256 threads form `groups` row groups of `tile` threads; group g takes
// rows g, g + groups, ... of the slab, each thread one 16-byte vector
// (kVec) or one column (scalar path) of the tile. The groups are added by
// a fixed pairwise tree in shared memory, and the CTA writes its partial
// (or t itself when there is one split).
template <typename T, bool kVecPath>
__device__ __forceinline__ void flat_accumulate(const ContractArgs& a,
                                                const T* __restrict__ xi,
                                                float (&acc)[8], int q, int g,
                                                int c0, int nc, int i0,
                                                int i1) {
  const int G = a.groups;
  const float* __restrict__ u = a.u;
  // U rows of the group a round, all U loads issued before the first FMA;
  // the last round is masked rather than finished one row at a time, so a
  // slab of any length takes ceil(rows / (G * U)) memory round trips.
  if constexpr (kVecPath) {
    constexpr int V = kVec<T>;
    constexpr int U = 64 / V;                 // 256 bytes in flight a thread
    const int rv = a.r / V;
    const uint4* col = reinterpret_cast<const uint4*>(xi) + q;
    for (int i = i0 + g; i < i1; i += G * U) {
      uint4 raw[U];
      float uv[U];
#pragma unroll
      for (int p = 0; p < U; ++p) {
        const int row = i + p * G;
        raw[p] = row < i1 ? __ldg(col + (size_t)row * rv) : make_uint4(0, 0, 0, 0);
        uv[p] = row < i1 ? __ldg(u + row) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < U; ++p) {
        if (i + p * G >= i1) break;
        float w[V];
        unpack16(raw[p], w);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(w[e], uv[p], acc[e]);
      }
    }
  } else if (nc == 1) {         // one column of u: one load and one FMA a row
    constexpr int U = 16;
    const T* col = xi + q;
    const float* uc = u + c0;
    const int B = a.B;
    for (int i = i0 + g; i < i1; i += G * U) {
      float w[U], uv[U];
#pragma unroll
      for (int p = 0; p < U; ++p) {
        const int row = i + p * G;
        w[p] = row < i1 ? load_factor(col + (size_t)row * a.r) : 0.0f;
        uv[p] = row < i1 ? __ldg(uc + (size_t)row * B) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < U; ++p) {
        if (i + p * G >= i1) break;
        acc[0] = fmaf(w[p], uv[p], acc[0]);
      }
    }
  } else {
    constexpr int U = 8;
    const T* col = xi + q;
    const int B = a.B;
    for (int i = i0 + g; i < i1; i += G * U) {
      float w[U];
#pragma unroll
      for (int p = 0; p < U; ++p) {
        const int row = i + p * G;
        w[p] = row < i1 ? load_factor(col + (size_t)row * a.r) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < U; ++p) {
        if (i + p * G >= i1) break;
        const float* ur = u + (size_t)(i + p * G) * B + c0;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < nc) acc[c] = fmaf(w[p], __ldg(ur + c), acc[c]);
      }
    }
  }
}

// Index in t (r, B) of element j of a CTA's tile, or -1 past r.
template <bool kVecPath, int V>
__device__ __forceinline__ int flat_out_index(const ContractArgs& a, int j,
                                              int nc) {
  if constexpr (kVecPath) {
    const int k = blockIdx.y * a.tile * V + j;
    return k < a.r ? k : -1;
  } else {
    const int jq = j / nc;
    const int k = blockIdx.y * a.tile + jq;
    return k < a.r ? k * a.B + blockIdx.z * kMaxCols + (j - jq * nc) : -1;
  }
}

// p[0] + p[stride] + ... + p[(count - 1) * stride], added in that order,
// read from L2 (written by other CTAs of this launch) kChunk loads at a
// time, so a sum of up to kChunk terms costs one L2 round trip.
__device__ __forceinline__ float ordered_sum(const float* p, int count,
                                             size_t stride) {
  constexpr int kChunk = 16;
  float s = 0.0f;
  for (int base = 0; base < count; base += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = base + e < count ? __ldcg(p + (base + e) * stride) : 0.0f;
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (base + e < count) s = __fadd_rn(s, v[e]);
  }
  return s;
}

// After the grid barrier: t = the sum over splits of the partials, every
// CTA adding a slice of the r * B outputs. A slice of w outputs is split
// over parts runs of consecutive splits (parts * w <= the CTA's threads),
// each run summed in split order, and the runs added by a fixed pairwise
// tree in shared memory: the same order on every launch.
__device__ __forceinline__ void grid_combine(const ContractArgs& a,
                                             float* red) {
  constexpr int kT = kFlatThreads;
  const int O = a.r * a.B;
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int w = (O + nblocks - 1) / nblocks;
  const int o0 = b * w;
  if (o0 >= O) return;
  const int wb = min(w, O - o0);
  if (w > kT / 2) {            // wide slices: a thread an output, all splits
    for (int j = threadIdx.x; j < wb; j += kT)
      a.t[o0 + j] = ordered_sum(a.partial + o0 + j, a.splits, O);
    return;
  }
  int parts = 1;
  while (parts * 2 * w <= kT && parts < a.splits) parts *= 2;
  const int len = (a.splits + parts - 1) / parts;
  const int j = threadIdx.x % w, p = threadIdx.x / w;
  if (p < parts) {
    const int first = p * len;
    red[p * w + j] = j < wb && first < a.splits
        ? ordered_sum(a.partial + (size_t)first * O + o0 + j,
                      min(len, a.splits - first), O)
        : 0.0f;
  }
  __syncthreads();
  for (int h = parts / 2; h > 0; h >>= 1) {
    if (p < h) red[p * w + j] = __fadd_rn(red[p * w + j], red[(p + h) * w + j]);
    __syncthreads();
  }
  if (p == 0 && j < wb) a.t[o0 + j] = red[j];
}

template <typename T, bool kVecPath>
__global__ void __launch_bounds__(kFlatThreads, 2)
flat_contract_kernel(const ContractArgs a) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  __shared__ __align__(16) float red[kFlatThreads * 8];
  const int tid = threadIdx.x;
  const int g = tid / a.tile;
  const int ql = tid - g * a.tile;
  const int split = blockIdx.x;
  const int c0 = blockIdx.z * kMaxCols;
  const int nc = kVecPath ? 1 : min(kMaxCols, a.B - c0);
  const int wd = kVecPath ? V : nc;           // elements of a thread's slot
  const int rv = kVecPath ? a.r / V : a.r;
  const int q = blockIdx.y * a.tile + ql;
  const int i0 = split * a.rows_per_split;
  const int i1 = min(a.n, i0 + a.rows_per_split);

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  if (g < a.groups) {
    if (q < rv)
      flat_accumulate<T, kVecPath>(a, static_cast<const T*>(a.xi), acc, q, g,
                                   c0, nc, i0, i1);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < wd) red[tid * wd + e] = acc[e];
  }
  __syncthreads();
  // groups -> group 0: a fixed pairwise tree (stride = the largest power of
  // two below the count), so the order never depends on timing.
  const int elems = a.tile * wd;
  for (int count = a.groups; count > 1;) {
    const int half = 1 << (31 - __clz(count - 1));
    for (int e = tid; e < (count - half) * elems; e += kFlatThreads)
      red[e] += red[e + half * elems];
    count = half;
    __syncthreads();
  }
  const size_t O = (size_t)a.r * a.B;
  float* dst = a.splits == 1 ? a.t : a.partial + split * O;
  for (int j = tid; j < elems; j += kFlatThreads) {
    const int o = flat_out_index<kVecPath, V>(a, j, nc);
    if (o >= 0) dst[o] = red[j];
  }
  if (a.splits == 1 || !a.combine) return;   // the same on every CTA
  cooperative_groups::this_grid().sync();
  grid_combine(a, red);
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

// With one split the CTAs are independent and launch as usual; with more
// they meet at the grid barrier, so the launch is cooperative: it fails
// (and the wrapper raises) rather than start more CTAs than can be
// resident at once.
template <typename T, bool kVecPath>
int flat_launch(const ContractArgs& a, int col_tiles, int chunks,
                cudaStream_t stream) {
  const dim3 grid(a.splits, col_tiles, chunks);
  auto kernel = flat_contract_kernel<T, kVecPath>;
  if (a.splits == 1 || !a.combine) {
    kernel<<<grid, kFlatThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {const_cast<ContractArgs*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(kFlatThreads), args,
      0, stream));
}

template <typename T>
int contract_launch(const ContractArgs& a, int col_tiles, int chunks,
                    int vec, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  const int rv = vec ? a.r / V : a.r;
  if ((vec && (a.B != 1 || a.r % V != 0 || chunks != 1)) || a.tile < 1 ||
      a.groups < 1 || a.groups * a.tile > kFlatThreads ||
      col_tiles * a.tile < rv || chunks * kMaxCols < a.B ||
      a.splits * a.rows_per_split < a.n)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec ? flat_launch<T, true>(a, col_tiles, chunks, stream)
             : flat_launch<T, false>(a, col_tiles, chunks, stream);
}

template <typename T>
int contract_occupancy(int vec) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, vec ? flat_contract_kernel<T, true> : flat_contract_kernel<T, false>,
      kFlatThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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
// 16-byte path; the caller passes it only for B == 1, rows of a multiple
// of 16 bytes and a 16-byte aligned xi. The grid (splits, col_tiles,
// chunks) and the row groups come from kernels/kermatvec.py:_contract_plan;
// partial holds splits * r * B floats (unused with one split). combine == 0
// stops after the partials (t is not formed): chip_smoke.py times the
// slabs apart from the grid barrier and the combine that way.
REPRO_EXPORT int feature_contract_launch(
    const void* xi, int bf16, const float* u, float* partial, float* t,
    int n, int r, int B, int splits, int rows_per_split, int tile, int groups,
    int col_tiles, int chunks, int vec, int combine, cudaStream_t stream) {
  const ContractArgs a{xi, u, partial, t, n, r, B, splits, rows_per_split,
                       tile, groups, combine};
  if (bf16)
    return contract_launch<__nv_bfloat16>(a, col_tiles, chunks, vec, stream);
  return contract_launch<float>(a, col_tiles, chunks, vec, stream);
}

// Flat-contract CTAs resident on one SM (the planner's wave), or a negative
// CUDA error code.
REPRO_EXPORT int feature_contract_occupancy(int bf16, int vec) {
  return bf16 ? contract_occupancy<__nv_bfloat16>(vec)
              : contract_occupancy<float>(vec);
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
