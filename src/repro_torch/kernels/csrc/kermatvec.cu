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
// partial to a (splits, r, B) buffer; after a grid barrier every CTA adds
// a slice of the outputs over the splits, in a fixed order (grid_combine).
// The launch is cooperative, so the runtime refuses a grid that cannot be
// resident at once instead of letting the barrier hang. Adding the
// partials by the last CTA to finish (an integer ticket) left one SM
// reading all of them after the last slab, 5-6 us at the solve shape;
// spread over the grid the adds take one L2 round trip. No atomics, and
// every sum has a fixed order, so a rerun is bit-identical whichever CTA
// finishes last.
//
// Inside a CTA the threads form row groups of `tile` threads: with B = 1
// and 16-byte rows, `tile` = r / V vectors of V = 16 / sizeof(T) columns
// (one 16-byte load a row per thread, 128 bytes in flight); otherwise one
// column a thread and kMaxCols columns of u at a time (the scalar path,
// any B, in chunks on blockIdx.z). Group g takes rows g, g + groups, ...
// of the slab, so a CTA is full at any r (r = 256 in float: 4 groups of
// 64 threads); rows wider than 256 slots tile r across blockIdx.y. Each
// lane reads u[i] itself (a broadcast within its group), and the groups
// are added by a fixed pairwise tree in shared memory. The CTA's loops and
// the combine are in feature_ops.cuh, shared with paged.cu.
//
// sinkhorn_halfstep replaces _halfstep_kernel and feature_matvec replaces
// _matvec_kernel (both launched by _matvec_like_call):
//
//   out[j, c] = marg[j, c] / sum_k xi[j, k] * t[k, c]    (the half-step)
//   out[j, c] =              sum_k xi[j, k] * t[k, c]    (the matvec)
//
// one row kernel with a compile-time flag for the divide, launched as a
// persistent grid of at most one wave (the occupancy the runtime reports;
// kernels/kermatvec.py:_rows_plan). A warp reduces R consecutive rows at a
// time (a batch), and the W warps of the grid take the batches in turn
// (warp w: w, w + W, ...), so together they sweep the factor as one band.
// The planner picks the CTAs an SM (up to the occupancy) that leave the
// fewest warps idle in the last round of batches. On the 16-byte path
// (B = 1, 16-byte rows) with a row of at most 32 * kNV vectors, kNV <= 4
// (float r <= 512, bf16 r <= 1024), a lane holds the kNV vectors of t it
// meets on every row (columns V * (lane + 32 p)) in registers, loaded
// once; a batch of R = 8 / kNV rows issues its 8 loads a lane before the
// first FMA (f32 r = 256: 4 rows of 2 vectors), and the R dot products are
// reduced together: each xor-shuffle step halves the values a lane holds
// (16 lanes apart, then 8, ...) until one is left, then a plain butterfly,
// so lane (32 / R) i ends with row i's sum and the R results leave as one
// coalesced store. Wider rows, B > 1 and unaligned rows keep t in shared
// memory and take a row a warp (row_dot, kNV = 0): at one row a batch
// (kNV = 8), t in registers took 80 registers a thread, fewer CTAs an SM,
// and read 1-2% slower than t in shared memory. Rows are read with plain
// loads unless the caller asks for evict-first ones: a solve contracts
// the same factor right after its row kernel, and with evict-first loads
// an iteration in that order read 5% slower at float r = 1024 and 18% at
// bf16 r = 1024, where the L2 drops those lines first. The half-step's storing lanes load the marginal after the reduction
// (loading it with the rows measured slower at bf16 r = 1024).
// The divide is IEEE float32 (__fdiv_rn): a zero-weight atom on a positive
// row gives exactly 0, an all-zero row gives inf, or NaN where marg is 0,
// as float32 does. Rows are not padded: bounds checks replace the JAX
// package's pad-with-1 rows.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowVectors = 8;        // 16-byte row loads in flight a lane

template <typename T, bool kVecPath>
__global__ void __launch_bounds__(kFlatThreads, 2)
flat_contract_kernel(const ContractArgs a) {
  __shared__ __align__(16) float red[kFlatThreads * 8];
  const ContractThread th = contract_thread<T, kVecPath>(a);
  const int i0 = blockIdx.x * a.rows_per_split;
  const int i1 = min(a.n, i0 + a.rows_per_split);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  if (th.active)
    flat_accumulate<T, kVecPath>(a, static_cast<const T*>(a.xi), acc, th.q,
                                 th.g, th.c0, th.nc, i0, i1);
  contract_partial<T, kVecPath>(a, th, acc, red);
  if (a.splits == 1 || !a.combine) return;   // the same on every CTA
  cooperative_groups::this_grid().sync();
  grid_combine(a, red);
}

struct RowsArgs {
  const void* xi;          // (n, r), T
  const float* t;          // (r, B)
  const float* marg;       // (n, B), the half-step only
  float* out;              // (n, B)
  int n, r, B;
  int vec;                 // 16-byte rows (the shared-memory path's choice)
  int evict_first;         // evict-first loads of xi (ld.global.cs)
};

// A 16-byte load of a row, evict-first or read-only as the launch asks.
// The choice, made at run time, also keeps the R * kNV loads of a batch
// ahead of its first FMA (each load is its own branch): with one load
// instruction the compiler placed each load next to its FMAs, whether
// through __ldg, inline PTX, rows clamped in range or a __syncwarp after
// the loads, and the kernels read 20-29% slower at bf16 r = 1024 on an
// H100 (64 registers a thread instead of 80).
__device__ __forceinline__ uint4 load_row(const uint4* p, int evict_first) {
  return evict_first ? __ldcs(p) : __ldg(p);
}

// The R sums s[0..R) of every lane added over the warp: step o (16, 8, ...)
// keeps the upper half of the values on lanes with bit o set and the lower
// half elsewhere, adding the half the partner lane (lane ^ o) sends, until
// one value is left; a butterfly over the remaining lanes finishes it.
// Returns, on lane l, the sum of row l / (32 / R).
template <int R>
__device__ __forceinline__ float warp_sum_rows(float (&s)[R], int lane) {
#pragma unroll
  for (int c = R, o = 16; c > 1; c >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const float send = upper ? s[i] : s[i + c / 2];
      const float keep = upper ? s[i + c / 2] : s[i];
      s[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float v = s[0];
#pragma unroll
  for (int o = 16 / R; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The batches b0, b0 + step, ... (< b1) of R rows of a warp on the 16-byte
// path with t in registers: kNV vectors of t a lane, loaded once, and
// R * kNV row loads in flight a lane.
template <typename T, bool kDivide, int kNV, int R>
__device__ __forceinline__ void rows_in_registers(const RowsArgs& a, int lane,
                                                  int b0, int b1, int step) {
  constexpr int V = kVec<T>;
  constexpr int kStride = 32 / R;       // lanes between two rows' sums
  const int rv = a.r / V;
  float tr[kNV][V];
#pragma unroll
  for (int p = 0; p < kNV; ++p) {
    const int k = lane + 32 * p;
#pragma unroll
    for (int e = 0; e < V; ++e) tr[p][e] = k < rv ? __ldg(a.t + V * k + e) : 0.0f;
  }
  const uint4* xv = static_cast<const uint4*>(a.xi);
  const bool stores = (lane & (kStride - 1)) == 0;   // lane (32 / R) i: row i
  for (int b = b0; b < b1; b += step) {
    const int j = b * R;
    const int row = j + lane / kStride;
    uint4 raw[R][kNV];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int p = 0; p < kNV; ++p) {
        const int k = lane + 32 * p;
        raw[i][p] = j + i < a.n && k < rv
            ? load_row(xv + (size_t)(j + i) * rv + k, a.evict_first)
            : make_uint4(0, 0, 0, 0);
      }
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < kNV; ++p) {
        float w[V];
        unpack16(raw[i][p], w);
#pragma unroll
        for (int e = 0; e < V; ++e) s[i] = fmaf(w[e], tr[p][e], s[i]);
      }
    }
    const float v = warp_sum_rows<R>(s, lane);
    if (stores && row < a.n) a.out[row] = finish<kDivide>(a.marg, row, v);
  }
}

// kNV > 0: the 16-byte path with t in registers, R rows a batch; kNV = 0:
// t in shared memory, a row a warp (R = 1; any B, any r whose t fits the
// CTA). Warp w of W takes the batches w, w + W, ...
template <typename T, bool kDivide, int kNV, int R>
__global__ void __launch_bounds__(kRowWarps * 32)
feature_rows_kernel(const RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kRowWarps;
  const int warp = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int batches = a.n / R + (a.n % R != 0);
  if constexpr (kNV > 0) {
    rows_in_registers<T, kDivide, kNV, R>(a, lane, warp, batches, warps);
  } else {
    extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
    float* t_sh = reinterpret_cast<float*>(t_sh4);
    stage_t(a.t, t_sh, a.r * a.B);
    for (int j = warp; j < batches; j += warps)
      row_dot<T, kDivide>(static_cast<const T*>(a.xi), t_sh, a.marg, a.out,
                          j, a.r, a.B, a.vec, lane);
  }
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
  if (contract_plan_invalid<T>(a, col_tiles, chunks, vec) ||
      (long long)a.splits * a.rows_per_split < a.n)
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

// The row kernel of (T, kDivide) holding nv vectors of t a lane and
// reducing R = kRowVectors / nv rows a batch (nv = 0, R = 1: t in shared
// memory), or nullptr where there is none: the register path takes
// batches of at least two rows (nv <= 4).
using RowsKernel = void (*)(RowsArgs);

template <typename T, bool kDivide>
RowsKernel rows_kernel(int nv) {
  switch (nv) {
    case 0: return feature_rows_kernel<T, kDivide, 0, 1>;
    case 1: return feature_rows_kernel<T, kDivide, 1, 8>;
    case 2: return feature_rows_kernel<T, kDivide, 2, 4>;
    case 4: return feature_rows_kernel<T, kDivide, 4, 2>;
    default: return nullptr;
  }
}

template <typename T, bool kDivide>
int rows_launch(const RowsArgs& a, int nv, int grid, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  auto kernel = rows_kernel<T, kDivide>(nv);
  if (kernel == nullptr || grid < 1 || a.n < 1 || a.r < 1 || a.B < 1 ||
      (a.vec && (a.B != 1 || a.r % V != 0)) ||
      (nv > 0 && (!a.vec || (a.r / V + 31) / 32 > nv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nv ? 0 : (size_t)a.r * a.B * sizeof(float);
  const int err = reserve_t_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, kRowWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDivide>
int rows_occupancy(int nv, int smem) {
  auto kernel = rows_kernel<T, kDivide>(nv);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int err = reserve_t_smem(kernel, smem);
  if (err != 0) return -err;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kRowWarps * 32, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

template <bool kDivide>
int rows_entry(const void* xi, int bf16, const float* t, const float* marg,
               float* out, int n, int r, int B, int vec, int nv, int grid,
               int evict_first, cudaStream_t stream) {
  const RowsArgs a{xi, t, marg, out, n, r, B, vec, evict_first};
  return bf16 ? rows_launch<__nv_bfloat16, kDivide>(a, nv, grid, stream)
              : rows_launch<float, kDivide>(a, nv, grid, stream);
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

// The row kernels: nv vectors of t a lane in registers (1, 2 or 4; needs
// vec) and 8 / nv rows a batch, or nv = 0 (t in shared
// memory, a row a batch), on `grid` CTAs of kRowWarps warps
// (kernels/kermatvec.py:_rows_plan); evict_first != 0 reads xi with
// evict-first loads on the register path.
REPRO_EXPORT int sinkhorn_halfstep_launch(const void* xi, int bf16,
                                          const float* t, const float* marg,
                                          float* out, int n, int r, int B,
                                          int vec, int nv, int grid,
                                          int evict_first,
                                          cudaStream_t stream) {
  return rows_entry<true>(xi, bf16, t, marg, out, n, r, B, vec, nv, grid,
                          evict_first, stream);
}

REPRO_EXPORT int feature_matvec_launch(const void* xi, int bf16,
                                       const float* t, float* out, int n,
                                       int r, int B, int vec, int nv,
                                       int grid, int evict_first,
                                       cudaStream_t stream) {
  return rows_entry<false>(xi, bf16, t, nullptr, out, n, r, B, vec, nv, grid,
                           evict_first, stream);
}

// Row-kernel CTAs resident on one SM with smem bytes of t (the planner's
// wave), or a negative CUDA error code. The two kernels of a shape (with
// and without the divide) are queried apart.
REPRO_EXPORT int feature_rows_occupancy(int bf16, int divide, int nv,
                                        int smem) {
  if (bf16)
    return divide ? rows_occupancy<__nv_bfloat16, true>(nv, smem)
                  : rows_occupancy<__nv_bfloat16, false>(nv, smem);
  return divide ? rows_occupancy<float, true>(nv, smem)
                : rows_occupancy<float, false>(nv, smem);
}
