// Fused Gaussian positive-feature map (Lemma 1), log or linear epilogue.
//
// Replaces the TPU kernel src/repro/kernels/feature_map.py
// (gaussian_feature_map_kernel, launched by _feature_map_impl):
//
//   log Xi[i, k] = u2c[k] - 2/eps * x2[i] + 4/eps * <x_i, u_k>
//   Xi[i, k]     = exp(log Xi[i, k])                (log_space == 0)
//
// with x2[i] = ||x_i||^2 and u2c[k] = log_const[k] - 2/eps ||u_k||^2. The
// TPU wrapper precomputes both; here the kernel forms them itself, which
// saves the six small PyTorch kernels that computed them before.
//
// Bound on the H100: the (n, r) f32 output. At n = 16384, r = 1024 that is
// 64 MiB written against 268 MFLOP of dot products, so the kernel is bound
// by bytes (about 20 us at 3.35 TB/s); what it has to do is keep enough
// wide stores in flight and start storing soon. The design:
//
// * A persistent grid of about one wave (the SM count times the occupancy
//   the runtime reports, planned by kernels/feature_map.py:_map_plan). CTA
//   b owns column tile b % col_tiles for its whole life and walks the row
//   tiles b / col_tiles, + row_ctas, ... There is no gridDim.y, so any n
//   runs. A tile is up to 128 columns wide: a CTA stages its tile's
//   anchors in one pass (wider tiles, up to whole 1024-column rows, took
//   several passes and measured slower at the solve shape).
// * Each thread owns 4 consecutive columns of its tile. Their anchors are
//   loaded once: for d <= 16 into registers (the register budget: 64
//   floats a thread), through shared memory with coalesced loads (a
//   thread's own 4d floats read straight from global memory touch one
//   cache line per lane per load, which measured slower than the whole
//   64 MiB of stores);
//   for d > 16 into shared memory (the "wide" kernel, bound by operations
//   from d ~ 40 on).
// * The rows of x of the next row tile are staged with cp.async into a
//   second shared buffer while the current tile's stores drain; x2 is
//   formed once per row of a tile.
// * Every thread writes its 4 columns of a row as one 16-byte store; rows
//   of a size that is not a multiple of 16 bytes are written with scalar
//   stores. stream != 0 marks the stores evict-first (__stcs); the planner
//   sets it only where the output is larger than the L2, so a factor that
//   the contract reads next stays in the L2 (timed both ways in
//   chip_smoke.py phase 3).
//
// Precision: the 4/eps factor multiplies any error in the dot product (x40
// at eps = 0.1), so the dot is true FP32 FMA on the CUDA cores, summed in
// the order k = 0 .. d-1, and the epilogue is evaluated with explicit
// round-to-nearest operations in the order written above (no contraction
// into FMA), the order the plain PyTorch version uses; expf, not __expf; no
// tensor cores. x2 and ||u_k||^2 are summed in the order of the plain
// version's torch.sum (torch_order_sum). An anchor with log_const = -inf
// gives exactly -inf (linear: exactly 0).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 256;   // rows of a tile
constexpr int kMaxReps = 4;         // rows of a tile per thread
constexpr int kMaxCols4 = 32;       // 4-column groups of a tile: 128 columns

struct MapArgs {
  const float* x;          // (n, d)
  const float* anchors;    // (r, d)
  const float* log_const;  // (r,)
  float* out;              // (n, r)
  int n, r, d;
  int cols4;               // 4-column groups of a tile (a power of 2 <= 32)
  int reps;                // rows per thread per tile
  int col_tiles, row_tiles, row_ctas;
  float two_inv_eps, four_inv_eps;
  int log_space, vec_store, stream, anchors_in_smem;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// f(0) + f(1) + ... + f(d - 1) for f >= 0 (squares), in the order
// PyTorch's CUDA sum over the last dimension of a contiguous (rows, d)
// float tensor takes (ATen's Reduce.cuh, for d < 64): W = the largest
// power of two <= d lanes, lane t holding f(t) + f(t + W), then a
// shuffle-down tree over the lanes at offsets W/2, W/4, ..., 1. The plain
// version forms x2 and ||u_k||^2 with torch.sum, so the kernel's norms are
// bit-identical to its own (chip_smoke.py phase 2 holds them to it). From
// d = 64 on the order is a close stand-in (lanes keep four accumulators;
// ATen may widen its lanes), within float32 rounding of the plain sum.
// kLong: d may reach 2W (only past d = 63); the register kernels leave it
// out, since their d < 2W always.
template <int kMaxW, bool kLong, typename F>
__device__ __forceinline__ float torch_order_sum(F f, int d) {
  int W = 1;
  while (W * 2 <= d && W < kMaxW) W *= 2;
  float s[kMaxW];
#pragma unroll
  for (int t = 0; t < kMaxW; ++t) {
    if (t >= W) break;
    if (!kLong || d < 2 * W) {
      s[t] = t + W < d ? __fadd_rn(f(t), f(t + W)) : f(t);
      continue;
    }
    float acc[4];
    int idx = t, used = 0;
    for (; idx + 3 * W < d; idx += 4 * W) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = used ? __fadd_rn(acc[i], f(idx + i * W)) : f(idx + i * W);
      used = 4;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (idx + i * W < d)
        acc[i] = i < used ? __fadd_rn(acc[i], f(idx + i * W)) : f(idx + i * W);
    const int touched = max(used, min(4, (d - idx + W - 1) / W));
    float v = acc[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (i < touched) v = __fadd_rn(v, acc[i]);
    s[t] = v;
  }
#pragma unroll
  for (int off = kMaxW / 2; off > 0; off >>= 1) {
    if (off >= W) continue;
#pragma unroll
    for (int t = 0; t < off; ++t) s[t] = __fadd_rn(s[t], s[t + off]);
  }
  return s[0];
}

// u2c[j] from ||u_j||^2 (0 past r, where nothing is stored).
__device__ __forceinline__ float column_const(const MapArgs& a, int j,
                                              float u2) {
  return j < a.r ? __fsub_rn(__ldg(a.log_const + j),
                             __fmul_rn(a.two_inv_eps, u2))
                 : 0.0f;
}

// log Xi (or Xi) for one row of 4 columns, then its store.
__device__ __forceinline__ void finish_row(const MapArgs& a, const float (&c)[4],
                                           const float (&dot)[4], float x2,
                                           int i, int j0) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = __fadd_rn(__fsub_rn(c[q], __fmul_rn(a.two_inv_eps, x2)),
                     __fmul_rn(a.four_inv_eps, dot[q]));
    if (!a.log_space) v[q] = expf(v[q]);
  }
  float* o = a.out + (size_t)i * a.r + j0;
  if (a.vec_store) {            // r % 4 == 0: j0 < r means all 4 are in
    if (j0 >= a.r) return;
    const float4 w = make_float4(v[0], v[1], v[2], v[3]);
    if (a.stream)
      __stcs(reinterpret_cast<float4*>(o), w);
    else
      *reinterpret_cast<float4*>(o) = w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (j0 + q < a.r) {
      if (a.stream)
        __stcs(o + q, v[q]);
      else
        o[q] = v[q];
    }
}

// Register kernel, d <= KD: the thread's anchors live in registers. A
// thread computes its reps rows of a tile side by side (k outer, rows
// inner), so independent FMA chains hide each other's latency.
template <int KD>
__global__ void __launch_bounds__(kThreads, KD <= 8 ? 3 : 2)
feature_map_reg_kernel(const MapArgs a) {
  constexpr int kStride = 4 * KD + 1;          // padded floats a column group
  __shared__ float xs[2][kMaxTileRows * KD];
  __shared__ float x2s[2][kMaxTileRows];
  __shared__ float us[kMaxCols4 * kStride];

  const int tid = threadIdx.x;
  const int d = a.d;
  const int ct = blockIdx.x % a.col_tiles;
  const int rc = blockIdx.x / a.col_tiles;
  const int cg = tid & (a.cols4 - 1);
  const int rr = tid / a.cols4;                // the thread's row in a pass
  const int rpp = kThreads / a.cols4;          // rows per pass
  const int tile_rows = rpp * a.reps;
  const int j0 = (ct * a.cols4 + cg) * 4;

  auto stage = [&](int t, int buf) {
    const int row0 = t * tile_rows;
    const int rows = min(tile_rows, a.n - row0);
    const float* src = a.x + (size_t)row0 * d;
    for (int e = tid; e < rows * d; e += kThreads)
      cp_async4(&xs[buf][e], src + e);
  };
  int t = rc;
  stage(t, 0);                 // in flight while the anchors load
  cp_async_commit();

  // The thread's anchors, u[k][q] = anchors[j0 + q, k]. The CTA's columns
  // are one contiguous run of the (r, d) anchors, read with coalesced
  // loads into shared memory at a padded stride of 4d + 1 floats a column
  // group (conflict-free reads); a thread then takes its 4d floats.
  float u[KD][4], c[4];
  {
    const int col0 = ct * a.cols4 * 4;
    const int cols = min(4 * a.cols4, a.r - col0);
    const float* src = a.anchors + (size_t)col0 * d;
    for (int e = tid; e < cols * d; e += kThreads) {
      const int grp = e / (4 * d);
      us[grp * (4 * d + 1) + (e - grp * 4 * d)] = __ldg(src + e);
    }
    __syncthreads();
    const float* mine = us + cg * (4 * d + 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < KD; ++k)
        u[k][q] = (j0 + q < a.r && k < d) ? mine[q * d + k] : 0.0f;
      c[q] = column_const(a, j0 + q, torch_order_sum<KD, false>(
          [&](int k) { return __fmul_rn(mine[q * d + k], mine[q * d + k]); },
          d));
    }
  }

  for (int it = 0; t < a.row_tiles; t += a.row_ctas, ++it) {
    const int buf = it & 1;
    if (t + a.row_ctas < a.row_tiles) stage(t + a.row_ctas, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();           // tile t is staged; tile t - 1 is finished
    if (tid < tile_rows) {     // x2, once per row of the tile
      const float* xr = &xs[buf][tid * d];
      x2s[buf][tid] = torch_order_sum<KD, false>(
          [&](int k) { return __fmul_rn(xr[k], xr[k]); }, d);
    }
    float dot[kMaxReps][4];
#pragma unroll
    for (int p = 0; p < kMaxReps; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) dot[p][q] = 0.0f;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (k >= d) break;
#pragma unroll
      for (int p = 0; p < kMaxReps; ++p) {
        // rows past n compute on stale stage data and are not stored; rows
        // past reps reread row 0 of the pass
        const float xv = xs[buf][(rr + (p < a.reps ? p : 0) * rpp) * d + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) dot[p][q] = fmaf(xv, u[k][q], dot[p][q]);
      }
    }
    __syncthreads();           // x2 of the tile is in; xs[buf] is free
#pragma unroll
    for (int p = 0; p < kMaxReps; ++p) {
      const int i = t * tile_rows + rr + p * rpp;
      if (p >= a.reps || i >= a.n) break;
      finish_row(a, c, dot[p], x2s[buf][rr + p * rpp], i, j0);
    }
  }
}

// Wide kernel, d > 16: the tile's anchors in shared memory, k-major
// (us[k * 4 * cols4 + column]), loaded once; x read through L1. Past the
// shared-memory budget (anchors_in_smem == 0) the anchors are read through
// L1 as well.
__global__ void __launch_bounds__(kThreads)
feature_map_wide_kernel(const MapArgs a) {
  extern __shared__ float us[];
  const int tid = threadIdx.x;
  const int d = a.d;
  const int ct = blockIdx.x % a.col_tiles;
  const int rc = blockIdx.x / a.col_tiles;
  const int cg = tid & (a.cols4 - 1);
  const int rr = tid / a.cols4;
  const int rpp = kThreads / a.cols4;
  const int tile_rows = rpp * a.reps;
  const int tile_cols = 4 * a.cols4;
  const int col0 = ct * tile_cols;
  const int j0 = col0 + 4 * cg;

  if (a.anchors_in_smem) {
    const int cols = min(tile_cols, a.r - col0);
    for (int e = tid; e < tile_cols * d; e += kThreads) {
      const int jj = e / d, k = e - jj * d;    // coalesced global reads
      us[k * tile_cols + jj] =
          jj < cols ? __ldg(a.anchors + (size_t)col0 * d + e) : 0.0f;
    }
    __syncthreads();
  }
  auto at = [&](int k, int q) -> float {
    if (a.anchors_in_smem) return us[k * tile_cols + 4 * cg + q];
    const int j = min(j0 + q, a.r - 1);
    return __ldg(a.anchors + (size_t)j * d + k);
  };
  float c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c[q] = column_const(a, j0 + q, torch_order_sum<32, true>([&](int k) {
      const float w = at(k, q);
      return __fmul_rn(w, w);
    }, d));

  for (int t = rc; t < a.row_tiles; t += a.row_ctas) {
    const int row0 = t * tile_rows;
    for (int p = 0; p < a.reps; ++p) {
      const int i = row0 + rr + p * rpp;
      if (i >= a.n) break;
      const float* xr = a.x + (size_t)i * d;
      float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < d; ++k) {
        const float xv = __ldg(xr + k);
        if (a.anchors_in_smem) {
          const float4 w = *reinterpret_cast<const float4*>(
              &us[k * tile_cols + 4 * cg]);
          dot[0] = fmaf(xv, w.x, dot[0]);
          dot[1] = fmaf(xv, w.y, dot[1]);
          dot[2] = fmaf(xv, w.z, dot[2]);
          dot[3] = fmaf(xv, w.w, dot[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) dot[q] = fmaf(xv, at(k, q), dot[q]);
        }
      }
      const float x2 = torch_order_sum<32, true>([&](int k) {
        const float xv = __ldg(xr + k);
        return __fmul_rn(xv, xv);
      }, d);
      finish_row(a, c, dot, x2, i, j0);
    }
  }
}

// kernel: 0, 1, 2 = the register kernel at KD = 4, 8, 16; 3 = the wide one.
template <typename F>
int with_kernel(int kernel, F f) {
  switch (kernel) {
    case 0: return f(feature_map_reg_kernel<4>);
    case 1: return f(feature_map_reg_kernel<8>);
    case 2: return f(feature_map_reg_kernel<16>);
    case 3: return f(feature_map_wide_kernel);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// CTAs of `kernel` resident on one SM with `smem` bytes of dynamic shared
// memory (the planner's wave), or a negative CUDA error code.
REPRO_EXPORT int gaussian_feature_map_occupancy(int kernel, int smem) {
  return with_kernel(kernel, [&](auto fn) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return -static_cast<int>(e);
    }
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, kThreads, smem);
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  });
}

// The launch geometry (kernel, cols4, reps, col_tiles, row_tiles,
// row_ctas, smem, anchors_in_smem) comes from kernels/feature_map.py:
// _map_plan; the grid is col_tiles * row_ctas CTAs.
REPRO_EXPORT int gaussian_feature_map_launch(
    const float* x, const float* anchors, const float* log_const, float* out,
    int n, int r, int d, int kernel, int cols4, int reps, int col_tiles,
    int row_tiles, int row_ctas, int smem, int anchors_in_smem,
    float two_inv_eps, float four_inv_eps, int log_space, int vec_store,
    int stream_store, cudaStream_t stream) {
  if (cols4 < 1 || cols4 > kMaxCols4 || (cols4 & (cols4 - 1)) || reps < 1 ||
      reps > kMaxReps || (kThreads / cols4) * reps > kMaxTileRows ||
      (vec_store && r % 4) || (kernel < 3 && d > (4 << kernel)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MapArgs a{x, anchors, log_const, out, n, r, d, cols4, reps,
                  col_tiles, row_tiles, row_ctas, two_inv_eps, four_inv_eps,
                  log_space, vec_store, stream_store, anchors_in_smem};
  return with_kernel(kernel, [&](auto fn) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fn<<<col_tiles * row_ctas, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}
