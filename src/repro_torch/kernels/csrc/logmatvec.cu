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
// block. CTAs on Hopper run in no order, so the reduction is split, in one
// launch of at most one wave (the SM count times the occupancy the runtime
// reports; kernels/logmatvec.py:_contract_plan), the flat contract's
// geometry (feature_ops.cuh) carried over to the LSE: CTA (split, column
// tile) reduces a slab of rows, its 256 threads in row groups of `tile`
// threads, group g taking rows g, g + groups, ... (one 16-byte vector a
// thread a row where B = 1 and rows are 16-byte vectors, else one column
// a thread and up to kMaxCols columns of s); each thread keeps a running
// (max, sum) per column, each round of rows an exact two-pass LSE without
// branches (one expf a term, IEEE float32). The
// groups merge by a fixed pairwise tree in shared memory and the CTA
// writes its (max, sum) partial to a (splits, r, B) buffer; after a grid
// barrier every CTA combines a slice of the outputs over the splits with
// an exact LSE (the joint max first, then the sums rescaled to it) in a
// fixed order (log_grid_combine). The launch is cooperative, so the
// runtime refuses a grid that cannot be resident at once rather than let
// the barrier hang. At r = 128 in bf16 a row is 16 vectors, so a CTA takes
// 16 rows at a time; a small factor is cut into few slabs (at least 16
// KiB each), so few CTAs meet at the barrier. No atomics, so a rerun is
// bit-identical.
//
// log_halfstep replaces _log_halfstep_kernel (launched by
// _log_halfstep_impl):
//
//   out[j, c] = scale * ( lmarg[j, c] - LSE_k( log_w[j, k] + t[k, c] ) )
//
// scale = eps gives the potential update and scale = -1 with lmarg = 0
// the raw LSE of the convergence check. It runs as the scaling row
// kernel's persistent grid (kermatvec.cu: feature_rows_kernel) of at most
// one wave, sized by an occupancy query (kernels/logmatvec.py:
// _halfstep_plan): warps take batches of R rows in turn, in order. On the
// 16-byte path (B = 1, 16-byte rows) t sits in registers where a lane
// holds at most 4 vectors of it (float r <= 512, bf16 r <= 1024); a row
// of fewer than 32 vectors is read by L < 32 lanes (bf16 r = 128: 16
// lanes a row, two rows a load), so no lane idles, and a lane keeps up to
// 8 loads in flight. Wider rows, B > 1 and unaligned rows stage t in
// shared memory and take a row a warp. Each row's LSE is the reference's
// (_log_halfstep_kernel) without branches: the exact joint row max by a
// fixed xor-shuffle tree, pinned to 0 where it is not finite
// (_finite_or_zero: an all -inf row gives -inf, never NaN), then the sum
// of expf(x - max), one IEEE expf a term, by the same tree. A row too
// wide for a lane to keep its terms between the two passes (more than 8
// vectors a lane) is taken in rounds, each with its exact joint max, the
// running sum rescaled once a round. A NaN term poisons its row. The rows
// are read with plain loads, never evict-first: a solve contracts the
// same factor next, and finds it in the L2.
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
// bf16), eight per thread at a time (the contract: 256 bytes a thread);
// other shapes take a scalar path with the same arithmetic per entry.
#include <cooperative_groups.h>

#include "feature_ops.cuh"

namespace {

namespace fo = feature_ops;

constexpr int kHalfstepWarps = 8;
constexpr int kUnroll = 8;             // loads in flight per thread

// The thread's running (max, sum) of every column it owns over the rows
// [i0, i1) of its slot, its group taking rows i0 + g, i0 + g + groups,
// ... U rows of the group a round, all U loads issued before any
// arithmetic; the last round is masked (as fo::flat_accumulate). Each
// round is an exact two-pass LSE over its terms without branches: the
// round's max joins the running max m, the running sum is rescaled by
// exp(old max - m) once a column, then every term adds exp(x - m) (one
// expf a term, IEEE float32; with m = -inf the shift is 0 and nothing is
// added). A NaN term poisons the sum.
__device__ __forceinline__ float round_shift(float& mx, float& acc, float rm) {
  const float m = fmaxf(mx, rm);
  const float shift = m == -INFINITY ? 0.0f : m;
  acc *= expf(mx - shift);
  mx = m;
  return shift;
}

template <typename T, bool kVecPath>
__device__ __forceinline__ void log_accumulate(const fo::ContractArgs& a,
                                               const T* __restrict__ w,
                                               float (&mx)[8], float (&acc)[8],
                                               int q, int g, int nc, int i0,
                                               int i1) {
  const int G = a.groups;
  const float* __restrict__ s = a.u;
  if constexpr (kVecPath) {
    constexpr int V = kVec<T>;
    constexpr int U = 64 / V;                 // 256 bytes in flight a thread
    const int rv = a.r / V;
    const uint4* col = reinterpret_cast<const uint4*>(w) + q;
    for (int i = i0 + g; i < i1; i += G * U) {
      uint4 raw[U];
      float sv[U];
#pragma unroll
      for (int p = 0; p < U; ++p) {
        const int row = i + p * G;
        raw[p] = row < i1 ? __ldg(col + (size_t)row * rv) : make_uint4(0, 0, 0, 0);
        sv[p] = row < i1 ? __ldg(s + row) : -INFINITY;
      }
      float rm[V], shift[V];
#pragma unroll
      for (int e = 0; e < V; ++e) rm[e] = -INFINITY;
#pragma unroll
      for (int p = 0; p < U; ++p) {
        float v[V];
        unpack16(raw[p], v);
#pragma unroll
        for (int e = 0; e < V; ++e) rm[e] = fmaxf(rm[e], v[e] + sv[p]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) shift[e] = round_shift(mx[e], acc[e], rm[e]);
#pragma unroll
      for (int p = 0; p < U; ++p) {
        if (i + p * G >= i1) break;
        float v[V];
        unpack16(raw[p], v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += expf(v[e] + sv[p] - shift[e]);
      }
    }
  } else {
    constexpr int U = 8;
    const T* col = w + q;
    const int B = a.B;
    for (int i = i0 + g; i < i1; i += G * U) {
      float v[U];
#pragma unroll
      for (int p = 0; p < U; ++p) {
        const int row = i + p * G;
        v[p] = row < i1 ? load_factor(col + (size_t)row * a.r) : -INFINITY;
      }
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c >= nc) break;
        float x[U], rm = -INFINITY;
#pragma unroll
        for (int p = 0; p < U; ++p) {
          const int row = i + p * G;
          x[p] = row < i1 ? v[p] + __ldg(s + (size_t)row * B + c) : -INFINITY;
          rm = fmaxf(rm, x[p]);
        }
        const float shift = round_shift(mx[c], acc[c], rm);
#pragma unroll
        for (int p = 0; p < U; ++p)
          if (i + p * G < i1) acc[c] += expf(x[p] - shift);
      }
    }
  }
}

// The CTA's partial: the row groups' (max, sum) states merged by a fixed
// pairwise tree in shared memory (stride = the largest power of two below
// the count, as fo::contract_partial adds sums), written as (max, sum) to
// the split's slice of the partials, or as the LSE to t itself when there
// is one split. Every thread of the CTA calls it.
template <typename T, bool kVecPath>
__device__ __forceinline__ void log_contract_partial(
    const fo::ContractArgs& a, const fo::ContractThread& th,
    const float (&mx)[8], const float (&acc)[8], float2* red) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  const int tid = threadIdx.x;
  if (th.g < a.groups) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < th.wd) red[tid * th.wd + e] = make_float2(mx[e], acc[e]);
  }
  __syncthreads();
  const int elems = a.tile * th.wd;
  for (int count = a.groups; count > 1;) {
    const int half = 1 << (31 - __clz(count - 1));
    for (int e = tid; e < (count - half) * elems; e += fo::kFlatThreads) {
      float2 x = red[e];
      const float2 y = red[e + half * elems];
      lse_merge(x.x, x.y, y.x, y.y);
      red[e] = x;
    }
    count = half;
    __syncthreads();
  }
  const size_t O = (size_t)a.r * a.B;
  float2* partial = reinterpret_cast<float2*>(a.partial) + blockIdx.x * O;
  for (int j = tid; j < elems; j += fo::kFlatThreads) {
    const int o = fo::flat_out_index<kVecPath, V>(a, j, th.nc);
    if (o < 0) continue;
    if (a.splits == 1) {
      a.t[o] = lse_value(red[j].x, red[j].y);
    } else {
      partial[o] = red[j];
    }
  }
}

// The LSE shift: the max, or 0 where it is -inf (an all -inf column).
__device__ __forceinline__ float lse_shift(float mx) {
  return mx == -INFINITY ? 0.0f : mx;
}

// The exact LSE of the count (max, sum) partials p[0], p[stride], ... in
// split order: their joint max m (returned through mx), then the sum of
// each sum rescaled to m's shift (0 where m is -inf); a partial whose max
// is -inf drops out. Read from L2 (written by other CTAs of this launch)
// kChunk at a time, once where count <= kChunk.
__device__ __forceinline__ float ordered_lse_sum(const float2* p, int count,
                                                 size_t stride, float shift) {
  constexpr int kChunk = 16;
  float s = 0.0f;
  for (int base = 0; base < count; base += kChunk) {
    float2 v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = base + e < count ? __ldcg(p + (base + e) * stride)
                              : make_float2(-INFINITY, 0.0f);
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (v[e].x != -INFINITY)
        s = __fadd_rn(s, __fmul_rn(v[e].y, expf(v[e].x - shift)));
  }
  return s;
}

__device__ __forceinline__ float ordered_max(const float2* p, int count,
                                             size_t stride) {
  constexpr int kChunk = 16;
  float m = -INFINITY;
  for (int base = 0; base < count; base += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = base + e < count ? __ldcg(&p[(base + e) * stride].x) : -INFINITY;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m = fmaxf(m, v[e]);
  }
  return m;
}

// A run of at most 16 partials, read once into registers.
struct Run {
  float2 v[16];
  __device__ __forceinline__ void load(const float2* p, int count,
                                       size_t stride) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = e < count ? __ldcg(p + e * stride) : make_float2(-INFINITY, 0.0f);
  }
  __device__ __forceinline__ float max() const {
    float m = -INFINITY;
#pragma unroll
    for (int e = 0; e < 16; ++e) m = fmaxf(m, v[e].x);
    return m;
  }
  __device__ __forceinline__ float sum(float shift) const {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (v[e].x != -INFINITY)
        s = __fadd_rn(s, __fmul_rn(v[e].y, expf(v[e].x - shift)));
    return s;
  }
};

// After the grid barrier: t = the exact LSE over splits of the (max, sum)
// partials, every CTA taking a slice of the r * B outputs (the slices of
// fo::grid_combine). A slice of w outputs is split over parts runs of
// consecutive splits; the runs' maxima meet by a fixed tree in shared
// memory, then each run adds its sums rescaled to the joint max in split
// order and the runs' sums meet by a fixed pairwise tree: the same order
// on every launch. A column whose partials are all -inf gives -inf.
__device__ __forceinline__ void log_grid_combine(const fo::ContractArgs& a,
                                                 float2* red) {
  constexpr int kT = fo::kFlatThreads;
  const int O = a.r * a.B;
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int w = (O + nblocks - 1) / nblocks;
  const int o0 = b * w;
  if (o0 >= O) return;
  const int wb = min(w, O - o0);
  const float2* P = reinterpret_cast<const float2*>(a.partial);
  if (w > kT / 2) {            // wide slices: a thread an output, all splits
    for (int j = threadIdx.x; j < wb; j += kT) {
      const float2* p = P + o0 + j;
      const float shift = lse_shift(ordered_max(p, a.splits, O));
      a.t[o0 + j] = shift + logf(ordered_lse_sum(p, a.splits, O, shift));
    }
    return;
  }
  int parts = 1;
  while (parts * 2 * w <= kT && parts < a.splits) parts *= 2;
  const int len = (a.splits + parts - 1) / parts;
  const int j = threadIdx.x % w, p = threadIdx.x / w;
  const int first = p * len;
  const bool mine = p < parts && j < wb && first < a.splits;
  const int count = mine ? min(len, a.splits - first) : 0;
  const float2* src = P + (size_t)first * O + o0 + j;
  const bool held = len <= 16;       // the run stays in registers
  Run run;
  if (held) run.load(src, count, O);
  if (p < parts) red[p * w + j].x = held ? run.max() : ordered_max(src, count, O);
  __syncthreads();
  for (int h = parts / 2; h > 0; h >>= 1) {
    if (p < h) red[p * w + j].x = fmaxf(red[p * w + j].x, red[(p + h) * w + j].x);
    __syncthreads();
  }
  const float shift = lse_shift(red[j].x);
  if (p < parts)
    red[p * w + j].y = held ? run.sum(shift) : ordered_lse_sum(src, count, O, shift);
  __syncthreads();
  for (int h = parts / 2; h > 0; h >>= 1) {
    if (p < h) red[p * w + j].y = __fadd_rn(red[p * w + j].y, red[(p + h) * w + j].y);
    __syncthreads();
  }
  if (p == 0 && j < wb) a.t[o0 + j] = shift + logf(red[j].y);
}

// One launch: CTA (split, column tile, column chunk) reduces its slab in
// row groups; with more than one split the grid meets at a grid barrier
// and combines the partials (the launch is then cooperative).
template <typename T, bool kVecPath>
__global__ void __launch_bounds__(fo::kFlatThreads, 2)
log_contract_kernel(const fo::ContractArgs a) {
  __shared__ __align__(16) float2 red[fo::kFlatThreads * 8];
  const fo::ContractThread th = fo::contract_thread<T, kVecPath>(a);
  const int i0 = blockIdx.x * a.rows_per_split;
  const int i1 = min(a.n, i0 + a.rows_per_split);
  float mx[8], acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mx[e] = -INFINITY;
    acc[e] = 0.0f;
  }
  if (th.active)
    log_accumulate<T, kVecPath>(a, static_cast<const T*>(a.xi), mx, acc,
                                th.q, th.g, th.nc, i0, i1);
  log_contract_partial<T, kVecPath>(a, th, mx, acc, red);
  if (a.splits == 1) return;                 // the same on every CTA
  cooperative_groups::this_grid().sync();
  log_grid_combine(a, red);
}

// ---------------------------------------------------------------------------
// The log half-step: the row kernel's persistent grid
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

struct HalfstepArgs {
  const void* log_w;       // (m, r), T
  const float* t;          // (r, B)
  const float* lmarg;      // (m, B)
  float* out;              // (m, B)
  int m, r, B;
  float scale;
  int vec;                 // 16-byte rows, B = 1
  int lanes;               // L: lanes of a row (the register path)
};

// The LSE shift of a row: its max, or 0 where the max is not finite
// (_finite_or_zero), so an all -inf row sums exp(-inf) = 0 and reads back
// -inf, never NaN.
__device__ __forceinline__ float finite_or_zero(float mx) {
  return isfinite(mx) ? mx : 0.0f;
}

// The max of x over the warp (a fixed xor tree, as fo::warp_sum adds);
// every lane gets it.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// A round of a row's terms joins the row's running (mx, acc), the sum
// shifted by finite_or_zero(mx): rm, the lane's max of the round, becomes
// the warp's (the row's) joint max of the round; the running max moves to
// max(mx, rm) and the running sum is rescaled to its shift once (0 where
// the old max is -inf). Returns the shift the round's terms are taken
// against. With one round this is the reference's exact two-pass LSE.
__device__ __forceinline__ float round_join(float& mx, float& acc, float rm) {
  const float m = fmaxf(mx, warp_max(rm));
  const float shift = finite_or_zero(m);
  acc *= expf(mx - shift);
  mx = m;
  return shift;
}

// The batches b0, b0 + step, ... (< b1) of a warp on the 16-byte path with
// t in registers: kNV vectors of t a lane, loaded once. A row is read by
// L lanes (lane l of group g = lane / L takes vectors l, l + L, ...), so a
// warp holds P = 32 / L rows a load; group g takes rows j + g, j + g + P,
// ..., kQ of them, of the batch of R = P kQ rows at j. All kQ * kNV row
// loads of a lane, and the marginals of the rows it stores, are issued
// before any arithmetic (each its own branch). Each row is the
// reference's exact LSE: its terms x = w + t stay in registers, the joint
// row max comes by the group's xor tree, pinned by finite_or_zero, then
// the sum of expf(x - max) (IEEE float32) by the same tree. Lane l of the
// group stores the rows i with i = l mod L, so the R results leave the
// warp together.
template <typename T, int kNV, int kQ>
__device__ __forceinline__ void halfstep_in_registers(const HalfstepArgs& a,
                                                      int lane, int b0, int b1,
                                                      int step) {
  constexpr int V = kVec<T>;
  const int L = a.lanes, P = 32 / L;
  const int g = lane / L, l = lane & (L - 1);
  const int rv = a.r / V;
  float tr[kNV][V];
#pragma unroll
  for (int p = 0; p < kNV; ++p) {
    const int k = l + L * p;
#pragma unroll
    for (int e = 0; e < V; ++e) tr[p][e] = k < rv ? __ldg(a.t + V * k + e) : -INFINITY;
  }
  const uint4* wv = static_cast<const uint4*>(a.log_w);
  for (int b = b0; b < b1; b += step) {
    const int j = b * P * kQ + g;         // the group's row i: j + i P
    uint4 raw[kQ][kNV];
    float lm[kQ];                         // lmarg of the rows the lane stores
#pragma unroll
    for (int i = 0; i < kQ; ++i)
#pragma unroll
      for (int p = 0; p < kNV; ++p) {
        const int row = j + i * P, k = l + L * p;
        raw[i][p] = row < a.m && k < rv ? __ldg(wv + (size_t)row * rv + k)
                                        : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int row = j + i * P;
      lm[i] = (i & (L - 1)) == l && row < a.m ? __ldg(a.lmarg + row) : 0.0f;
    }
    float x[kQ][kNV][V], mx[kQ], acc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int p = 0; p < kNV; ++p) {
        float w[V];
        unpack16(raw[i][p], w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          x[i][p][e] = w[e] + tr[p][e];
          mx[i] = fmaxf(mx[i], x[i][p][e]);
        }
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], off));
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      mx[i] = finite_or_zero(mx[i]);
      acc[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < kNV; ++p)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i] += expf(x[i][p][e] - mx[i]);
    }
    for (int off = L >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        acc[i] += __shfl_xor_sync(kFull, acc[i], off);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int row = j + i * P;
      if ((i & (L - 1)) == l && row < a.m)
        a.out[row] = a.scale * (lm[i] - (mx[i] + logf(acc[i])));
    }
  }
}

// Row j, by the whole warp, against t in shared memory, in rounds of
// kUnroll loads a lane (all issued before any arithmetic), each round
// joined to the row's running LSE by round_join. 16-byte path (vec, B =
// 1): lane l takes vectors l, l + 32, ...; a round's terms stay in
// registers between its max and its sum, and a row of at most 32 *
// kUnroll vectors (float r <= 1024, bf16 r <= 2048) is one round. Scalar
// path: elements l, l + 32, ... of the row for each of the B columns.
template <typename T>
__device__ __forceinline__ void halfstep_row(const HalfstepArgs& a,
                                             const float* t_sh, int j,
                                             int lane) {
  constexpr int V = kVec<T>;
  if (a.vec) {
    const int rv = a.r / V;
    const uint4* row = static_cast<const uint4*>(a.log_w) + (size_t)j * rv;
    float mx = -INFINITY, acc = 0.0f, lm = 0.0f;
    for (int k0 = lane; k0 - lane < rv; k0 += 32 * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        raw[u] = k0 + 32 * u < rv ? __ldg(row + k0 + 32 * u) : make_uint4(0, 0, 0, 0);
      if (k0 == 0) lm = __ldg(a.lmarg + j);      // lane 0, with the first loads
      float x[kUnroll][V], rm = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + 32 * u;
        float w[V], tv[V];
        unpack16(raw[u], w);
        if (k < rv) {
          load_floats(t_sh + (size_t)V * k, tv);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) tv[e] = -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          x[u][e] = w[e] + tv[e];
          rm = fmaxf(rm, x[u][e]);
        }
      }
      const float shift = round_join(mx, acc, rm);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) acc += expf(x[u][e] - shift);
    }
    acc = fo::warp_sum(acc);
    if (lane == 0) a.out[j] = a.scale * (lm - (finite_or_zero(mx) + logf(acc)));
    return;
  }
  const T* row = static_cast<const T*>(a.log_w) + (size_t)j * a.r;
  const int B = a.B;
  float mx[kMaxCols], acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    mx[c] = -INFINITY;
    acc[c] = 0.0f;
  }
  for (int k0 = lane; k0 - lane < a.r; k0 += 32 * kUnroll) {
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      w[u] = k0 + 32 * u < a.r ? load_factor(row + k0 + 32 * u) : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= B) break;
      float x[kUnroll], rm = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + 32 * u;
        x[u] = k < a.r ? w[u] + t_sh[k * B + c] : -INFINITY;
        rm = fmaxf(rm, x[u]);
      }
      const float shift = round_join(mx[c], acc[c], rm);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[c] += expf(x[u] - shift);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (c < B) acc[c] = fo::warp_sum(acc[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < B) {
        const size_t o = (size_t)j * B + c;
        a.out[o] = a.scale * (a.lmarg[o] - (finite_or_zero(mx[c]) + logf(acc[c])));
      }
  }
}

// kNV > 0: the 16-byte path with t in registers, batches of R = (32 / L)
// kQ rows; kNV = 0: t in shared memory, a row a warp (any B <= kMaxCols,
// any r whose t fits the CTA). Warp w of W takes the batches w, w + W, ...
// (kernels/logmatvec.py:_halfstep_plan).
template <typename T, int kNV, int kQ>
__global__ void __launch_bounds__(fo::kRowWarps * 32)
log_halfstep_kernel(const HalfstepArgs a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * fo::kRowWarps;
  const int warp = blockIdx.x * fo::kRowWarps + (threadIdx.x >> 5);
  if constexpr (kNV > 0) {
    const int R = 32 / a.lanes * kQ;
    halfstep_in_registers<T, kNV, kQ>(a, lane, warp, (a.m + R - 1) / R,
                                      warps);
  } else {
    extern __shared__ float4 t_sh4[];  // (r, B), the layout of t
    float* t_sh = reinterpret_cast<float*>(t_sh4);
    fo::stage_t(a.t, t_sh, a.r * a.B);
    for (int j = warp; j < a.m; j += warps) halfstep_row<T>(a, t_sh, j, lane);
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

// With one split the CTAs write t and launch as usual; with more they
// meet at the grid barrier, so the launch is cooperative: the runtime
// refuses (and the wrapper raises) rather than start more CTAs than can be
// resident at once.
template <typename T, bool kVecPath>
int log_contract_launch_t(const fo::ContractArgs& a, int col_tiles,
                          int chunks, cudaStream_t stream) {
  const dim3 grid(a.splits, col_tiles, chunks);
  auto kernel = log_contract_kernel<T, kVecPath>;
  if (a.splits == 1) {
    kernel<<<grid, fo::kFlatThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {const_cast<fo::ContractArgs*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(fo::kFlatThreads),
      args, 0, stream));
}

template <typename T>
int contract_launch(const fo::ContractArgs& a, int col_tiles, int chunks,
                    int vec, cudaStream_t stream) {
  if (fo::contract_plan_invalid<T>(a, col_tiles, chunks, vec) ||
      a.B > kMaxCols || chunks != 1 ||
      (long long)a.splits * a.rows_per_split < a.n)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec ? log_contract_launch_t<T, true>(a, col_tiles, chunks, stream)
             : log_contract_launch_t<T, false>(a, col_tiles, chunks, stream);
}

template <typename T>
int contract_occupancy(int vec) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, vec ? log_contract_kernel<T, true> : log_contract_kernel<T, false>,
      fo::kFlatThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// The half-step kernel holding nv vectors of t a lane (1, 2 or 4) and
// taking q rows a group a batch (q nv <= kUnroll), or t in shared memory
// (nv = 0, q = 1); nullptr where there is none.
using HalfstepKernel = void (*)(HalfstepArgs);

template <typename T>
HalfstepKernel halfstep_kernel(int nv, int q) {
  switch (nv * 16 + q) {
    case 0 * 16 + 1: return log_halfstep_kernel<T, 0, 1>;
    case 1 * 16 + 1: return log_halfstep_kernel<T, 1, 1>;
    case 1 * 16 + 2: return log_halfstep_kernel<T, 1, 2>;
    case 1 * 16 + 4: return log_halfstep_kernel<T, 1, 4>;
    case 1 * 16 + 8: return log_halfstep_kernel<T, 1, 8>;
    case 2 * 16 + 1: return log_halfstep_kernel<T, 2, 1>;
    case 2 * 16 + 2: return log_halfstep_kernel<T, 2, 2>;
    case 2 * 16 + 4: return log_halfstep_kernel<T, 2, 4>;
    case 4 * 16 + 1: return log_halfstep_kernel<T, 4, 1>;
    case 4 * 16 + 2: return log_halfstep_kernel<T, 4, 2>;
    default: return nullptr;
  }
}

template <typename T>
int halfstep_launch(const HalfstepArgs& a, int nv, int q, int grid,
                    cudaStream_t stream) {
  constexpr int V = kVec<T>;
  auto kernel = halfstep_kernel<T>(nv, q);
  const int L = a.lanes;
  if (kernel == nullptr || grid < 1 || a.m < 1 || a.r < 1 || a.B < 1 ||
      a.B > kMaxCols || (a.vec && (a.B != 1 || a.r % V != 0)) || L < 1 ||
      L > 32 || (L & (L - 1)) != 0 || (nv == 0 && L != 32) ||
      (nv > 0 && (!a.vec || L * nv < a.r / V)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nv ? 0 : (size_t)a.r * a.B * sizeof(float);
  const int err = fo::reserve_t_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, fo::kRowWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halfstep_occupancy(int nv, int q, int smem) {
  auto kernel = halfstep_kernel<T>(nv, q);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int err = fo::reserve_t_smem(kernel, smem);
  if (err != 0) return -err;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, fo::kRowWarps * 32, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

}  // namespace

// log_w is float (bf16 == 0) or bfloat16 (bf16 != 0). vec != 0 selects the
// 16-byte path; the caller passes it only for B == 1, rows of a multiple
// of 16 bytes and a 16-byte aligned log_w. The grid (splits, col_tiles,
// chunks = 1) and the row groups come from
// kernels/logmatvec.py:_contract_plan; partial holds splits * r * B
// (max, sum) pairs (unused with one split).
REPRO_EXPORT int log_feature_contract_launch(
    const void* log_w, int bf16, const float* s, float* partial, float* t,
    int n, int r, int B, int splits, int rows_per_split, int tile, int groups,
    int col_tiles, int chunks, int vec, cudaStream_t stream) {
  const fo::ContractArgs a{log_w, s, partial, t, n, r, B, splits,
                           rows_per_split, tile, groups, 1};
  if (bf16)
    return contract_launch<__nv_bfloat16>(a, col_tiles, chunks, vec, stream);
  return contract_launch<float>(a, col_tiles, chunks, vec, stream);
}

// Log-contract CTAs resident on one SM (the planner's wave), or a negative
// CUDA error code.
REPRO_EXPORT int log_feature_contract_occupancy(int bf16, int vec) {
  return bf16 ? contract_occupancy<__nv_bfloat16>(vec)
              : contract_occupancy<float>(vec);
}

// The half-step: nv vectors of t a lane in registers (1, 2 or 4; needs
// vec, B = 1), L lanes a row and q rows a group of L lanes a batch, or nv
// = 0 (t in shared memory, a row a warp: L = 32, q = 1), on `grid` CTAs of
// kRowWarps warps (kernels/logmatvec.py:_halfstep_plan).
REPRO_EXPORT int log_halfstep_launch(const void* log_w, int bf16,
                                     const float* t, const float* lmarg,
                                     float* out, int m, int r, int B,
                                     float scale, int vec, int nv, int lanes,
                                     int q, int grid, cudaStream_t stream) {
  const HalfstepArgs a{log_w, t, lmarg, out, m, r, B, scale, vec, lanes};
  return bf16 ? halfstep_launch<__nv_bfloat16>(a, nv, q, grid, stream)
              : halfstep_launch<float>(a, nv, q, grid, stream);
}

// Half-step CTAs resident on one SM with smem bytes of t (the planner's
// wave), or a negative CUDA error code.
REPRO_EXPORT int log_halfstep_occupancy(int bf16, int nv, int q, int smem) {
  return bf16 ? halfstep_occupancy<__nv_bfloat16>(nv, q, smem)
              : halfstep_occupancy<float>(nv, q, smem);
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
