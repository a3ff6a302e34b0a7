// Device code shared by the scaling-space feature kernels of kermatvec.cu
// (flat buffers) and paged.cu (paged buffers): the contract's CTA (its
// row-group accumulation over a run of rows, the CTA's partial and the
// fixed-order combine over the grid) and the one-warp row dot product of
// the paged half-step and matvec. Each source keeps its own kernels, grid
// barrier and entry points; only the paged ones look at a page table.
//
// The contract (t = xi^T u, (n, r), (n, B) -> (r, B)) runs as one launch
// of at most one wave: CTA (split, column tile, column chunk) reduces the
// rows its slab gives it, its 256 threads in `groups` row groups of `tile`
// threads; group g takes rows g, g + groups, ... of each run of rows, each
// thread one 16-byte vector (B = 1, 16-byte rows) or one column of the
// tile. The groups are added by a fixed pairwise tree in shared memory and
// the CTA writes its partial to a (splits, r, B) buffer (or t itself with
// one split); after the kernel's grid barrier every CTA adds a slice of
// the outputs over the splits in a fixed order (grid_combine). No atomics,
// so a rerun is bit-identical.
//
// The paged row kernels take one warp per row against t staged in shared
// memory: the vector path reads vectors lane, lane + 32, ... of the row;
// the scalar path elements lane, lane + 32, ... for kMaxCols columns of t
// at a time. The half-step's divide (kDivide) is IEEE float32 (__fdiv_rn).
#pragma once

#include "common.cuh"

namespace feature_ops {

constexpr int kFlatThreads = 256;     // threads of a contract CTA
constexpr int kRowWarps = 8;          // warps of a row-kernel CTA
constexpr int kUnroll = 8;            // loads in flight per thread (row_dot)

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

// The plan's geometry as the contract kernels need it (the slabs are each
// launcher's own); nonzero when the plan cannot run.
template <typename T>
__host__ int contract_plan_invalid(const ContractArgs& a, int col_tiles,
                                   int chunks, int vec) {
  constexpr int V = kVec<T>;
  const int rv = vec ? a.r / V : a.r;
  return (vec && (a.B != 1 || a.r % V != 0 || chunks != 1)) || a.tile < 1 ||
         a.groups < 1 || a.groups * a.tile > kFlatThreads ||
         col_tiles * a.tile < rv || chunks * kMaxCols < a.B || a.splits < 1;
}

// A thread's place in a contract CTA: its row group g and slot q (a 16-byte
// vector or a column of the column tile blockIdx.y), the columns
// [c0, c0 + nc) of u (blockIdx.z) and the wd elements its slot holds.
struct ContractThread {
  int g, q, c0, nc, wd;
  bool active;             // a row group's thread on a slot inside r
};

template <typename T, bool kVecPath>
__device__ __forceinline__ ContractThread contract_thread(
    const ContractArgs& a) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  ContractThread th;
  th.g = threadIdx.x / a.tile;
  th.q = blockIdx.y * a.tile + (threadIdx.x - th.g * a.tile);
  th.c0 = blockIdx.z * kMaxCols;
  th.nc = kVecPath ? 1 : min(kMaxCols, a.B - th.c0);
  th.wd = kVecPath ? V : th.nc;
  th.active = th.g < a.groups && th.q < (kVecPath ? a.r / V : a.r);
  return th;
}

// acc += the products of rows [i0, i1) for the thread's slot, its group
// taking rows i0 + g, i0 + g + groups, ... U rows of the group a round, all
// U loads issued before the first FMA; the last round is masked rather
// than finished one row at a time, so a run of any length takes
// ceil(rows / (G * U)) memory round trips. kStream reads the 16-byte path's
// rows with evict-first loads.
template <typename T, bool kVecPath, bool kStream = false>
__device__ __forceinline__ void flat_accumulate(const ContractArgs& a,
                                                const T* __restrict__ xi,
                                                float (&acc)[8], int q, int g,
                                                int c0, int nc, int i0,
                                                int i1) {
  const int G = a.groups;
  const float* __restrict__ u = a.u;
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
        if (row >= i1) {
          raw[p] = make_uint4(0, 0, 0, 0);
        } else if constexpr (kStream) {
          raw[p] = __ldcs(col + (size_t)row * rv);
        } else {
          raw[p] = __ldg(col + (size_t)row * rv);
        }
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

// The CTA's partial: the row groups' sums added by a fixed pairwise tree
// in shared memory (stride = the largest power of two below the count, so
// the order never depends on timing), written to the split's slice of the
// partials, or to t itself when there is one split. Every thread of the
// CTA calls it (it synchronises the CTA).
template <typename T, bool kVecPath>
__device__ __forceinline__ void contract_partial(const ContractArgs& a,
                                                 const ContractThread& th,
                                                 const float (&acc)[8],
                                                 float* red) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  const int tid = threadIdx.x;
  if (th.g < a.groups) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < th.wd) red[tid * th.wd + e] = acc[e];
  }
  __syncthreads();
  const int elems = a.tile * th.wd;
  for (int count = a.groups; count > 1;) {
    const int half = 1 << (31 - __clz(count - 1));
    for (int e = tid; e < (count - half) * elems; e += kFlatThreads)
      red[e] += red[e + half * elems];
    count = half;
    __syncthreads();
  }
  const size_t O = (size_t)a.r * a.B;
  float* dst = a.splits == 1 ? a.t : a.partial + blockIdx.x * O;
  for (int j = tid; j < elems; j += kFlatThreads) {
    const int o = flat_out_index<kVecPath, V>(a, j, th.nc);
    if (o >= 0) dst[o] = red[j];
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
