// The persistent Sinkhorn megakernels: inner_steps full iterations in one
// launch, in scaling space (sinkhorn_block) and in the log domain
// (log_sinkhorn_block).
//
// log_sinkhorn_block replaces the TPU kernel _log_block_kernel of
// src/repro/kernels/fused_loop.py (launched by log_sinkhorn_block_pallas).
// Over the carry (f, g, t = LSE_i(log_xi + f/eps)) each iteration runs
//
//   g <- relax(eps * (logb - LSE_k(log_zeta[j, k] + t[k])), g)   rows of zeta
//   t <- LSE_j(log_zeta[j, k] + g[j] / eps)                       columns of zeta
//   f <- relax(eps * (loga - LSE_k(log_xi[i, k] + t[k])), f)      rows of xi
//   t <- LSE_i(log_xi[i, k] + f[i] / eps)                          columns of xi
//
// and after the last one the block-boundary marginal error
// err = sum_j |exp(LSE_k(log_zeta[j, k] + t[k]) + g[j] / eps) - b[j]|.
//
// sinkhorn_block replaces the TPU kernel _block_kernel (launched by
// sinkhorn_block_pallas), Algorithm 1 in scaling space. Over the carry
// (u, v, s = Zeta (Xi^T u)) each iteration runs
//
//   v <- relax(b / s, v)                                   elementwise
//   t <- sum_j zeta[j, k] * v[j]                           columns of zeta
//   u <- relax(a / sum_k xi[i, k] * t[k], u)               rows of xi
//   t <- sum_i xi[i, k] * u[i]                             columns of xi
//   s <- sum_k zeta[j, k] * t[k]                           rows of zeta
//
// and after the last one err = sum_j |v[j] * s[j] - b[j]|. relax is the
// geometric over-relaxation old^(1-w) * new^w, which takes new verbatim
// where old or new is 0 (dead atoms), as relax_scaling does. The divides
// are IEEE float32; there is no dead-atom pin (b = 0 gives 0 / s = 0), as
// in the reference kernel.
//
// The log kernel runs as one thread block cluster of C CTAs on C SMs
// (kernels/fused_loop.py:_block_plan; C = ceil(max(n, m) / 16) up to 8,
// the portable cluster size: 16 CTAs, with the non-portable opt-in, read
// slower at the OT-GAN shape on an H100). The JAX package's pallas_call
// has no grid, so it is one CTA on a GPU; on the H100 one CTA left 131
// SMs idle and was bound by one SM's instruction rate. Rank q of the cluster holds
// rows [q n / C, (q + 1) n / C) of log_xi and the same slice of log_zeta
// in its own shared memory at storage width (float, or bfloat16 under
// precision="bf16"), with its slices of f, g, loga, logb and b and a full
// copy of t. Row passes are then local. A column pass leaves, in each
// CTA, a partial (max, shifted sum) of every column over its rows; after
// one cluster barrier every CTA reads the C partials of each column
// through distributed shared memory and merges them in rank order 0 ..
// C-1, so all CTAs compute the same t bit for bit and nothing is
// broadcast. The partials alternate between two slots, so one barrier a
// column pass suffices: a CTA that reaches barrier p + 1 has finished
// reading the slot of pass p. A rank whose rows are all dead gives
// (-inf, 0) and drops out; if every rank does, t is -inf, never NaN. The
// block-end error is summed per CTA and added by rank 0 in rank order; a
// last cluster barrier keeps every CTA's shared memory alive until rank 0
// has read it.
//
// Inside a CTA rows are staged ldw 32-bit words apart (a word is one
// float or two bfloat16), padded so that the G row groups of a column
// pass fall in different banks. A column pass gives lane (g, c) of a warp
// word c of a tile of 32 / G words and rows g, g + G, ... (at most
// kGroupRows), whose terms it keeps in registers between the max and the
// shifted sum, each taken by a pairwise tree; the G groups meet in a
// fixed xor-shuffle tree. A row pass gives each row L lanes that read its
// words twice (for the max, then the shifted sum). Every LSE is the exact
// two-pass one with IEEE float32 expf, as the log contract's. At the
// OT-GAN shape a CTA has 32 rows of each factor and 256 threads, and an
// iteration (four passes, two cluster and four CTA barriers) takes ~7.1 us
// on an H100 (chip_smoke.py phase 3: inner_steps 8 against 1). It is bound
// by latency, not work: 512 threads, and C = 4 or 16, read no faster.
// cluster.sync() compiles to a GPU-wide memory barrier (MEMBAR.ALL.GPU)
// before the cluster barrier's arrive, a fixed cost a column pass that
// its release semantics need; pushing the partials into every peer with
// st.async against mbarriers instead, which needs no such barrier, read
// no faster on an H100. No atomics: a rerun is bit-identical.
//
// The scaling kernel sinkhorn_block is, as the JAX package's pallas_call,
// one CTA that holds the whole working set: both factors are copied once
// into dynamic shared memory at their storage width, the carries and the
// weights stay there as float for all inner_steps iterations, and only the
// carries and err are written back. Row passes give each warp a row,
// lanes across k, reduced by a fixed shuffle tree; column passes give each
// thread a column k and a share of the rows, combined in shared memory in
// a fixed order. The sums are plain float FMAs (no tensor cores: the
// reference accumulates in true float32).
//
// Both plans admit a kernel only where the JAX package's 192 KiB GPU
// budget admits its own (fused_loop.block_plan_fits), which keeps every
// CTA under the 227 KB it may hold.
//
// Bound on the H100: at the OT-GAN shape (n = m = 256, r = 128, bf16) a
// launch reads 136 KB once and does 4 * 8 * 32768 terms (an exponential
// each in the log kernel, an FMA in the scaling kernel), well under a
// microsecond of the card's bytes or operations. What bounds a launch is
// the latency of the SMs it runs on and its barriers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;      // the scaling kernel's CTA
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

template <typename T>
__device__ void stage(T* dst, const T* src, size_t count) {
  const size_t bytes = count * sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t e = threadIdx.x; e < bytes / 16; e += kThreads) d4[e] = __ldg(s4 + e);
  } else {
    for (size_t e = threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Log domain: one thread block cluster
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;      // CTAs of a cluster (the portable size)
constexpr int kGroupRows = 8;       // most rows a lane takes in a column pass
constexpr int kMaxBlockThreads = 512;   // 128 registers a thread

struct BlockArgs {
  const void* log_xi;      // (n, r), T
  const void* log_zeta;    // (m, r), T
  const float* loga;       // (n,)
  const float* logb;       // (m,)
  const float* b;          // (m,)
  const float* f0;         // (n,)
  const float* g0;         // (m,)
  const float* t0;         // (r,)
  float* f_out;
  float* g_out;
  float* t_out;
  float* err_out;
  int n, m, r, inner_steps;
  float eps, mom, one_minus_mom;
  int relax;
  int groups;              // G: row groups of a column pass (a power of 2)
  int lanes;               // L: lanes a row in a row pass (a power of 2)
  int ldw;                 // 32-bit words between two staged rows
};

struct LogLayout {   // byte offsets into one CTA's dynamic shared memory
  size_t lzt, f, loga, g, logb, b, s, t, part, err, total;
};

// rx, rz: most rows of log_xi, log_zeta a CTA holds; words: 32-bit words
// of a row, cols: columns a word; t and each partial slot hold words * cols
// columns (a bf16 row of odd r ends in a padding column).
__host__ __device__ inline LogLayout log_layout(int rx, int rz, int words,
                                                int cols, int ldw) {
  LogLayout L;
  const int rmax = rx > rz ? rx : rz;
  const size_t tc = (size_t)words * cols;
  size_t o = align16((size_t)rx * ldw * 4);
  L.lzt = o;  o += align16((size_t)rz * ldw * 4);
  L.f = o;    o += align16((size_t)rx * 4);
  L.loga = o; o += align16((size_t)rx * 4);
  L.g = o;    o += align16((size_t)rz * 4);
  L.logb = o; o += align16((size_t)rz * 4);
  L.b = o;    o += align16((size_t)rz * 4);
  L.s = o;    o += align16((size_t)rmax * 4);
  L.t = o;    o += align16(tc * 4);
  L.part = o; o += 2 * tc * 8;      // two slots of (max, sum) a column
  L.err = o;  o += 16;
  L.total = o;
  return L;
}

template <typename T>
constexpr int kCols = 4 / static_cast<int>(sizeof(T));   // columns a word

// A staged 32-bit word widened to its kCols<T> floats.
__device__ __forceinline__ void unpack_word(uint32_t w, float (&v)[1]) {
  v[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack_word(uint32_t w, float (&v)[2]) {
  v[0] = __uint_as_float(w << 16);          // little-endian: low half first
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float neg_inf_of(float) { return -INFINITY; }
__device__ __forceinline__ __nv_bfloat16 neg_inf_of(__nv_bfloat16) {
  return __float2bfloat16(-INFINITY);
}

// The LSE shift: the max, or 0 where the max is not finite, so an all
// -inf slice sums exp(-inf) = 0 and reads back -inf (_finite_or_zero).
__device__ __forceinline__ float lse_shift(float mx) { return isfinite(mx) ? mx : 0.0f; }

// Rows [i0, i0 + rows) of an (., r) factor into shared memory, ldw words
// apart: 16-byte copies where rows and the padded stride allow, else one
// element at a time with the padding column of a bf16 row of odd r set to
// -inf (the LSE identity).
template <typename T>
__device__ void stage_rows(uint32_t* dst, const T* src, int i0, int rows,
                           int r, int words, int ldw) {
  const T* base = src + (size_t)i0 * r;
  if (((size_t)r * sizeof(T)) % 16 == 0 && ldw % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    const int q = words / 4;                   // 16-byte vectors a row
    const uint4* s4 = reinterpret_cast<const uint4*>(base);
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int j = e / q;
      reinterpret_cast<uint4*>(dst + (size_t)j * ldw)[e - j * q] = __ldg(s4 + e);
    }
    return;
  }
  const int wide = words * kCols<T>;
  for (int e = threadIdx.x; e < rows * wide; e += blockDim.x) {
    const int j = e / wide, k = e - j * wide;
    reinterpret_cast<T*>(dst + (size_t)j * ldw)[k] =
        k < r ? base[(size_t)j * r + k] : neg_inf_of(T());
  }
}

// The max and the sum of N values (N a power of two) by a fixed pairwise
// tree: a short dependency chain, the same order on every launch.
template <int N>
__device__ __forceinline__ float tree_max(const float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = x[i];
#pragma unroll
  for (int h = N / 2; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) y[i] = fmaxf(y[i], y[i + h]);
  return y[0];
}

template <int N>
__device__ __forceinline__ float tree_sum(const float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = x[i];
#pragma unroll
  for (int h = N / 2; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) y[i] += y[i + h];
  return y[0];
}

// The kCols<T> entries of t under word c.
__device__ __forceinline__ void load_t(const float* t, int c, float (&tv)[1]) {
  tv[0] = t[c];
}
__device__ __forceinline__ void load_t(const float* t, int c, float (&tv)[2]) {
  const float2 x = reinterpret_cast<const float2*>(t)[c];
  tv[0] = x.x;
  tv[1] = x.y;
}

// LSE_k(w_row[k] + t[k]) over the words c = l, l + L, ... of a row, by
// the L lanes of a row segment (a fixed xor tree); every lane of the
// segment returns it. words = 0 gives -inf (a lane without a row).
template <typename T>
__device__ __forceinline__ float row_lse(const uint32_t* w_row, const float* t,
                                         int words, int l, int L) {
  constexpr int K = kCols<T>;
  float mx = -INFINITY;
#pragma unroll 4
  for (int c = l; c < words; c += L) {
    float v[K], tv[K];
    unpack_word(w_row[c], v);
    load_t(t, c, tv);
#pragma unroll
    for (int e = 0; e < K; ++e) mx = fmaxf(mx, v[e] + tv[e]);
  }
  for (int off = L / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float shift = lse_shift(mx);
  float acc = 0.0f;
#pragma unroll 4
  for (int c = l; c < words; c += L) {
    float v[K], tv[K];
    unpack_word(w_row[c], v);
    load_t(t, c, tv);
#pragma unroll
    for (int e = 0; e < K; ++e) acc += expf(v[e] + tv[e] - shift);
  }
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return shift + logf(acc);
}

// pot[j] <- relax(eps * (lmarg[j] - LSE_k(w[j, k] + t[k])), pot[j]) and
// s[j] = pot[j] / eps for the column pass that follows, over the CTA's
// `rows` rows: L lanes a row, 32 / L rows a warp at a time. A -inf
// potential (dead atom) takes the new value verbatim, as relax_log does.
template <typename T>
__device__ void row_pass(const uint32_t* w, const float* t, const float* lmarg,
                         float* pot, float* s, int rows, int words, int ldw,
                         int L, float eps, float mom, float one_minus_mom,
                         bool relax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Gr = 32 / L, rl = lane / L, l = lane - rl * L;
  for (int base = warp * Gr; base < rows; base += (blockDim.x >> 5) * Gr) {
    const int j = base + rl;
    const bool on = j < rows;
    const float lse = row_lse<T>(w + (size_t)(on ? j : 0) * ldw, t,
                                 on ? words : 0, l, L);
    if (on && l == 0) {
      float v = __fmul_rn(eps, __fsub_rn(lmarg[j], lse));
      const float old = pot[j];
      if (relax && isfinite(old) && isfinite(v))
        v = __fadd_rn(__fmul_rn(one_minus_mom, old), __fmul_rn(mom, v));
      pot[j] = v;
      s[j] = __fdiv_rn(v, eps);
    }
  }
}

// The CTA's partial of every column k over its `rows` rows of w: the max
// of x = w[j, k] + s[j] and the sum of exp(x - shift) (shift: the max, or
// 0 where it is -inf), into part[k] as (max, sum). Lane (g, c) takes word
// c of a tile of 32 / G words and rows g, g + G, ... (at most kGroupRows,
// kept in registers between the two passes); the G groups of a word meet
// in a fixed xor tree, and warps take the tiles in turn.
template <typename T>
__device__ void column_partial(const uint32_t* w, const float* s, int rows,
                               int words, int ldw, int G, float2* part) {
  constexpr int K = kCols<T>;
  const int lane = threadIdx.x & 31;
  const int Wd = 32 / G, g = lane / Wd, c = lane - g * Wd;
  const int tiles = (words + Wd - 1) / Wd;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
    const int word = tile * Wd + c;
    const bool on = word < words;
    float x[K][kGroupRows], mx[K], acc[K];
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int j = g + i * G;
      float v[K];
      const bool live = on && j < rows;
      if (live) unpack_word(w[(size_t)j * ldw + word], v);
      const float sj = live ? s[j] : 0.0f;
#pragma unroll
      for (int e = 0; e < K; ++e) x[e][i] = live ? v[e] + sj : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
      mx[e] = tree_max(x[e]);
      for (int off = Wd; off < 32; off <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], off));
      const float shift = lse_shift(mx[e]);
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) x[e][i] = expf(x[e][i] - shift);
      acc[e] = tree_sum(x[e]);
      for (int off = Wd; off < 32; off <<= 1)
        acc[e] += __shfl_xor_sync(kFull, acc[e], off);
    }
    if (g == 0 && on) {
#pragma unroll
      for (int e = 0; e < K; ++e) part[word * K + e] = make_float2(mx[e], acc[e]);
    }
  }
}

// t[k] = LSE over the cluster's rows of column k, from the C partials read
// through distributed shared memory (all C loads in flight) and merged in
// rank order 0 .. C-1: the joint max, then the sum of each rank's sum
// rescaled to it. A rank with max -inf (no live term) drops out.
__device__ __forceinline__ void cluster_combine(cg::cluster_group& cluster,
                                                float2* part, float* t, int r,
                                                int C) {
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    float2 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < C ? cluster.map_shared_rank(part, q)[k]
                   : make_float2(-INFINITY, 0.0f);
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) mx = fmaxf(mx, v[q].x);
    const float shift = lse_shift(mx);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (v[q].x != -INFINITY) acc += v[q].y * expf(v[q].x - shift);
    t[k] = shift + logf(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlockThreads, 1)
log_sinkhorn_block_kernel(const BlockArgs a) {
  constexpr int K = kCols<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int words = (a.r * static_cast<int>(sizeof(T)) + 3) / 4;
  const int tc = words * K;
  const int rx = (a.n + C - 1) / C, rz = (a.m + C - 1) / C;
  const LogLayout L = log_layout(rx, rz, words, K, a.ldw);
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  uint32_t* lxi = reinterpret_cast<uint32_t*>(smem);
  uint32_t* lzt = reinterpret_cast<uint32_t*>(smem + L.lzt);
  float* f = reinterpret_cast<float*>(smem + L.f);
  float* la = reinterpret_cast<float*>(smem + L.loga);
  float* g = reinterpret_cast<float*>(smem + L.g);
  float* lb = reinterpret_cast<float*>(smem + L.logb);
  float* bw = reinterpret_cast<float*>(smem + L.b);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* t = reinterpret_cast<float*>(smem + L.t);
  float2* part = reinterpret_cast<float2*>(smem + L.part);
  float* errp = reinterpret_cast<float*>(smem + L.err);

  // this rank's slices: rows [i0, i0 + nx) of log_xi, [j0, j0 + nz) of
  // log_zeta (C contiguous slices in order, sizes differing by at most 1)
  const int i0 = static_cast<int>((long long)q * a.n / C);
  const int nx = static_cast<int>((long long)(q + 1) * a.n / C) - i0;
  const int j0 = static_cast<int>((long long)q * a.m / C);
  const int nz = static_cast<int>((long long)(q + 1) * a.m / C) - j0;
  stage_rows(lxi, static_cast<const T*>(a.log_xi), i0, nx, a.r, words, a.ldw);
  stage_rows(lzt, static_cast<const T*>(a.log_zeta), j0, nz, a.r, words, a.ldw);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    f[i] = a.f0[i0 + i];
    la[i] = a.loga[i0 + i];
  }
  for (int j = threadIdx.x; j < nz; j += blockDim.x) {
    g[j] = a.g0[j0 + j];
    lb[j] = a.logb[j0 + j];
    bw[j] = a.b[j0 + j];
  }
  for (int k = threadIdx.x; k < tc; k += blockDim.x) t[k] = k < a.r ? a.t0[k] : 0.0f;
  __syncthreads();

  const bool rel = a.relax != 0;
  const int G = a.groups;
  for (int it = 0; it < a.inner_steps; ++it) {
    row_pass<T>(lzt, t, lb, g, s, nz, words, a.ldw, a.lanes, a.eps, a.mom,
                a.one_minus_mom, rel);
    __syncthreads();
    column_partial<T>(lzt, s, nz, words, a.ldw, G, part);
    cluster.sync();
    cluster_combine(cluster, part, t, a.r, C);
    __syncthreads();
    row_pass<T>(lxi, t, la, f, s, nx, words, a.ldw, a.lanes, a.eps, a.mom,
                a.one_minus_mom, rel);
    __syncthreads();
    column_partial<T>(lxi, s, nx, words, a.ldw, G, part + tc);
    cluster.sync();
    cluster_combine(cluster, part + tc, t, a.r, C);
    __syncthreads();
  }

  // the block-end error over this rank's rows of zeta, summed in a fixed
  // order (lane l of warp 0 takes rows l, l + 32, ..., then a shuffle
  // tree), then the ranks' sums by rank 0 in rank order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Lr = a.lanes, Gr = 32 / Lr, rl = lane / Lr, l = lane - rl * Lr;
  for (int base = warp * Gr; base < nz; base += (blockDim.x >> 5) * Gr) {
    const int j = base + rl;
    const bool on = j < nz;
    const float lse = row_lse<T>(lzt + (size_t)(on ? j : 0) * a.ldw, t,
                                 on ? words : 0, l, Lr);
    if (on && l == 0) s[j] = fabsf(expf(lse + __fdiv_rn(g[j], a.eps)) - bw[j]);
  }
  __syncthreads();
  if (warp == 0) {
    float e = 0.0f;
    for (int j = lane; j < nz; j += 32) e += s[j];
    e = warp_sum(e);
    if (lane == 0) errp[0] = e;
  }
  for (int i = threadIdx.x; i < nx; i += blockDim.x) a.f_out[i0 + i] = f[i];
  for (int j = threadIdx.x; j < nz; j += blockDim.x) a.g_out[j0 + j] = g[j];
  if (q == 0)
    for (int k = threadIdx.x; k < a.r; k += blockDim.x) a.t_out[k] = t[k];
  cluster.sync();
  if (q == 0 && threadIdx.x == 0) {
    float err = 0.0f;
    for (int p = 0; p < C; ++p) err += *cluster.map_shared_rank(errp, p);
    a.err_out[0] = err;
  }
  cluster.sync();      // no CTA leaves while rank 0 reads its shared memory
}

// The dynamic shared memory of one CTA of the plan, or 0 where the plan
// cannot run (the launcher refuses it).
template <typename T>
size_t block_smem(const BlockArgs& a, int C, int threads) {
  const int words = (a.r * static_cast<int>(sizeof(T)) + 3) / 4;
  const int rx = (a.n + C - 1) / C, rz = (a.m + C - 1) / C;
  const int rmax = rx > rz ? rx : rz;
  const int G = a.groups, L = a.lanes;
  if (C < 1 || C > kMaxCluster || threads < 32 || threads > kMaxBlockThreads ||
      threads % 32 != 0 || G < 1 || G > 32 || (G & (G - 1)) != 0 ||
      L < 1 || L > 32 || (L & (L - 1)) != 0 ||
      a.ldw < words || (rmax + G - 1) / G > kGroupRows || a.n < 1 ||
      a.m < 1 || a.r < 1)
    return 0;
  return log_layout(rx, rz, words, kCols<T>, a.ldw).total;
}

// The launch of one cluster of C CTAs (the whole grid).
template <typename T>
cudaError_t block_config(int C, int threads, size_t smem,
                         cudaStream_t stream, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute& attr) {
  auto kernel = log_sinkhorn_block_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int block_launch(const BlockArgs& a, int C, int threads, cudaStream_t stream) {
  const size_t smem = block_smem<T>(a, C, threads);
  if (smem == 0 || a.inner_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = block_config<T>(C, threads, smem, stream, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, log_sinkhorn_block_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the plan the card can place at once (0: none), or a
// negative CUDA error code.
template <typename T>
int block_clusters(const BlockArgs& a, int C, int threads) {
  const size_t smem = block_smem<T>(a, C, threads);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = block_config<T>(C, threads, smem, 0, cfg, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, log_sinkhorn_block_kernel<T>,
                                       &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Scaling space
// ---------------------------------------------------------------------------

struct ScalingLayout {   // byte offsets into dynamic shared memory
  size_t zeta, u, a, v, b, s, t, part, warp_err, total;
};

__host__ __device__ inline ScalingLayout scaling_layout(int n, int m, int r,
                                                        int elem) {
  ScalingLayout L;
  size_t o = align16((size_t)n * r * elem);
  L.zeta = o;     o += align16((size_t)m * r * elem);
  L.u = o;        o += align16((size_t)n * 4);
  L.a = o;        o += align16((size_t)n * 4);
  L.v = o;        o += align16((size_t)m * 4);
  L.b = o;        o += align16((size_t)m * 4);
  L.s = o;        o += align16((size_t)m * 4);
  L.t = o;        o += align16((size_t)r * 4);
  L.part = o;     o += (size_t)kThreads * 4;
  L.warp_err = o; o += (size_t)kWarps * 4;
  L.total = o;
  return L;
}

// relax_scaling: old^(1-w) * new^w, or new verbatim where old or new is 0
// (or where the momentum is 1).
__device__ __forceinline__ float relax_scale(float nw, float old, float mom,
                                             float one_minus_mom, bool relax) {
  if (relax && old > 0.0f && nw > 0.0f)
    return __fmul_rn(powf(old, one_minus_mom), powf(nw, mom));
  return nw;
}

// out[j] <- relax(marg[j] / (w t)_j, out[j]) with a marginal, or
// out[j] = (w t)_j without one; one warp a row, a fixed shuffle tree.
template <typename T>
__device__ void dot_row_pass(const T* w, const float* t, const float* marg,
                             float* out, int rows, int r, float mom,
                             float one_minus_mom, bool relax) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < rows; j += kWarps) {
    const T* w_row = w + (size_t)j * r;
    float acc = 0.0f;
    for (int k = lane; k < r; k += 32) acc = fmaf(widen(w_row[k]), t[k], acc);
    acc = warp_sum(acc);
    if (lane == 0)
      out[j] = marg ? relax_scale(__fdiv_rn(marg[j], acc), out[j], mom,
                                  one_minus_mom, relax)
                    : acc;
  }
  __syncthreads();
}

// t[k] = sum_i w[i, k] * x[i] over the `rows` rows of w. With r < kThreads
// each column gets P = kThreads / r threads, thread p taking rows p,
// p + P, ...; the P partial sums are added in shared memory in the order
// p = 0 .. P-1.
template <typename T>
__device__ void sum_column_pass(const T* w, const float* x, int rows, int r,
                                float* t, float* part) {
  if (r >= kThreads) {
    for (int k = threadIdx.x; k < r; k += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < rows; ++i) acc = fmaf(widen(w[(size_t)i * r + k]), x[i], acc);
      t[k] = acc;
    }
    __syncthreads();
    return;
  }
  const int P = kThreads / r;
  const int p = threadIdx.x / r;
  const int k = threadIdx.x - p * r;
  if (p < P) {
    float acc = 0.0f;
    for (int i = p; i < rows; i += P) acc = fmaf(widen(w[(size_t)i * r + k]), x[i], acc);
    part[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float acc = part[threadIdx.x];
    for (int q = 1; q < P; ++q) acc += part[q * r + threadIdx.x];
    t[threadIdx.x] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_block_kernel(const T* __restrict__ xi, const T* __restrict__ zeta,
                      const float* __restrict__ a_in,
                      const float* __restrict__ b_in,
                      const float* __restrict__ u0,
                      const float* __restrict__ v0,
                      const float* __restrict__ s0, float* __restrict__ u_out,
                      float* __restrict__ v_out, float* __restrict__ s_out,
                      float* __restrict__ err_out, int n, int m, int r,
                      int inner_steps, float mom, float one_minus_mom,
                      int relax) {
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const ScalingLayout L = scaling_layout(n, m, r, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* zs = reinterpret_cast<T*>(smem + L.zeta);
  float* u = reinterpret_cast<float*>(smem + L.u);
  float* a = reinterpret_cast<float*>(smem + L.a);
  float* v = reinterpret_cast<float*>(smem + L.v);
  float* b = reinterpret_cast<float*>(smem + L.b);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* t = reinterpret_cast<float*>(smem + L.t);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* warp_err = reinterpret_cast<float*>(smem + L.warp_err);

  stage(xs, xi, (size_t)n * r);
  stage(zs, zeta, (size_t)m * r);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    u[i] = u0[i];
    a[i] = a_in[i];
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    v[j] = v0[j];
    b[j] = b_in[j];
    s[j] = s0[j];
  }
  __syncthreads();

  const bool rel = relax != 0;
  for (int it = 0; it < inner_steps; ++it) {
    for (int j = threadIdx.x; j < m; j += kThreads)
      v[j] = relax_scale(__fdiv_rn(b[j], s[j]), v[j], mom, one_minus_mom, rel);
    __syncthreads();
    sum_column_pass(zs, v, m, r, t, part);
    dot_row_pass(xs, t, a, u, n, r, mom, one_minus_mom, rel);
    sum_column_pass(xs, u, n, r, t, part);
    dot_row_pass(zs, t, static_cast<const float*>(nullptr), s, m, r, mom,
                 one_minus_mom, rel);
  }

  // the marginal error at the block boundary, summed in a fixed order:
  // rows j = tid, tid + kThreads, ... by each thread, a fixed shuffle tree
  // in each warp, then the warps in order
  float e = 0.0f;
  for (int j = threadIdx.x; j < m; j += kThreads)
    e += fabsf(__fsub_rn(__fmul_rn(v[j], s[j]), b[j]));
  e = warp_sum(e);
  if ((threadIdx.x & 31) == 0) warp_err[threadIdx.x >> 5] = e;
  for (int i = threadIdx.x; i < n; i += kThreads) u_out[i] = u[i];
  for (int j = threadIdx.x; j < m; j += kThreads) {
    v_out[j] = v[j];
    s_out[j] = s[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float err = 0.0f;
    for (int w = 0; w < kWarps; ++w) err += warp_err[w];
    err_out[0] = err;
  }
}

template <typename T>
int scaling_block_launch(const T* xi, const T* zeta, const float* a,
                         const float* b, const float* u0, const float* v0,
                         const float* s0, float* u_out, float* v_out,
                         float* s_out, float* err_out, int n, int m, int r,
                         int inner_steps, float mom, float one_minus_mom,
                         int relax, cudaStream_t stream) {
  const size_t smem = scaling_layout(n, m, r, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_block_kernel<T><<<1, kThreads, smem, stream>>>(
      xi, zeta, a, b, u0, v0, s0, u_out, v_out, s_out, err_out, n, m, r,
      inner_steps, mom, one_minus_mom, relax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's arguments: C CTAs of `threads` threads, G row groups of a
// column pass, L lanes a row in a row pass, rows staged ldw 32-bit words
// apart (kernels/fused_loop.py:_block_plan).
static BlockArgs block_args(const void* log_xi, const void* log_zeta,
                            const float* loga, const float* logb,
                            const float* b, const float* f0, const float* g0,
                            const float* t0, float* f_out, float* g_out,
                            float* t_out, float* err_out, int n, int m, int r,
                            int inner_steps, float eps, float mom,
                            float one_minus_mom, int relax, int groups,
                            int lanes, int ldw) {
  return BlockArgs{log_xi, log_zeta, loga, logb, b, f0, g0, t0, f_out, g_out,
                   t_out, err_out, n, m, r, inner_steps, eps, mom,
                   one_minus_mom, relax, groups, lanes, ldw};
}

// Dynamic shared memory of one CTA of the plan, in bytes, or 0 where the
// plan cannot run (the wrapper refuses a shape above the 227 KB a CTA may
// hold).
REPRO_EXPORT long long log_sinkhorn_block_smem_bytes(int n, int m, int r,
                                                     int bf16, int cluster,
                                                     int threads, int groups,
                                                     int lanes, int ldw) {
  const BlockArgs a = block_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, n, m, r, 1, 1.0f, 1.0f,
                                 0.0f, 0, groups, lanes, ldw);
  return static_cast<long long>(
      bf16 ? block_smem<__nv_bfloat16>(a, cluster, threads)
           : block_smem<float>(a, cluster, threads));
}

// Clusters of the plan the card can place at once (0: none, and the
// wrapper raises), or a negative CUDA error code.
REPRO_EXPORT int log_sinkhorn_block_clusters(int n, int m, int r, int bf16,
                                             int cluster, int threads,
                                             int groups, int lanes, int ldw) {
  const BlockArgs a = block_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, n, m, r, 1, 1.0f, 1.0f,
                                 0.0f, 0, groups, lanes, ldw);
  return bf16 ? block_clusters<__nv_bfloat16>(a, cluster, threads)
              : block_clusters<float>(a, cluster, threads);
}

// Factors are float (bf16 == 0) or bfloat16; all vectors float, B = 1.
// relax == 0 means momentum 1 (no over-relaxation). One cluster of
// `cluster` CTAs, launched with cudaLaunchKernelEx.
REPRO_EXPORT int log_sinkhorn_block_launch(
    const void* log_xi, const void* log_zeta, int bf16, const float* loga,
    const float* logb, const float* b, const float* f0, const float* g0,
    const float* t0, float* f_out, float* g_out, float* t_out, float* err_out,
    int n, int m, int r, int inner_steps, float eps, float mom,
    float one_minus_mom, int relax, int cluster, int threads, int groups,
    int lanes, int ldw, cudaStream_t stream) {
  const BlockArgs a = block_args(log_xi, log_zeta, loga, logb, b, f0, g0, t0,
                                 f_out, g_out, t_out, err_out, n, m, r,
                                 inner_steps, eps, mom, one_minus_mom, relax,
                                 groups, lanes, ldw);
  return bf16 ? block_launch<__nv_bfloat16>(a, cluster, threads, stream)
              : block_launch<float>(a, cluster, threads, stream);
}

// Dynamic shared memory of one scaling launch, in bytes (the wrapper
// refuses a shape above the 227 KB a CTA may hold).
REPRO_EXPORT long long sinkhorn_block_smem_bytes(int n, int m, int r,
                                                 int bf16) {
  return static_cast<long long>(scaling_layout(n, m, r, bf16 ? 2 : 4).total);
}

// Factors are float (bf16 == 0) or bfloat16; all vectors float, B = 1.
// relax == 0 means momentum 1 (no over-relaxation).
REPRO_EXPORT int sinkhorn_block_launch(
    const void* xi, const void* zeta, int bf16, const float* a,
    const float* b, const float* u0, const float* v0, const float* s0,
    float* u_out, float* v_out, float* s_out, float* err_out, int n, int m,
    int r, int inner_steps, float mom, float one_minus_mom, int relax,
    cudaStream_t stream) {
  if (bf16)
    return scaling_block_launch(static_cast<const __nv_bfloat16*>(xi),
                                static_cast<const __nv_bfloat16*>(zeta), a, b,
                                u0, v0, s0, u_out, v_out, s_out, err_out, n,
                                m, r, inner_steps, mom, one_minus_mom, relax,
                                stream);
  return scaling_block_launch(static_cast<const float*>(xi),
                              static_cast<const float*>(zeta), a, b, u0, v0,
                              s0, u_out, v_out, s_out, err_out, n, m, r,
                              inner_steps, mom, one_minus_mom, relax, stream);
}
