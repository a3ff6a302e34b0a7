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
// The scaling kernel sinkhorn_block runs as the same kind of cluster, on
// the same plan (_block_plan: the same C, slices, threads, G, L and ldw):
// rank q stages its slices of xi and zeta at storage width (a bf16 row of
// odd r padded with a zero column), its slices of u, a, v, b and s, and a
// full copy of t. The update of v is elementwise and the row passes (u
// from xi, s from zeta) are local: L lanes a row, four FMA chains a lane,
// a fixed xor tree, the divide IEEE (__fdiv_rn). A column pass (t =
// Zeta^T v, then t = Xi^T u) leaves in each CTA a partial sum of every
// column over its rows (the column pass of the log kernel with products
// and a pairwise sum in place of its two-pass LSE); after one cluster
// barrier every CTA adds the C partials of each column in rank order 0 ..
// C-1 through distributed shared memory, so every CTA holds the same t
// bit for bit. Two partial slots alternate, as in the log kernel, and the
// block-end error is summed per CTA and added by rank 0 in rank order
// before a last cluster barrier. The JAX package's kernel is one gridless
// CTA, which on a GPU runs each pass as a long serial chain on one SM: at
// the OT-GAN shape on an H100 one CTA of 1024 threads takes 0.117 ms for
// 8 iterations, the cluster of 8 CTAs 0.037 (chip_smoke.py phase 3). The
// sums are plain float FMAs (no tensor cores: the reference accumulates in
// true float32), no atomics: a rerun is bit-identical.
//
// Both kernels take P problems stacked on a leading axis, the port's
// counterpart of the JAX package's vmap over its pallas_call (which adds
// the problems as a leading grid axis: BatchedSinkhorn's vmapped solver,
// repro/core/api.py). The grid is P clusters of C CTAs; cluster p =
// blockIdx.x / C runs problem p from operands offset by p problems, and
// its rank 0 writes err_out[p]. Inside a cluster nothing changes: the
// same slices, combines and barriers, so each problem's bits are the one-
// problem launch's at the same C. No cluster reads another's memory, no
// barrier spans clusters and there are no atomics, so a NaN problem
// cannot reach another and P is not bounded by residency: clusters past
// what the card places at once (cudaOccupancyMaxActiveClusters) run in
// later waves.
//
// Both plans admit a kernel only where the JAX package's 192 KiB GPU
// budget admits its own (fused_loop.block_plan_fits), per problem, which
// keeps every CTA under the 227 KB it may hold.
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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

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

struct BlockArgs {          // each operand (P, ...): a problem a cluster
  const void* log_xi;      // (P, n, r), T
  const void* log_zeta;    // (P, m, r), T
  const float* loga;       // (P, n)
  const float* logb;       // (P, m)
  const float* b;          // (P, m)
  const float* f0;         // (P, n)
  const float* g0;         // (P, m)
  const float* t0;         // (P, r)
  float* f_out;
  float* g_out;
  float* t_out;
  float* err_out;          // (P,)
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

// x at the storage width T.
__device__ __forceinline__ float as_storage(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 as_storage(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

// The LSE shift: the max, or 0 where the max is not finite, so an all
// -inf slice sums exp(-inf) = 0 and reads back -inf (_finite_or_zero).
__device__ __forceinline__ float lse_shift(float mx) { return isfinite(mx) ? mx : 0.0f; }

// Rows [i0, i0 + rows) of an (., r) factor into shared memory, ldw words
// apart: 16-byte copies where rows and the padded stride allow, else one
// element at a time with the padding column of a bf16 row of odd r set to
// `pad`: -inf (the LSE identity) in the log kernel, 0 in the scaling one.
template <typename T>
__device__ void stage_rows(uint32_t* dst, const T* src, int i0, int rows,
                           int r, int words, int ldw, float pad) {
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
        k < r ? base[(size_t)j * r + k] : as_storage(pad, T());
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

  // this cluster's problem p: its operands start p problems in
  const size_t p = blockIdx.x / C;
  const size_t pn = p * a.n, pm = p * a.m, pr = p * a.r;
  const T* log_xi = static_cast<const T*>(a.log_xi) + pn * a.r;
  const T* log_zeta = static_cast<const T*>(a.log_zeta) + pm * a.r;

  // this rank's slices: rows [i0, i0 + nx) of log_xi, [j0, j0 + nz) of
  // log_zeta (C contiguous slices in order, sizes differing by at most 1)
  const int i0 = static_cast<int>((long long)q * a.n / C);
  const int nx = static_cast<int>((long long)(q + 1) * a.n / C) - i0;
  const int j0 = static_cast<int>((long long)q * a.m / C);
  const int nz = static_cast<int>((long long)(q + 1) * a.m / C) - j0;
  stage_rows(lxi, log_xi, i0, nx, a.r, words, a.ldw, -INFINITY);
  stage_rows(lzt, log_zeta, j0, nz, a.r, words, a.ldw, -INFINITY);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    f[i] = a.f0[pn + i0 + i];
    la[i] = a.loga[pn + i0 + i];
  }
  for (int j = threadIdx.x; j < nz; j += blockDim.x) {
    g[j] = a.g0[pm + j0 + j];
    lb[j] = a.logb[pm + j0 + j];
    bw[j] = a.b[pm + j0 + j];
  }
  for (int k = threadIdx.x; k < tc; k += blockDim.x)
    t[k] = k < a.r ? a.t0[pr + k] : 0.0f;
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
  for (int i = threadIdx.x; i < nx; i += blockDim.x) a.f_out[pn + i0 + i] = f[i];
  for (int j = threadIdx.x; j < nz; j += blockDim.x) a.g_out[pm + j0 + j] = g[j];
  if (q == 0)
    for (int k = threadIdx.x; k < a.r; k += blockDim.x) a.t_out[pr + k] = t[k];
  cluster.sync();
  if (q == 0 && threadIdx.x == 0) {
    float err = 0.0f;
    for (int rk = 0; rk < C; ++rk) err += *cluster.map_shared_rank(errp, rk);
    a.err_out[p] = err;
  }
  cluster.sync();      // no CTA leaves while rank 0 reads its shared memory
}

// ---------------------------------------------------------------------------
// Scaling space: one thread block cluster
// ---------------------------------------------------------------------------

struct ScalingArgs {        // each operand (P, ...): a problem a cluster
  const void* xi;          // (P, n, r), T
  const void* zeta;        // (P, m, r), T
  const float* a;          // (P, n)
  const float* b;          // (P, m)
  const float* u0;         // (P, n)
  const float* v0;         // (P, m)
  const float* s0;         // (P, m)
  float* u_out;
  float* v_out;
  float* s_out;
  float* err_out;          // (P,)
  int n, m, r, inner_steps;
  float mom, one_minus_mom;
  int relax;
  int groups;              // G: row groups of a column pass (a power of 2)
  int lanes;               // L: lanes a row in a row pass (a power of 2)
  int ldw;                 // 32-bit words between two staged rows
};

struct ScalingLayout {   // byte offsets into one CTA's dynamic shared memory
  size_t zeta, u, a, v, b, s, t, part, err, total;
};

// rx, rz: most rows of xi, zeta a CTA holds; t and each partial slot hold
// words * cols columns (a bf16 row of odd r ends in a zero padding column).
__host__ __device__ inline ScalingLayout scaling_layout(int rx, int rz,
                                                        int words, int cols,
                                                        int ldw) {
  ScalingLayout L;
  const size_t tc = (size_t)words * cols;
  size_t o = align16((size_t)rx * ldw * 4);
  L.zeta = o; o += align16((size_t)rz * ldw * 4);
  L.u = o;    o += align16((size_t)rx * 4);
  L.a = o;    o += align16((size_t)rx * 4);
  L.v = o;    o += align16((size_t)rz * 4);
  L.b = o;    o += align16((size_t)rz * 4);
  L.s = o;    o += align16((size_t)rz * 4);
  L.t = o;    o += align16(tc * 4);
  L.part = o; o += align16(2 * tc * 4);   // two slots of sums a column
  L.err = o;  o += 16;
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

// out[j] <- relax(marg[j] / (w t)_j, out[j]) (kDivide) or out[j] = (w t)_j
// over the CTA's `rows` rows: L lanes a row, 32 / L rows a warp at a time.
// Lane l takes words l, l + L, ... of the row into four FMA chains (words
// in turn), added in a fixed order; the row's L lanes meet in a fixed xor
// tree. The divide is IEEE float32.
template <typename T, bool kDivide>
__device__ void dot_row_pass(const uint32_t* w, const float* t,
                             const float* marg, float* out, int rows,
                             int words, int ldw, int L, float mom,
                             float one_minus_mom, bool relax) {
  constexpr int K = kCols<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Gr = 32 / L, rl = lane / L, l = lane - rl * L;
  for (int base = warp * Gr; base < rows; base += (blockDim.x >> 5) * Gr) {
    const int j = base + rl;
    const bool on = j < rows;
    const uint32_t* w_row = w + (size_t)(on ? j : 0) * ldw;
    const int nw = on ? words : 0;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int c = l;
    for (; c + 3 * L < nw; c += 4 * L) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[K], tv[K];
        unpack_word(w_row[c + u * L], v);
        load_t(t, c + u * L, tv);
#pragma unroll
        for (int e = 0; e < K; ++e) acc[u] = fmaf(v[e], tv[e], acc[u]);
      }
    }
    for (; c < nw; c += L) {
      float v[K], tv[K];
      unpack_word(w_row[c], v);
      load_t(t, c, tv);
#pragma unroll
      for (int e = 0; e < K; ++e) acc[0] = fmaf(v[e], tv[e], acc[0]);
    }
    float d = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int off = L / 2; off > 0; off >>= 1) d += __shfl_xor_sync(kFull, d, off);
    if (on && l == 0) {
      if constexpr (kDivide) {
        out[j] = relax_scale(__fdiv_rn(marg[j], d), out[j], mom, one_minus_mom,
                             relax);
      } else {
        out[j] = d;
      }
    }
  }
}

// The CTA's partial of every column k over its `rows` rows of w: the sum
// of w[j, k] * x[j] into part[k]. Lane (g, c) takes word c of a tile of
// 32 / G words and rows g, g + G, ... (at most kGroupRows), added by a
// pairwise tree; the G groups of a word meet in a fixed xor tree, and
// warps take the tiles in turn.
template <typename T>
__device__ void sum_column_partial(const uint32_t* w, const float* x,
                                   int rows, int words, int ldw, int G,
                                   float* part) {
  constexpr int K = kCols<T>;
  const int lane = threadIdx.x & 31;
  const int Wd = 32 / G, g = lane / Wd, c = lane - g * Wd;
  const int tiles = (words + Wd - 1) / Wd;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
    const int word = tile * Wd + c;
    const bool on = word < words;
    float y[K][kGroupRows];
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int j = g + i * G;
      float v[K];
      const bool live = on && j < rows;
      if (live) unpack_word(w[(size_t)j * ldw + word], v);
      const float xj = live ? x[j] : 0.0f;
#pragma unroll
      for (int e = 0; e < K; ++e) y[e][i] = live ? v[e] * xj : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
      float acc = tree_sum(y[e]);
      for (int off = Wd; off < 32; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (g == 0 && on) part[word * K + e] = acc;
    }
  }
}

// t[k] = the sum over the cluster's rows of column k: the C partials read
// through distributed shared memory (all C loads in flight) and added in
// rank order 0 .. C-1, so every CTA computes the same t bit for bit.
__device__ __forceinline__ void sum_cluster_combine(cg::cluster_group& cluster,
                                                    float* part, float* t,
                                                    int r, int C) {
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < C ? cluster.map_shared_rank(part, q)[k] : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) acc += v[q];
    t[k] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlockThreads, 1)
sinkhorn_block_kernel(const ScalingArgs a) {
  constexpr int K = kCols<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int words = (a.r * static_cast<int>(sizeof(T)) + 3) / 4;
  const int tc = words * K;
  const int rx = (a.n + C - 1) / C, rz = (a.m + C - 1) / C;
  const ScalingLayout L = scaling_layout(rx, rz, words, K, a.ldw);
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  uint32_t* zs = reinterpret_cast<uint32_t*>(smem + L.zeta);
  float* u = reinterpret_cast<float*>(smem + L.u);
  float* av = reinterpret_cast<float*>(smem + L.a);
  float* v = reinterpret_cast<float*>(smem + L.v);
  float* bw = reinterpret_cast<float*>(smem + L.b);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* t = reinterpret_cast<float*>(smem + L.t);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* errp = reinterpret_cast<float*>(smem + L.err);

  // this cluster's problem p: its operands start p problems in
  const size_t p = blockIdx.x / C;
  const size_t pn = p * a.n, pm = p * a.m;
  const T* xi = static_cast<const T*>(a.xi) + pn * a.r;
  const T* zeta = static_cast<const T*>(a.zeta) + pm * a.r;

  // this rank's slices: rows [i0, i0 + nx) of xi, [j0, j0 + nz) of zeta
  // (C contiguous slices in order, sizes differing by at most 1)
  const int i0 = static_cast<int>((long long)q * a.n / C);
  const int nx = static_cast<int>((long long)(q + 1) * a.n / C) - i0;
  const int j0 = static_cast<int>((long long)q * a.m / C);
  const int nz = static_cast<int>((long long)(q + 1) * a.m / C) - j0;
  stage_rows(xs, xi, i0, nx, a.r, words, a.ldw, 0.0f);
  stage_rows(zs, zeta, j0, nz, a.r, words, a.ldw, 0.0f);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    u[i] = a.u0[pn + i0 + i];
    av[i] = a.a[pn + i0 + i];
  }
  for (int j = threadIdx.x; j < nz; j += blockDim.x) {
    v[j] = a.v0[pm + j0 + j];
    bw[j] = a.b[pm + j0 + j];
    s[j] = a.s0[pm + j0 + j];
  }
  for (int k = threadIdx.x; k < tc; k += blockDim.x) t[k] = 0.0f;
  __syncthreads();

  const bool rel = a.relax != 0;
  const int G = a.groups, Lr = a.lanes;
  for (int it = 0; it < a.inner_steps; ++it) {
    for (int j = threadIdx.x; j < nz; j += blockDim.x)
      v[j] = relax_scale(__fdiv_rn(bw[j], s[j]), v[j], a.mom, a.one_minus_mom,
                         rel);
    __syncthreads();
    sum_column_partial<T>(zs, v, nz, words, a.ldw, G, part);
    cluster.sync();
    sum_cluster_combine(cluster, part, t, a.r, C);
    __syncthreads();
    dot_row_pass<T, true>(xs, t, av, u, nx, words, a.ldw, Lr, a.mom,
                          a.one_minus_mom, rel);
    __syncthreads();
    sum_column_partial<T>(xs, u, nx, words, a.ldw, G, part + tc);
    cluster.sync();
    sum_cluster_combine(cluster, part + tc, t, a.r, C);
    __syncthreads();
    dot_row_pass<T, false>(zs, t, nullptr, s, nz, words, a.ldw, Lr, a.mom,
                           a.one_minus_mom, rel);
    __syncthreads();
  }

  // the block-end error over this rank's rows of zeta, summed in a fixed
  // order (lane l of warp 0 takes rows l, l + 32, ..., then a shuffle
  // tree), then the ranks' sums by rank 0 in rank order
  if (threadIdx.x < 32) {
    float e = 0.0f;
    for (int j = threadIdx.x; j < nz; j += 32)
      e += fabsf(__fsub_rn(__fmul_rn(v[j], s[j]), bw[j]));
    e = warp_sum(e);
    if (threadIdx.x == 0) errp[0] = e;
  }
  for (int i = threadIdx.x; i < nx; i += blockDim.x) a.u_out[pn + i0 + i] = u[i];
  for (int j = threadIdx.x; j < nz; j += blockDim.x) {
    a.v_out[pm + j0 + j] = v[j];
    a.s_out[pm + j0 + j] = s[j];
  }
  cluster.sync();
  if (q == 0 && threadIdx.x == 0) {
    float err = 0.0f;
    for (int rk = 0; rk < C; ++rk) err += *cluster.map_shared_rank(errp, rk);
    a.err_out[p] = err;
  }
  cluster.sync();      // no CTA leaves while rank 0 reads its shared memory
}

// ---------------------------------------------------------------------------
// Both kernels' plans and cluster launches
// ---------------------------------------------------------------------------

// Whether a cluster of C CTAs of `threads` threads can run a plan of G row
// groups, L lanes a row and rows staged ldw words apart on n, m, r.
template <typename T>
bool plan_valid(int n, int m, int r, int C, int threads, int G, int L,
                int ldw) {
  if (n < 1 || m < 1 || r < 1 || C < 1 || C > kMaxCluster) return false;
  const int words = (r * static_cast<int>(sizeof(T)) + 3) / 4;
  const int rx = (n + C - 1) / C, rz = (m + C - 1) / C;
  const int rmax = rx > rz ? rx : rz;
  return threads >= 32 && threads <= kMaxBlockThreads && threads % 32 == 0 &&
         G >= 1 && G <= 32 && (G & (G - 1)) == 0 && L >= 1 && L <= 32 &&
         (L & (L - 1)) == 0 && ldw >= words && (rmax + G - 1) / G <= kGroupRows;
}

// The dynamic shared memory of one CTA of the plan, or 0 where the plan
// cannot run (the launcher refuses it).
template <typename T>
size_t log_smem(const BlockArgs& a, int C, int threads) {
  if (!plan_valid<T>(a.n, a.m, a.r, C, threads, a.groups, a.lanes, a.ldw))
    return 0;
  const int words = (a.r * static_cast<int>(sizeof(T)) + 3) / 4;
  return log_layout((a.n + C - 1) / C, (a.m + C - 1) / C, words, kCols<T>,
                    a.ldw).total;
}

template <typename T>
size_t scaling_smem(const ScalingArgs& a, int C, int threads) {
  if (!plan_valid<T>(a.n, a.m, a.r, C, threads, a.groups, a.lanes, a.ldw))
    return 0;
  const int words = (a.r * static_cast<int>(sizeof(T)) + 3) / 4;
  return scaling_layout((a.n + C - 1) / C, (a.m + C - 1) / C, words,
                        kCols<T>, a.ldw).total;
}

// The launch of `problems` clusters of C CTAs of `kernel`, one a problem.
template <typename Args>
cudaError_t cluster_config(void (*kernel)(Args), int C, int threads,
                           size_t smem, int problems, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * problems, 1, 1);
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

template <typename Args>
int cluster_launch(void (*kernel)(Args), const Args& a, size_t smem, int C,
                   int threads, int problems, cudaStream_t stream) {
  if (smem == 0 || a.inner_steps < 1 || problems < 1 ||
      (long long)C * problems > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, threads, smem, problems, stream,
                                   cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the plan the card can place at once (0: none), or a
// negative CUDA error code.
template <typename Args>
int cluster_count(void (*kernel)(Args), size_t smem, int C, int threads) {
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, threads, smem, 1, 0, cfg, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

template <typename T>
int log_launch(const BlockArgs& a, int C, int threads, int problems,
               cudaStream_t stream) {
  return cluster_launch(log_sinkhorn_block_kernel<T>, a,
                        log_smem<T>(a, C, threads), C, threads, problems,
                        stream);
}

template <typename T>
int scaling_launch(const ScalingArgs& a, int C, int threads, int problems,
                   cudaStream_t stream) {
  return cluster_launch(sinkhorn_block_kernel<T>, a,
                        scaling_smem<T>(a, C, threads), C, threads, problems,
                        stream);
}

}  // namespace

// The log plan's arguments: C CTAs of `threads` threads, G row groups of a
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

static BlockArgs log_shape(int n, int m, int r, int groups, int lanes,
                           int ldw) {
  return block_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n,
                    m, r, 1, 1.0f, 1.0f, 0.0f, 0, groups, lanes, ldw);
}

static ScalingArgs scaling_shape(int n, int m, int r, int groups, int lanes,
                                 int ldw) {
  return ScalingArgs{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, n, m, r, 1,
                     1.0f, 0.0f, 0, groups, lanes, ldw};
}

// Dynamic shared memory of one CTA of the plan, in bytes, or 0 where the
// plan cannot run (the wrapper refuses a shape above the 227 KB a CTA may
// hold).
REPRO_EXPORT long long log_sinkhorn_block_smem_bytes(int n, int m, int r,
                                                     int bf16, int cluster,
                                                     int threads, int groups,
                                                     int lanes, int ldw) {
  const BlockArgs a = log_shape(n, m, r, groups, lanes, ldw);
  return static_cast<long long>(
      bf16 ? log_smem<__nv_bfloat16>(a, cluster, threads)
           : log_smem<float>(a, cluster, threads));
}

// Clusters of the plan the card can place at once (0: none, and the
// wrapper raises), or a negative CUDA error code.
REPRO_EXPORT int log_sinkhorn_block_clusters(int n, int m, int r, int bf16,
                                             int cluster, int threads,
                                             int groups, int lanes, int ldw) {
  const BlockArgs a = log_shape(n, m, r, groups, lanes, ldw);
  return bf16 ? cluster_count(log_sinkhorn_block_kernel<__nv_bfloat16>,
                              log_smem<__nv_bfloat16>(a, cluster, threads),
                              cluster, threads)
              : cluster_count(log_sinkhorn_block_kernel<float>,
                              log_smem<float>(a, cluster, threads), cluster,
                              threads);
}

// Factors are float (bf16 == 0) or bfloat16; all vectors float, B = 1.
// relax == 0 means momentum 1 (no over-relaxation). `problems` problems
// stacked on a leading axis (factors (P, n, r) / (P, m, r), vectors (P,
// n) / (P, m), t (P, r), one error each), one cluster of `cluster` CTAs
// a problem, launched with cudaLaunchKernelEx.
REPRO_EXPORT int log_sinkhorn_block_launch(
    const void* log_xi, const void* log_zeta, int bf16, const float* loga,
    const float* logb, const float* b, const float* f0, const float* g0,
    const float* t0, float* f_out, float* g_out, float* t_out, float* err_out,
    int n, int m, int r, int inner_steps, float eps, float mom,
    float one_minus_mom, int relax, int cluster, int threads, int groups,
    int lanes, int ldw, int problems, cudaStream_t stream) {
  const BlockArgs a = block_args(log_xi, log_zeta, loga, logb, b, f0, g0, t0,
                                 f_out, g_out, t_out, err_out, n, m, r,
                                 inner_steps, eps, mom, one_minus_mom, relax,
                                 groups, lanes, ldw);
  return bf16 ? log_launch<__nv_bfloat16>(a, cluster, threads, problems, stream)
              : log_launch<float>(a, cluster, threads, problems, stream);
}

// The scaling kernel's plan (the log kernel's geometry): dynamic shared
// memory of one CTA, in bytes, or 0 where the plan cannot run.
REPRO_EXPORT long long sinkhorn_block_smem_bytes(int n, int m, int r,
                                                 int bf16, int cluster,
                                                 int threads, int groups,
                                                 int lanes, int ldw) {
  const ScalingArgs a = scaling_shape(n, m, r, groups, lanes, ldw);
  return static_cast<long long>(
      bf16 ? scaling_smem<__nv_bfloat16>(a, cluster, threads)
           : scaling_smem<float>(a, cluster, threads));
}

// Clusters of the scaling plan the card can place at once (0: none, and
// the wrapper raises), or a negative CUDA error code.
REPRO_EXPORT int sinkhorn_block_clusters(int n, int m, int r, int bf16,
                                         int cluster, int threads, int groups,
                                         int lanes, int ldw) {
  const ScalingArgs a = scaling_shape(n, m, r, groups, lanes, ldw);
  return bf16 ? cluster_count(sinkhorn_block_kernel<__nv_bfloat16>,
                              scaling_smem<__nv_bfloat16>(a, cluster, threads),
                              cluster, threads)
              : cluster_count(sinkhorn_block_kernel<float>,
                              scaling_smem<float>(a, cluster, threads),
                              cluster, threads);
}

// Factors are float (bf16 == 0) or bfloat16; all vectors float, B = 1.
// relax == 0 means momentum 1 (no over-relaxation). `problems` problems
// stacked on a leading axis (factors (P, n, r) / (P, m, r), vectors (P,
// n) / (P, m), one error each), one cluster of `cluster` CTAs a problem,
// launched with cudaLaunchKernelEx.
REPRO_EXPORT int sinkhorn_block_launch(
    const void* xi, const void* zeta, int bf16, const float* a,
    const float* b, const float* u0, const float* v0, const float* s0,
    float* u_out, float* v_out, float* s_out, float* err_out, int n, int m,
    int r, int inner_steps, float mom, float one_minus_mom, int relax,
    int cluster, int threads, int groups, int lanes, int ldw, int problems,
    cudaStream_t stream) {
  const ScalingArgs args{xi, zeta, a, b, u0, v0, s0, u_out, v_out, s_out,
                         err_out, n, m, r, inner_steps, mom, one_minus_mom,
                         relax, groups, lanes, ldw};
  return bf16 ? scaling_launch<__nv_bfloat16>(args, cluster, threads, problems,
                                              stream)
              : scaling_launch<float>(args, cluster, threads, problems, stream);
}
