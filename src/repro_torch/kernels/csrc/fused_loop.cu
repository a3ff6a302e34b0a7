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
// On a GPU the JAX package's pallas_calls have no grid: each is one CTA
// that holds the whole working set. So is each kernel here. Both factors
// are copied once into dynamic shared memory at their storage width
// (float, or bfloat16 under precision="bf16"); the carries and the
// weights stay there as float for all inner_steps iterations, and only
// the carries and err are written back. The plan admits a kernel only
// where the JAX package's 192 KiB GPU budget admits its own
// (fused_loop.block_plan_fits), which keeps the layout below the 227 KB a
// CTA may hold.
//
// Row passes give each warp a row, lanes across k (neighbouring lanes read
// neighbouring elements: no bank conflicts), reduced by a fixed shuffle
// tree. Column passes give each thread a column k and a share of the rows;
// the shares are combined in shared memory in a fixed order. In the log
// kernel every LSE reads its terms twice, once for the max and once for
// the shifted sum: one expf a term and no branches. The shift of an all
// -inf row or column is 0 (_finite_or_zero), so it reads back as -inf,
// never NaN. The scaling kernel's sums are plain float FMAs (no tensor
// cores: the reference accumulates in true float32). There are no
// atomics: a rerun is bit-identical.
//
// Bound on the H100: at the OT-GAN shape (n = m = 256, r = 128, bf16) a
// launch reads 136 KB once and does 4 * 8 * 32768 terms (an expf each in
// the log kernel, an FMA in the scaling kernel), well under a microsecond
// of the card's bytes or operations. One CTA runs on one of the 132 SMs,
// so a launch is bound by that SM's instruction rate and its barriers, far
// above the bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Layout {   // byte offsets into dynamic shared memory
  size_t lzt, f, g, loga, logb, s, t, part_mx, part_acc, warp_err, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int n, int m, int r, int elem) {
  Layout L;
  size_t o = align16((size_t)n * r * elem);
  L.lzt = 0 + o;
  o = L.lzt + align16((size_t)m * r * elem);
  const int nm = n > m ? n : m;
  L.f = o;        o += align16((size_t)n * 4);
  L.g = o;        o += align16((size_t)m * 4);
  L.loga = o;     o += align16((size_t)n * 4);
  L.logb = o;     o += align16((size_t)m * 4);
  L.s = o;        o += align16((size_t)nm * 4);
  L.t = o;        o += align16((size_t)r * 4);
  L.part_mx = o;  o += (size_t)kThreads * 4;
  L.part_acc = o; o += (size_t)kThreads * 4;
  L.warp_err = o; o += (size_t)kWarps * 4;
  L.total = o;
  return L;
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The LSE shift: the max, or 0 where the max is not finite, so an all
// -inf slice sums exp(-inf) = 0 and reads back -inf (_finite_or_zero).
__device__ __forceinline__ float lse_shift(float mx) { return isfinite(mx) ? mx : 0.0f; }

// LSE_k(w_row[k] + t[k]) by one warp, in two passes over shared memory:
// the max, then the shifted sum of exp (one expf per term); every lane
// returns it. A NaN term is dropped by fmaxf but poisons the sum.
template <typename T>
__device__ __forceinline__ float row_lse(const T* w_row, const float* t, int r,
                                         int lane) {
  float mx = -INFINITY;
  for (int k = lane; k < r; k += 32) mx = fmaxf(mx, widen(w_row[k]) + t[k]);
  const float shift = lse_shift(warp_max(mx));
  float acc = 0.0f;
  for (int k = lane; k < r; k += 32) acc += expf(widen(w_row[k]) + t[k] - shift);
  return shift + logf(warp_sum(acc));
}

// pot[j] <- relax(eps * (lmarg[j] - LSE_k(w[j, k] + t[k])), pot[j]) and
// s[j] = pot[j] / eps for the column pass that follows. A -inf potential
// (dead atom) takes the new value verbatim, as relax_log does.
template <typename T>
__device__ void row_pass(const T* w, const float* t, const float* lmarg,
                         float* pot, float* s, int rows, int r, float eps,
                         float mom, float one_minus_mom, bool relax) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < rows; j += kWarps) {
    const float lse = row_lse(w + (size_t)j * r, t, r, lane);
    if (lane == 0) {
      float v = __fmul_rn(eps, __fsub_rn(lmarg[j], lse));
      const float old = pot[j];
      if (relax && isfinite(old) && isfinite(v))
        v = __fadd_rn(__fmul_rn(one_minus_mom, old), __fmul_rn(mom, v));
      pot[j] = v;
      s[j] = __fdiv_rn(v, eps);
    }
  }
  __syncthreads();
}

// t[k] = LSE_i(w[i, k] + s[i]) over the `rows` rows of w, in two passes
// (max, then shifted sum). With r < kThreads each column gets
// P = kThreads / r threads, thread p taking rows p, p + P, ...; the P
// partial maxima and sums are combined in shared memory in the order
// p = 0 .. P-1. The shift of column k is parked in t[k] between passes.
template <typename T>
__device__ void column_pass(const T* w, const float* s, int rows, int r,
                            float* t, float* part_mx, float* part_acc) {
  if (r >= kThreads) {
    for (int k = threadIdx.x; k < r; k += kThreads) {
      float mx = -INFINITY;
      for (int i = 0; i < rows; ++i) mx = fmaxf(mx, widen(w[(size_t)i * r + k]) + s[i]);
      const float shift = lse_shift(mx);
      float acc = 0.0f;
      for (int i = 0; i < rows; ++i) acc += expf(widen(w[(size_t)i * r + k]) + s[i] - shift);
      t[k] = shift + logf(acc);
    }
    __syncthreads();
    return;
  }
  const int P = kThreads / r;
  const int p = threadIdx.x / r;
  const int k = threadIdx.x - p * r;
  if (p < P) {
    float mx = -INFINITY;
    for (int i = p; i < rows; i += P) mx = fmaxf(mx, widen(w[(size_t)i * r + k]) + s[i]);
    part_mx[threadIdx.x] = mx;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float mx = part_mx[threadIdx.x];
    for (int q = 1; q < P; ++q) mx = fmaxf(mx, part_mx[q * r + threadIdx.x]);
    t[threadIdx.x] = lse_shift(mx);
  }
  __syncthreads();
  if (p < P) {
    const float shift = t[k];
    float acc = 0.0f;
    for (int i = p; i < rows; i += P) acc += expf(widen(w[(size_t)i * r + k]) + s[i] - shift);
    part_acc[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float acc = part_acc[threadIdx.x];
    for (int q = 1; q < P; ++q) acc += part_acc[q * r + threadIdx.x];
    t[threadIdx.x] += logf(acc);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
log_sinkhorn_block_kernel(const T* __restrict__ log_xi,
                          const T* __restrict__ log_zeta,
                          const float* __restrict__ loga,
                          const float* __restrict__ logb,
                          const float* __restrict__ b,
                          const float* __restrict__ f0,
                          const float* __restrict__ g0,
                          const float* __restrict__ t0,
                          float* __restrict__ f_out, float* __restrict__ g_out,
                          float* __restrict__ t_out, float* __restrict__ err_out,
                          int n, int m, int r, int inner_steps, float eps,
                          float mom, float one_minus_mom, int relax) {
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const Layout L = layout(n, m, r, sizeof(T));
  T* lxi = reinterpret_cast<T*>(smem);
  T* lzt = reinterpret_cast<T*>(smem + L.lzt);
  float* f = reinterpret_cast<float*>(smem + L.f);
  float* g = reinterpret_cast<float*>(smem + L.g);
  float* la = reinterpret_cast<float*>(smem + L.loga);
  float* lb = reinterpret_cast<float*>(smem + L.logb);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* t = reinterpret_cast<float*>(smem + L.t);
  float* part_mx = reinterpret_cast<float*>(smem + L.part_mx);
  float* part_acc = reinterpret_cast<float*>(smem + L.part_acc);
  float* warp_err = reinterpret_cast<float*>(smem + L.warp_err);

  stage(lxi, log_xi, (size_t)n * r);
  stage(lzt, log_zeta, (size_t)m * r);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    f[i] = f0[i];
    la[i] = loga[i];
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    g[j] = g0[j];
    lb[j] = logb[j];
  }
  for (int k = threadIdx.x; k < r; k += kThreads) t[k] = t0[k];
  __syncthreads();

  const bool rel = relax != 0;
  for (int it = 0; it < inner_steps; ++it) {
    row_pass(lzt, t, lb, g, s, m, r, eps, mom, one_minus_mom, rel);
    column_pass(lzt, s, m, r, t, part_mx, part_acc);
    row_pass(lxi, t, la, f, s, n, r, eps, mom, one_minus_mom, rel);
    column_pass(lxi, s, n, r, t, part_mx, part_acc);
  }

  // the marginal error at the block boundary, summed in a fixed order:
  // rows j = w, w + kWarps, ... by warp w, then the warps in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float part = 0.0f;
  for (int j = warp; j < m; j += kWarps) {
    const float lse = row_lse(lzt + (size_t)j * r, t, r, lane);
    part += fabsf(expf(lse + __fdiv_rn(g[j], eps)) - b[j]);
  }
  if (lane == 0) warp_err[warp] = part;
  for (int i = threadIdx.x; i < n; i += kThreads) f_out[i] = f[i];
  for (int j = threadIdx.x; j < m; j += kThreads) g_out[j] = g[j];
  for (int k = threadIdx.x; k < r; k += kThreads) t_out[k] = t[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    float err = 0.0f;
    for (int w = 0; w < kWarps; ++w) err += warp_err[w];
    err_out[0] = err;
  }
}

template <typename T>
int block_launch(const T* log_xi, const T* log_zeta, const float* loga,
                 const float* logb, const float* b, const float* f0,
                 const float* g0, const float* t0, float* f_out, float* g_out,
                 float* t_out, float* err_out, int n, int m, int r,
                 int inner_steps, float eps, float mom, float one_minus_mom,
                 int relax, cudaStream_t stream) {
  const size_t smem = layout(n, m, r, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      log_sinkhorn_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  log_sinkhorn_block_kernel<T><<<1, kThreads, smem, stream>>>(
      log_xi, log_zeta, loga, logb, b, f0, g0, t0, f_out, g_out, t_out,
      err_out, n, m, r, inner_steps, eps, mom, one_minus_mom, relax);
  return static_cast<int>(cudaGetLastError());
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

// Dynamic shared memory of one launch, in bytes (the wrapper refuses a
// shape above the 227 KB a CTA may hold).
REPRO_EXPORT long long log_sinkhorn_block_smem_bytes(int n, int m, int r,
                                                     int bf16) {
  return static_cast<long long>(layout(n, m, r, bf16 ? 2 : 4).total);
}

// Factors are float (bf16 == 0) or bfloat16; all vectors float, B = 1.
// relax == 0 means momentum 1 (no over-relaxation).
REPRO_EXPORT int log_sinkhorn_block_launch(
    const void* log_xi, const void* log_zeta, int bf16, const float* loga,
    const float* logb, const float* b, const float* f0, const float* g0,
    const float* t0, float* f_out, float* g_out, float* t_out, float* err_out,
    int n, int m, int r, int inner_steps, float eps, float mom,
    float one_minus_mom, int relax, cudaStream_t stream) {
  if (bf16)
    return block_launch(static_cast<const __nv_bfloat16*>(log_xi),
                        static_cast<const __nv_bfloat16*>(log_zeta), loga,
                        logb, b, f0, g0, t0, f_out, g_out, t_out, err_out, n,
                        m, r, inner_steps, eps, mom, one_minus_mom, relax,
                        stream);
  return block_launch(static_cast<const float*>(log_xi),
                      static_cast<const float*>(log_zeta), loga, logb, b, f0,
                      g0, t0, f_out, g_out, t_out, err_out, n, m, r,
                      inner_steps, eps, mom, one_minus_mom, relax, stream);
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
