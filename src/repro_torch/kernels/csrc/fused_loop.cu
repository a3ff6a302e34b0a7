// The persistent log-domain Sinkhorn megakernel: inner_steps full
// iterations in one launch.
//
// Replaces the TPU kernel _log_block_kernel of src/repro/kernels/
// fused_loop.py (launched by log_sinkhorn_block_pallas). Over the carry
// (f, g, t = LSE_i(log_xi + f/eps)) each iteration runs
//
//   g <- relax(eps * (logb - LSE_k(log_zeta[j, k] + t[k])), g)   rows of zeta
//   t <- LSE_j(log_zeta[j, k] + g[j] / eps)                       columns of zeta
//   f <- relax(eps * (loga - LSE_k(log_xi[i, k] + t[k])), f)      rows of xi
//   t <- LSE_i(log_xi[i, k] + f[i] / eps)                          columns of xi
//
// and after the last one the block-boundary marginal error
// err = sum_j |exp(LSE_k(log_zeta[j, k] + t[k]) + g[j] / eps) - b[j]|.
//
// On a GPU the JAX package's pallas_call has no grid: it is one CTA that
// holds the whole working set. So is this kernel. Both factors are copied
// once into dynamic shared memory at their storage width (float, or
// bfloat16 under precision="bf16"); f, g, t and the weights stay there as
// float for all inner_steps iterations, and only f, g, t and err are
// written back. The plan admits the kernel only where the JAX package's
// 192 KiB GPU budget admits its own (fused_loop.block_plan_fits), which
// keeps the layout below the 227 KB a CTA may hold.
//
// Row passes give each warp a row, lanes across k (neighbouring lanes read
// neighbouring elements: no bank conflicts), reduced by a fixed shuffle
// tree. Column passes give each thread a column k and a share of the rows;
// the shares are combined in shared memory in a fixed order. The factors
// sit in shared memory, so every LSE reads its terms twice, once for the
// max and once for the shifted sum: one expf a term and no branches. The
// shift of an all -inf row or column is 0 (_finite_or_zero), so it reads
// back as -inf, never NaN. There are no atomics: a rerun is bit-identical.
//
// Bound on the H100: at the OT-GAN shape (n = m = 256, r = 128, bf16) a
// launch reads 136 KB once and does 4 * 8 * 32768 LSE terms (one expf
// each), well under a microsecond of the card's bytes or operations. One
// CTA runs on one of the 132 SMs, so the launch is bound by that SM's
// special-function rate and its barriers, far above the bound.
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
