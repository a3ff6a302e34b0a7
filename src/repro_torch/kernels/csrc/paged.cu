// Paged scaling-space operators: the contract, half-step and matvec over a
// fixed-capacity feature buffer carved into pages of page_size rows, with
// a per-page live-slot count page_live (int32, one per page).
//
// paged_contract_kernel replaces the TPU kernel _paged_contract_kernel in
// src/repro/kernels/paged.py (launched by _paged_contract_impl):
//
//   t[k, c] = sum over live pages p, rows i of p:  xi[i, k] * u[i, c]
//                                                   (C, r), (C, B) -> (r, B)
//
// The TPU walks the pages on a sequential grid axis, predicated on the
// scalar-prefetched live count, and accumulates into one revisited output
// block. Here the flat contract's design carries over (kermatvec.cu; the
// CTA's loops and the combine are feature_ops.cuh's): one cooperative
// launch of at most one wave, planned by kernels/kermatvec.py:
// _contract_plan (256-thread CTAs, row groups that fill a CTA at any r,
// 16-byte loads where B = 1 and rows are 16-byte aligned), each CTA's
// partial to a (splits, r, B) buffer and, after a grid barrier, a
// fixed-order combine (grid_combine). No atomics, so a rerun is
// bit-identical.
//
// The slabs split the live pages, not the capacity. Every CTA reads the
// page table itself (no host read, no extra launch) in sweeps of up to
// 8192 pages: coalesced loads, a page a thread a tile of 256, all issued
// at once; a ballot a tile a warp gives a bitmap of 256 words in page
// order, and an exclusive scan of the words' counts the rank of every live
// page. With the L live pages laid end to end in page order, the CTA of
// split s takes its equal share of the L ps live rows (ps = page_size;
// the first L ps % splits slabs one row more): the live pages that hold
// them, listed in shared memory kListPages at a time, the first and last
// cut at those rows.
// Runs of consecutive listed pages are accumulated as one run of rows, so
// a packed store's live pages read as the flat contract reads its slab. The partition depends
// only on page_live and the grid, so at 25% live every CTA still has
// work, and a rerun takes the same order. The rows of dead pages, and
// their u, are never read; a CTA with no live page writes zeros. A table
// of one sweep (C = 524288 rows of 64-row pages) costs a CTA one L2 round
// trip, 32 loads, 32 ballots, a 256-word scan and three CTA barriers
// before its first row load; a longer table is first counted in one more
// pass, then swept 8192 pages at a time.
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
// all three are bound by the bytes of the live pages.
#include <cooperative_groups.h>

#include "feature_ops.cuh"

namespace {

using namespace feature_ops;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kFlatThreads / 32;
constexpr int kScanTiles = 32;                         // a bit each in a word
constexpr int kSweepPages = kFlatThreads * kScanTiles; // pages a sweep
constexpr int kListPages = 512;                        // pages a window lists

struct PageScan {
  unsigned words[kFlatThreads]; // a sweep's live pages, 32 a word, in order
  int warp_total[kWarps];
  int list[kListPages];         // the window's live pages, in page order
};

// The live pages of the sweep from p0 as a bitmap in page order: bit l of
// word w is page p0 + 32 w + l. Coalesced loads (a page a thread, up to 32
// tiles of 256 pages, all issued before the first ballot), then a ballot
// a tile a warp, lane i keeping tile i's. Ends with the CTA synchronised.
__device__ __forceinline__ void sweep_words(PageScan& s,
                                            const int* __restrict__ live,
                                            int p0, int n_pages) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = min(kScanTiles, (n_pages - p0 + kFlatThreads - 1) / kFlatThreads);
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kScanTiles; ++i) {
    if (i == tiles) break;
    const int p = p0 + i * kFlatThreads + threadIdx.x;
    if (p < n_pages && __ldg(live + p) != 0) bits |= 1u << i;
  }
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < kScanTiles; ++i) {
    if (i == tiles) break;
    const unsigned b = __ballot_sync(kFull, (bits >> i) & 1u);
    if (lane == i) mine = b;
  }
  s.words[lane * kWarps + warp] = mine;   // tile lane, pages 32 warp + ...
  __syncthreads();
}

// The sweep's live pages in all, and in `before` those ahead of word
// threadIdx.x (an exclusive scan over the words, in page order).
__device__ __forceinline__ int scan_words(PageScan& s, int& before) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = __popc(s.words[threadIdx.x]);
  int inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s.warp_total[warp] = inc;
  __syncthreads();
  int ahead = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ahead += w < warp ? s.warp_total[w] : 0;
    total += s.warp_total[w];
  }
  before = ahead + inc - c;
  return total;
}

// The live pages of word threadIdx.x whose rank (first for its first live
// page) is in [w_lo, w_hi), into s.list[rank - w_lo]: each found directly
// as the word's (rank - first + 1)-th set bit.
__device__ __forceinline__ void list_word(PageScan& s, int p0, int first,
                                          int w_lo, int w_hi) {
  const unsigned word = s.words[threadIdx.x];
  const int k1 = min(first + __popc(word), w_hi);
  for (int k = max(first, w_lo); k < k1; ++k)
    s.list[k - w_lo] = p0 + 32 * threadIdx.x + __fns(word, 0, k - first + 1);
}

// The live pages of a table longer than one sweep (every thread gets it).
__device__ __forceinline__ int count_live(PageScan& s,
                                          const int* __restrict__ live,
                                          int n_pages) {
  int c = 0;
#pragma unroll 8
  for (int p = threadIdx.x; p < n_pages; p += kFlatThreads)
    c += __ldg(live + p) != 0;
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) s.warp_total[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s.warp_total[w];
  __syncthreads();
  return total;
}

template <typename T, bool kVecPath, bool kStream>
__global__ void __launch_bounds__(kFlatThreads, 2)
paged_contract_kernel(const ContractArgs a, const int* __restrict__ page_live,
                      int page_size, int n_pages) {
  __shared__ __align__(16) float red[kFlatThreads * 8];
  __shared__ PageScan scan;
  const ContractThread th = contract_thread<T, kVecPath>(a);
  const T* xi = static_cast<const T*>(a.xi);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;

  // live: the live pages L (a table of one sweep counts them in its own
  // scan). Of the R = L ps live rows, laid end to end in page order, split
  // s takes R / splits rows, one more for s < R % splits: the pages of
  // ranks [lo, hi), the first entered skip rows in, the last left cut rows
  // early; kListPages pages a window, each listed by sweeps of the table.
  int live = n_pages > kSweepPages ? count_live(scan, page_live, n_pages) : -1;
  for (int window = 0;; ++window) {
    int base = 0, lo = 0, hi = 0, skip = 0, cut = 0, w_lo = 0, w_hi = 0;
    for (int p0 = 0; p0 < n_pages; p0 += kSweepPages) {
      sweep_words(scan, page_live, p0, n_pages);
      int before;
      const int total = scan_words(scan, before);
      if (live < 0) live = total;
      const int rows = live * page_size;       // < 2^31: C is an int
      const int q = rows / a.splits, rem = rows - q * a.splits;
      const int r_lo = q * blockIdx.x + min(static_cast<int>(blockIdx.x), rem);
      const int r_hi = r_lo + q + (static_cast<int>(blockIdx.x) < rem);
      lo = r_lo / page_size;
      hi = (r_hi + page_size - 1) / page_size;
      skip = r_lo - lo * page_size;
      cut = hi * page_size - r_hi;
      w_lo = lo + window * kListPages;
      w_hi = min(hi, w_lo + kListPages);
      list_word(scan, p0, base + before, w_lo, w_hi);
      base += total;
      __syncthreads();              // the list is complete, the words free
      if (base >= w_hi) break;      // the same on every thread
    }
    if (th.active) {
      const int m = w_hi - w_lo;
      for (int k = 0; k < m;) {     // a run of consecutive live pages
        const int first = scan.list[k];
        int e = k + 1;
        while (e < m && scan.list[e] == first + (e - k)) ++e;
        const int i0 = first * page_size + (w_lo + k == lo ? skip : 0);
        const int i1 = (first + e - k) * page_size - (w_lo + e == hi ? cut : 0);
        flat_accumulate<T, kVecPath, kStream>(a, xi, acc, th.q, th.g, th.c0,
                                              th.nc, i0, i1);
        k = e;
      }
    }
    if (w_hi >= hi) break;
    __syncthreads();                // before the next window's list
  }
  contract_partial<T, kVecPath>(a, th, acc, red);
  if (a.splits == 1 || !a.combine) return;   // the same on every CTA
  cooperative_groups::this_grid().sync();
  grid_combine(a, red);
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

// With one split the CTAs are independent and launch as usual; with more
// they meet at the grid barrier, so the launch is cooperative: it fails
// (and the wrapper raises) rather than start more CTAs than can be
// resident at once.
template <typename T, bool kVecPath, bool kStream>
int paged_launch(const ContractArgs& a, const int* page_live, int page_size,
                 int n_pages, int col_tiles, int chunks, cudaStream_t stream) {
  const dim3 grid(a.splits, col_tiles, chunks);
  auto kernel = paged_contract_kernel<T, kVecPath, kStream>;
  if (a.splits == 1 || !a.combine) {
    kernel<<<grid, kFlatThreads, 0, stream>>>(a, page_live, page_size,
                                              n_pages);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {const_cast<ContractArgs*>(&a), &page_live, &page_size,
                  &n_pages};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(kFlatThreads), args,
      0, stream));
}

// evict_first applies to the 16-byte path only (the scalar path's loads
// stay as they are).
template <typename T>
int contract_launch(const ContractArgs& a, const int* page_live,
                    int page_size, int n_pages, int col_tiles, int chunks,
                    int vec, int evict_first, cudaStream_t stream) {
  if (contract_plan_invalid<T>(a, col_tiles, chunks, vec) || page_size < 1 ||
      n_pages < 1 || (long long)page_size * n_pages != a.n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!vec)
    return paged_launch<T, false, false>(a, page_live, page_size, n_pages,
                                         col_tiles, chunks, stream);
  return evict_first
      ? paged_launch<T, true, true>(a, page_live, page_size, n_pages,
                                    col_tiles, chunks, stream)
      : paged_launch<T, true, false>(a, page_live, page_size, n_pages,
                                     col_tiles, chunks, stream);
}

template <typename T>
int contract_occupancy(int vec) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks,
      vec ? paged_contract_kernel<T, true, false>
          : paged_contract_kernel<T, false, false>,
      kFlatThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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
// int32 live counts and the buffer has C = n_pages * page_size rows. vec
// != 0 selects the 16-byte path; the caller passes it only for B == 1,
// rows of a multiple of 16 bytes and a 16-byte aligned xi. The grid
// (splits, col_tiles, chunks) and the row groups come from
// kernels/paged.py:_paged_plan; partial holds splits * r * B floats
// (unused with one split). combine == 0 stops after the partials (t is
// not formed): chip_smoke.py times the slabs alone that way. evict_first
// != 0 reads the rows with evict-first loads (16-byte path).
REPRO_EXPORT int paged_feature_contract_launch(
    const void* xi, int bf16, const float* u, const int* page_live,
    float* partial, float* t, int C, int r, int B, int page_size,
    int n_pages, int splits, int tile, int groups, int col_tiles, int chunks,
    int vec, int combine, int evict_first, cudaStream_t stream) {
  const ContractArgs a{xi, u, partial, t, C, r, B, splits, 0, tile, groups,
                       combine};
  if (bf16)
    return contract_launch<__nv_bfloat16>(a, page_live, page_size, n_pages,
                                          col_tiles, chunks, vec, evict_first,
                                          stream);
  return contract_launch<float>(a, page_live, page_size, n_pages, col_tiles,
                                chunks, vec, evict_first, stream);
}

// Paged-contract CTAs resident on one SM (the planner's wave), or a
// negative CUDA error code.
REPRO_EXPORT int paged_feature_contract_occupancy(int bf16, int vec) {
  return bf16 ? contract_occupancy<__nv_bfloat16>(vec)
              : contract_occupancy<float>(vec);
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
