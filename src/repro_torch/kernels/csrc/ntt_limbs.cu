// Limb-folded negacyclic NTT / INTT for Hopper (sm_90a): K1.
//
// Replaces the TPU kernels src/repro/kernels/ntt_butterfly.py
// :_kernel_fwd_folded and :_kernel_inv_folded (one pallas_call over an
// (L, rows, N) uint32 residue stack, per-limb constants from the (L, K)
// seed table). Forward: merged-psi Cooley-Tukey DIT, natural order in,
// bit-reversed order out. Inverse: Gentleman-Sande, bit-reversed in,
// natural order out, N^-1 folded in. Output words are bit-identical to the
// plain version (ntt_butterfly.limb_rows_plain) and to the JAX reference.
//
// One entry call launches, on the caller's stream, on the tiled NTT block
// of ntt_tiled.cuh:
//   1. ntt_limbs_prologue_kernel, grid-stride: each limb's twiddle heap of
//      the call's direction into an (L, N) scratch (heap_twiddle), made
//      on the fly once per call;
//   2. rows of logn <= kSinglePassLogn: one pass, a block per (limb, row)
//      (ntt_limbs_row_kernel / intt_limbs_row_kernel); larger rows: two
//      passes over 2^a x 2^b views of every row, a block per (limb, row,
//      tile). Forward: the column pass (x -> out), then the chunk pass in
//      place on out. Inverse: the chunk pass (x -> out), then the column
//      pass in place, its store applying N^-1. The network is the in-place
//      one: position p stays position p (no bit-reversal gather).
// Grids are one-dimensional, block = ((limb * rows + row) << log tiles) +
// tile, so any (L, rows) stack up to 2^31 blocks a pass is accepted.
//
// What bounds it on an H100: per (limb, row) logN * N/2 butterflies of 19
// int32 operations against 8 bytes of row traffic per coefficient (read
// once, written once): operations, not bytes. The design keeps the
// butterflies near the int32 rate: each pass loads a tile once into shared
// memory, runs its stages there two per barrier with four points a thread
// in registers, and stores it once (column tiles of 2^a x 2^3..2^5 words:
// 32-128 byte runs; chunk tiles of 2^1..2^3 chunks), so a row crosses
// device memory twice instead of once per stage; the twiddles come from
// the heap (one REDC chain per word per limb and call, instead of every
// block regenerating every stage's table); tile sizes shrink towards their
// lower bounds until a pass has 264 blocks where the stack allows
// (plan_geo). Times against the bound: PERF.md §6.
#include "ntt_tiled.cuh"

namespace {

using rt::tiled::Geo;

struct NttArgs {
  const uint32_t *x;      // (L, rows, N)
  uint32_t *out;          // (L, rows, N)
  const uint32_t *table;  // (L, K) seed table
  uint32_t *tw;           // (L, N) twiddle heaps of the call's direction
  int n_limbs, rows, logn, n_scalars;
  int inverse;
  Geo g;
};

// item t < L*N: limb t / N's heap twiddle t % N (slot 0 unused)
RT_FN void ntt_prologue_item(const NttArgs &a, long long t) {
  const int m = (int)(t & ((1 << a.logn) - 1));
  if (m == 0) return;
  const uint32_t *trow = a.table + (size_t)(t >> a.logn) * a.n_scalars;
  a.tw[t] = rt::tiled::heap_twiddle(trow, a.logn, a.inverse != 0, m,
                                    rt::mont_redc(trow));
}

// log2 of a pass's tiles per (limb, row)
RT_HD int log_tiles(const Geo &g, int pass) {
  using namespace rt::tiled;
  return pass == kRow ? 0 : (pass == kColumns ? geo_b(g) - g.lc
                                              : g.a - g.lr);
}

// One tile of block `blk` of a pass. Forward: kColumns x -> out, kChunks
// out -> out; inverse: kChunks x -> out, kColumns out -> out with N^-1;
// kRow: x -> out, every stage.
template <int pass, bool inverse>
RT_BODY void ntt_tile(const NttArgs &a, long long blk, uint32_t *x) {
  using namespace rt::tiled;
  const Geo &g = a.g;
  const int lt = log_tiles(g, pass);
  const int tile = (int)(blk & ((1 << lt) - 1));
  const long long row = blk >> lt;  // limb * rows + row
  const int l = (int)(row / a.rows);
  const int n = 1 << g.logn;
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  const rt::MontRedc red = rt::mont_redc(trow);
  const uint32_t *tw = a.tw + (size_t)l * n;
  uint32_t *y = a.out + (size_t)row * n;
  const bool first = pass == kRow || pass == (inverse ? kChunks : kColumns);
  const uint32_t *src = first ? a.x + (size_t)row * n : y;
  const int pts = pass == kChunks ? chunk_points(g) : col_points(g);
  for (int i = RT_TID; i < pts; i += RT_NT)
    x[i] = src[pass == kChunks ? chunk_pos(g, tile, i) : col_pos(g, tile, i)];
  RT_SYNC();
  if (!inverse) {
    if (pass != kChunks) ntt_fwd_lines(x, 1, pts, col_lines(g), g, tw, red);
    if (pass != kColumns)
      ntt_fwd_lines(x, 1, pts, chunk_lines(g, tile), g, tw, red);
  } else {
    if (pass != kColumns)
      ntt_inv_lines(x, 1, pts, chunk_lines(g, tile), g, tw, red);
    if (pass != kChunks) ntt_inv_lines(x, 1, pts, col_lines(g), g, tw, red);
  }
  if (pass == kChunks) {
    for (int i = RT_TID; i < pts; i += RT_NT) y[chunk_pos(g, tile, i)] = x[i];
    return;
  }
  const uint32_t ninv = trow[rt::OFF_NINV];
  for (int i = RT_TID; i < pts; i += RT_NT)
    y[col_pos(g, tile, i)] = inverse ? rt::redc(red, x[i], ninv) : x[i];
}

// The transform's geometry (a, lc, lr < 0: the CUDA entry's plan; brev:
// the chunk tiles' order, 0 on the card). False if a forced one is out of
// range.
bool ntt_plan(NttArgs &a, int ga, int lc, int lr, int brev) {
  using namespace rt::tiled;
  const long long limb_rows = (long long)a.n_limbs * a.rows;
  a.g = plan_geo(a.logn, ga, lc, lr, kSinglePassLogn, limb_rows, limb_rows,
                 3, 5, 1, 3, brev);
  return geo_valid(a.g);
}

// blocks of a pass
long long pass_blocks(const NttArgs &a, int pass) {
  return ((long long)a.n_limbs * a.rows) << log_tiles(a.g, pass);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ntt_limbs_prologue_kernel(NttArgs a, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step)
    ntt_prologue_item(a, t);
}

// one kernel per pass and direction, so that a profile shows each under
// its own name
#define NTT_PASS_KERNEL(name, pass, inverse)                        \
  __global__ void __launch_bounds__(kThreads) name(NttArgs a) {     \
    extern __shared__ uint32_t name##_smem[];                       \
    ntt_tile<rt::tiled::pass, inverse>(a, blockIdx.x, name##_smem); \
  }
NTT_PASS_KERNEL(ntt_limbs_row_kernel, kRow, false)
NTT_PASS_KERNEL(ntt_limbs_cols_kernel, kColumns, false)
NTT_PASS_KERNEL(ntt_limbs_chunks_kernel, kChunks, false)
NTT_PASS_KERNEL(intt_limbs_row_kernel, kRow, true)
NTT_PASS_KERNEL(intt_limbs_cols_kernel, kColumns, true)
NTT_PASS_KERNEL(intt_limbs_chunks_kernel, kChunks, true)
#undef NTT_PASS_KERNEL

template <typename Kernel>
cudaError_t run_pass(Kernel kernel, rt::SmemAllowance &allow,
                     const NttArgs &a, int pass, cudaStream_t s) {
  using namespace rt::tiled;
  const size_t pts = pass == kChunks ? chunk_points(a.g) : col_points(a.g);
  return launch_pass(kernel, allow, dim3((unsigned)pass_blocks(a, pass)),
                     kThreads, sizeof(uint32_t) * pts, s, a);
}

}  // namespace

extern "C" int ntt_limbs_launch(const uint32_t *x, uint32_t *out,
                                const uint32_t *table, uint32_t *tw_heap,
                                int n_limbs, int rows, int logn,
                                int n_scalars, int inverse, void *stream) {
  using namespace rt::tiled;
  NttArgs a = {x, out, table, tw_heap, n_limbs, rows, logn, n_scalars,
               inverse != 0, {}};
  if (!ntt_plan(a, -1, -1, -1, 0)) return (int)cudaErrorInvalidValue;
  if (pass_blocks(a, kColumns) > 0x7FFFFFFFLL ||
      pass_blocks(a, kChunks) > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidConfiguration;  // a grid's x extent
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n_limbs << logn;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ntt_limbs_prologue_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16),
                              kThreads, 0, s>>>(a, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static rt::SmemAllowance allow[6];
  if (single_pass(a.g) && inverse)
    return (int)run_pass(intt_limbs_row_kernel, allow[0], a, kRow, s);
  if (single_pass(a.g))
    return (int)run_pass(ntt_limbs_row_kernel, allow[1], a, kRow, s);
  if (!inverse) {
    err = run_pass(ntt_limbs_cols_kernel, allow[2], a, kColumns, s);
    if (err != cudaSuccess) return (int)err;
    return (int)run_pass(ntt_limbs_chunks_kernel, allow[3], a, kChunks, s);
  }
  err = run_pass(intt_limbs_chunks_kernel, allow[4], a, kChunks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)run_pass(intt_limbs_cols_kernel, allow[5], a, kColumns, s);
}

#else  // host build: every block of each pass in order (one thread per
       // block), and the one-row stage loop the tiled block replaced

#include <vector>

namespace {

template <int pass, bool inverse>
void host_pass(const NttArgs &a, uint32_t *smem) {
  for (long long blk = 0; blk < pass_blocks(a, pass); ++blk)
    ntt_tile<pass, inverse>(a, blk, smem);
}

template <bool inverse>
void host_transform(const NttArgs &a, uint32_t *smem) {
  using namespace rt::tiled;
  if (single_pass(a.g)) {
    host_pass<kRow, inverse>(a, smem);
  } else if (!inverse) {
    host_pass<kColumns, false>(a, smem);
    host_pass<kChunks, false>(a, smem);
  } else {
    host_pass<kChunks, true>(a, smem);
    host_pass<kColumns, true>(a, smem);
  }
}

}  // namespace

// The host entry takes the tile geometry too, so that tests can force
// splits, tile sizes and the chunk tiles' order (a, lc, lr = -1: the CUDA
// entry's plan; brev 0: its order).
extern "C" int ntt_limbs_host(const uint32_t *x, uint32_t *out,
                              const uint32_t *table, uint32_t *tw_heap,
                              int n_limbs, int rows, int logn, int n_scalars,
                              int inverse, int ga, int lc, int lr, int brev) {
  NttArgs a = {x, out, table, tw_heap, n_limbs, rows, logn, n_scalars,
               inverse != 0, {}};
  if (!ntt_plan(a, ga, lc, lr, brev)) return 1;
  for (long long t = 0; t < (long long)n_limbs << logn; ++t)
    ntt_prologue_item(a, t);
  std::vector<uint32_t> smem((size_t)1 << logn);
  if (inverse)
    host_transform<true>(a, smem.data());
  else
    host_transform<false>(a, smem.data());
  return 0;
}

// The one-row stage loop of client_common.cuh (rt::ntt_fwd / ntt_inv, the
// loop K3 and the server kernels still run) on the same stack: what the
// tests hold the tiled schedule against.
extern "C" int ntt_limbs_loop_host(const uint32_t *x, uint32_t *out,
                                   const uint32_t *table, int n_limbs,
                                   int rows, int logn, int n_scalars,
                                   int inverse) {
  const int n = 1 << logn;
  std::vector<uint32_t> tw((size_t)1 << (logn - 1));
  for (int l = 0; l < n_limbs; ++l)
    for (int r = 0; r < rows; ++r) {
      const size_t off = ((size_t)l * rows + r) * n;
      uint32_t *y = out + off;
      for (int i = 0; i < n; ++i) y[i] = x[off + i];
      const uint32_t *trow = table + (size_t)l * n_scalars;
      rt::Rows rw = {{y, y, y, y}};
      if (inverse)
        rt::ntt_inv(rw, 1, logn, trow, tw.data());
      else
        rt::ntt_fwd(rw, 1, logn, trow, tw.data());
    }
  return 0;
}

#endif
