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
//   1. heap_rows_kernel (ntt_tiled.cuh), grid-stride: each limb's twiddle
//      heap of the call's direction into an (L, N) scratch (heap_word), made
//      on the fly once per call;
//   2. the transform stage LimbRows, whose load and store are the words as
//      they are: rows of logn <= kSinglePassLogn in one pass, a block per
//      (limb, row) (ntt_limbs_row_kernel / intt_limbs_row_kernel); larger
//      rows in two passes over 2^a x 2^b views of every row, a block per
//      (limb, row, tile). Forward: the column pass (x -> out), then the
//      chunk pass in place on out. Inverse: the chunk pass (x -> out), then
//      the column pass in place, its store applying N^-1. The network is
//      the in-place one: position p stays position p (no bit-reversal
//      gather).
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

using rt::tiled::Tiling;

// K1's transform stage: row limb * rows + r of the (L, rows, N) stack x,
// transformed with table row `limb` into out (also the buffer between the
// passes)
template <bool inverse>
struct LimbRows {
  static constexpr bool kInverse = inverse;
  using Red = rt::MontRedc;
  RT_MEMBER Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
  const uint32_t *x;
  uint32_t *out;
  int rows, logn;
  struct Row {
    int prime;
    uint32_t *mid;
    const uint32_t *src;
    RT_MEMBER uint32_t load(int p) const { return src[p]; }
    RT_MEMBER void store(int p, uint32_t v) const { mid[p] = v; }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t off = (size_t)row << logn;
    return Row{(int)(row / rows), out + off, x + off};
  }
};

}  // namespace

#if defined(__CUDACC__)

namespace {

RT_STAGE_KERNELS(ntt_limbs, LimbRows<false>)
RT_STAGE_KERNELS(intt_limbs, LimbRows<true>)

template <bool inverse>
int transform(const uint32_t *x, uint32_t *out, uint32_t *tw_heap,
              const Tiling &t, int n_limbs, int rows, int logn,
              cudaStream_t s) {
  const cudaError_t err = rt::tiled::launch_heap_rows<inverse>(
      t.table, t.ncols, logn, tw_heap, n_limbs, s);
  if (err != cudaSuccess) return (int)err;
  const LimbRows<inverse> st = {x, out, rows, logn};
  return (int)rt::tiled::launch_stage(stage_kernels(st), st, t,
                                      (long long)n_limbs * rows, s);
}

}  // namespace

extern "C" int ntt_limbs_launch(const uint32_t *x, uint32_t *out,
                                const uint32_t *table, uint32_t *tw_heap,
                                int n_limbs, int rows, int logn,
                                int n_scalars, int inverse, void *stream) {
  const Tiling t = rt::tiled::rows_tiling(table, n_scalars, tw_heap,
                                          (long long)n_limbs * rows, logn,
                                          -1, -1, -1, 0);
  if (!rt::tiled::geo_valid(t.g)) return (int)cudaErrorInvalidValue;
  if (!rt::tiled::stage_fits(t.g, (long long)n_limbs * rows))
    return (int)cudaErrorInvalidConfiguration;  // a grid's x extent
  cudaStream_t s = (cudaStream_t)stream;
  return inverse
             ? transform<true>(x, out, tw_heap, t, n_limbs, rows, logn, s)
             : transform<false>(x, out, tw_heap, t, n_limbs, rows, logn, s);
}

#else  // host build: the passes' blocks in order, and the one-row stage
       // loop the tiled block replaced

#include <vector>

// The host entry takes the tile geometry too, so that tests can force
// splits, tile sizes and the chunk tiles' order (a, lc, lr = -1: the CUDA
// entry's plan; brev 0: its order).
extern "C" int ntt_limbs_host(const uint32_t *x, uint32_t *out,
                              const uint32_t *table, uint32_t *tw_heap,
                              int n_limbs, int rows, int logn, int n_scalars,
                              int inverse, int ga, int lc, int lr, int brev) {
  const long long n_rows = (long long)n_limbs * rows;
  const Tiling t = rt::tiled::rows_tiling(table, n_scalars, tw_heap, n_rows,
                                          logn, ga, lc, lr, brev);
  if (!rt::tiled::geo_valid(t.g)) return 1;
  rt::tiled::heap_rows_host(table, n_scalars, logn, inverse != 0, tw_heap,
                            n_limbs);
  const bool ok =
      inverse
          ? rt::tiled::run_stage_host(LimbRows<true>{x, out, rows, logn}, t,
                                      n_rows)
          : rt::tiled::run_stage_host(LimbRows<false>{x, out, rows, logn}, t,
                                      n_rows);
  return ok ? 0 : 1;
}

// The one-row stage loop of client_common.cuh (rt::ntt_fwd / ntt_inv, whose
// inverse K13b still runs) on the same stack: what the tests hold the
// tiled schedule against.
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
