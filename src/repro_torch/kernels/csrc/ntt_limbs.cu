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
       // loops the tests hold them against

#include <vector>

namespace {

// The one-row stage loops, stage by stage over a row in memory with the
// twiddles doubled on the fly from the seed table (common.ntt_stages_t /
// intt_stages_t under MontRedc). No kernel runs them: they are the oracle
// below, the schedule the tiled block must reproduce word for word.

// tw[0 .. 2^nfac) = [base * step^bitrev(i)] by nfac Montgomery doublings,
// base and factors read from col[0 .. nfac] (gen_twiddles_t)
void gen_twiddles(uint32_t *tw, const uint32_t *col, int nfac,
                  const rt::MontRedc &red) {
  tw[0] = col[0];
  for (int k = 0; k < nfac; ++k) {
    const int h = 1 << k;
    for (int i = 0; i < h; ++i) tw[i + h] = rt::redc(red, tw[i], col[1 + k]);
  }
}

// forward negacyclic NTT, CT DIT, natural order in, bit-reversed out;
// trow: the limb's (K,) seed-table row
void ntt_fwd_loop(uint32_t *r, int logn, const uint32_t *trow,
                  uint32_t *tw) {
  const rt::MontRedc red = rt::mont_redc(trow);
  const int half = 1 << (logn - 1);
  for (int s = 0; s < logn; ++s) {
    const int logt = logn - 1 - s;  // t = N / 2^(s+1)
    gen_twiddles(tw, trow + rt::fwd_off(s), s, red);
    for (int k = 0; k < half; ++k) {
      const int j = k >> logt;
      const int p0 = (j << (logt + 1)) + (k & ((1 << logt) - 1));
      const int p1 = p0 + (1 << logt);
      const uint32_t u = r[p0];
      const uint32_t v = rt::redc(red, r[p1], tw[j]);
      r[p0] = rt::addmod(u, v, red.q);
      r[p1] = rt::submod(u, v, red.q);
    }
  }
}

// inverse negacyclic NTT, GS, bit-reversed in, natural order out, N^-1
// folded in
void ntt_inv_loop(uint32_t *r, int logn, const uint32_t *trow,
                  uint32_t *tw) {
  const rt::MontRedc red = rt::mont_redc(trow);
  const int half = 1 << (logn - 1);
  for (int st = 0; st < logn; ++st) {  // h = N >> (st+1) groups, t = 2^st
    gen_twiddles(tw, trow + rt::inv_off(logn, st), logn - 1 - st, red);
    for (int k = 0; k < half; ++k) {
      const int j = k >> st;
      const int p0 = (j << (st + 1)) + (k & ((1 << st) - 1));
      const int p1 = p0 + (1 << st);
      const uint32_t u = r[p0], v = r[p1];
      r[p0] = rt::addmod(u, v, red.q);
      r[p1] = rt::redc(red, rt::submod(u, v, red.q), tw[j]);
    }
  }
  const uint32_t ninv = trow[rt::OFF_NINV];
  for (int i = 0; i < (1 << logn); ++i) r[i] = rt::redc(red, r[i], ninv);
}

}  // namespace

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

// The one-row stage loops above on the same stack: what the tests hold the
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
      if (inverse)
        ntt_inv_loop(y, logn, trow, tw.data());
      else
        ntt_fwd_loop(y, logn, trow, tw.data());
    }
  return 0;
}

#endif
