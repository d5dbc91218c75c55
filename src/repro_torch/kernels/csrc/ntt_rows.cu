// Single-prime negacyclic NTT / INTT with the shift-add REDC for Hopper
// (sm_90a): K12.
//
// Replaces the TPU kernels src/repro/kernels/ntt_butterfly.py:_kernel_fwd
// and :_kernel_inv (ntt_rows / intt_rows: one pallas_call over (rows, N)
// uint32 residues of one prime, its constants fixed at compile time, the
// stage loops common.ntt_stages / intt_stages with the NTT-friendly
// shift-add Montgomery REDC of paper eq. 9-11). Forward: natural order in,
// bit-reversed out. Inverse: bit-reversed in, natural order out, N^-1
// folded in. Output words are bit-identical to the plain version
// (ntt_butterfly.rows_plain), to K1 on that prime, and to the JAX
// reference.
//
// The reference bakes q and the k-terms into each compiled kernel. Here
// they are launch data: one row of common.sa_table (q, p_bw, n+1, up to
// three signed k-term exponents), so one build serves every prime. K12 is a
// transform stage (SaRows) on the tiled NTT block of ntt_tiled.cuh, as K1
// is, whose REDC policy is rt::SaRedc instead of MontRedc: one entry call
// launches, on the caller's stream,
//   1. heap_rows_kernel: the prime's twiddle heap of the call's direction
//      into a (1, N) scratch (heap_word, made under MontRedc: the same
//      words);
//   2. the stage: rows of logn <= kSinglePassLogn in one pass, a block per
//      row (ntt_rows_row_kernel / intt_rows_row_kernel); larger rows in two
//      passes over 2^a x 2^b views of every row, a block per (row, tile):
//      forward the column pass (x -> out), then the chunk pass in place on
//      out; inverse the chunk pass, then the column pass, whose store
//      applies N^-1.
// So three device kernels a call at N = 2^16, two at N <= 2^11.
//
// What bounds it on an H100: logN * N/2 butterflies per row, each one
// shift-add REDC (one 32x32 product, the rest shifts and adds: more
// integer instructions than MontRedc's three products) plus addmod and
// submod, against 8 bytes of row traffic per coefficient: operations, not
// bytes. As in K1, each pass loads a tile once into shared memory, runs its
// stages there two per barrier with four points a thread in registers, and
// stores it once, so a row crosses device memory twice; the twiddles come
// from the heap. Times against the bound: PERF.md §6.
#include "ntt_tiled.cuh"

namespace {

using rt::tiled::Tiling;

// K12's transform stage: row r of the (rows, N) x, transformed with the one
// table row under the prime's shift-add REDC row sa into out (also the
// buffer between the passes)
template <bool inverse>
struct SaRows {
  static constexpr bool kInverse = inverse;
  using Red = rt::SaRedc;
  const uint32_t *x;
  uint32_t *out;
  const int32_t *sa;  // (SA_COLS,) shift-add REDC row of the prime
  int logn;
  struct Row {
    int prime;
    uint32_t *mid;
    const uint32_t *src;
    RT_MEMBER uint32_t load(int p) const { return src[p]; }
    RT_MEMBER void store(int p, uint32_t v) const { mid[p] = v; }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t off = (size_t)row << logn;
    return Row{0, out + off, x + off};
  }
  RT_MEMBER Red make_red(const uint32_t *) const { return rt::sa_redc(sa); }
};

// The tiling of K12 over `rows` rows: the one table row trow (its stride is
// never read: 0), its heap in tw_heap
Tiling sa_tiling(const uint32_t *trow, const uint32_t *tw_heap, int rows,
                 int logn, int ga, int lc, int lr, int brev) {
  return rt::tiled::rows_tiling(trow, 0, tw_heap, rows, logn, ga, lc, lr,
                                brev);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

RT_STAGE_KERNELS(ntt_rows, SaRows<false>)
RT_STAGE_KERNELS(intt_rows, SaRows<true>)

template <bool inverse>
int transform(const uint32_t *x, uint32_t *out, const uint32_t *trow,
              const int32_t *sa, uint32_t *tw_heap, const Tiling &t,
              int rows, int logn, cudaStream_t s) {
  const cudaError_t err =
      rt::tiled::launch_heap_rows<inverse>(trow, 0, logn, tw_heap, 1, s);
  if (err != cudaSuccess) return (int)err;
  const SaRows<inverse> st = {x, out, sa, logn};
  return (int)rt::tiled::launch_stage(stage_kernels(st), st, t, rows, s);
}

}  // namespace

extern "C" int ntt_rows_launch(const uint32_t *x, uint32_t *out,
                               const uint32_t *trow, const int32_t *sa,
                               uint32_t *tw_heap, int rows, int logn,
                               int inverse, void *stream) {
  const Tiling t = sa_tiling(trow, tw_heap, rows, logn, -1, -1, -1, 0);
  if (!rt::tiled::geo_valid(t.g)) return (int)cudaErrorInvalidValue;
  if (!rt::tiled::stage_fits(t.g, rows))
    return (int)cudaErrorInvalidConfiguration;  // a grid's x extent
  cudaStream_t s = (cudaStream_t)stream;
  return inverse
             ? transform<true>(x, out, trow, sa, tw_heap, t, rows, logn, s)
             : transform<false>(x, out, trow, sa, tw_heap, t, rows, logn, s);
}

#else  // host build: the passes' blocks in order

// The host entry takes the tile geometry too, so that tests can force
// splits, tile sizes and the chunk tiles' order (a, lc, lr = -1: the CUDA
// entry's plan; brev 0: its order).
extern "C" int ntt_rows_host(const uint32_t *x, uint32_t *out,
                             const uint32_t *trow, const int32_t *sa,
                             uint32_t *tw_heap, int rows, int logn,
                             int inverse, int ga, int lc, int lr, int brev) {
  const Tiling t = sa_tiling(trow, tw_heap, rows, logn, ga, lc, lr, brev);
  if (!rt::tiled::geo_valid(t.g)) return 1;
  rt::tiled::heap_rows_host(trow, 0, logn, inverse != 0, tw_heap, 1);
  const bool ok =
      inverse ? rt::tiled::run_stage_host(SaRows<true>{x, out, sa, logn}, t,
                                          rows)
              : rt::tiled::run_stage_host(SaRows<false>{x, out, sa, logn}, t,
                                          rows);
  return ok ? 0 : 1;
}

#endif
