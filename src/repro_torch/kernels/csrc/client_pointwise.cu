// Limb-folded encrypt (K2) and decrypt (K3), and the per-limb encrypt
// (K13a) and decrypt (K13b), for Hopper (sm_90a).
//
// K2 replaces the TPU kernel src/repro/kernels/client_pointwise.py
// :_encrypt_kernel_folded (encrypt_limbs): for every (limb, row) of a
// (B, L, N) NTT-domain plaintext, Philox (v, e0, e1) keyed by
// (seed, nonce0 + row) (the sum wraps mod 2^32), residues, the NTT of the
// three, c0 = (v*b + e0) + pt and c1 = v*a + e1.
// K3 replaces :_decrypt_kernel_folded (decrypt_limbs): m = INTT(c0 + c1*s)
// for every (limb, row) of a (B, L_dec, N) ciphertext view.
// Output words are bit-identical to the plain versions
// (client_pointwise.encrypt_limbs_plain / decrypt_limbs_plain) and to the
// JAX reference.
//
// K2 runs the encrypt body of K5 on the tiled NTT block
// (encrypt_tiled.cuh), with the plaintext entering c0 in the chunk store
// (PtNtt) instead of e0 in the column load: one entry call launches the
// prologue (forward twiddle heaps (L, N), the noise (B, 3, N) as int8,
// drawn once per row, not once per limb), then on rows above one tile the
// column pass, grid (L, 3 x tiles, B), one polynomial per block (NTT(v)
// into a (B, L, N) scratch, NTT(e0) / NTT(e1) into the c0 / c1 rows), and
// the chunk pass, grid (B, tiles, L), which finishes all three and writes
// c0 and c1; rows that fit one tile (logn <= 11) take one pass, a block
// per (limb, row). pt is read through its row and limb strides (the
// (L, B, N) -> (B, L, N) transpose of the staged client needs no copy).
// K3 is a transform stage (DecRows) on the tiled NTT block's stage_tile
// (ntt_tiled.cuh), as K1 is: one entry call launches the prologue
// (heap_rows_kernel: the inverse twiddle heaps (L_dec, N)), then on rows
// above one tile the chunk pass, whose load forms c0 + c1*s, and the column
// pass, whose store folds in N^-1 (decrypt_limbs_{chunks,cols}_kernel, a
// block per (row, limb, tile)); rows that fit one tile (logn <= 11) take
// one pass, a block per (row, limb). It reads rows of any stride (the
// 2-limb view of a (B, L, N) batch) and writes (B, L_dec, N), which also
// holds the transform between the passes. The reference's batch block
// (_batch_block) only bounds a TPU grid step's working set and changes no
// output.
//
// K13a replaces :_encrypt_kernel (encrypt_limb) and K13b :_decrypt_kernel
// (decrypt_limb): ONE limb of a (B, N) batch, one launch per limb as in the
// reference, with the shift-add REDC of paper eq. 9-11 (rt::SaRedc; the
// reference bakes the prime's k-terms into each compiled kernel, here they
// come from a row of common.sa_table). Row b encrypts under nonce0 + b
// (mod 2^32). Their words equal K2's / K3's on that limb and the plain
// versions (client_pointwise.encrypt_limb_plain / decrypt_limb_plain).
// K13a runs K2's tiled encrypt with one limb and the plaintext policy
// PtNttSa, whose REDC is SaRedc in the butterflies and in v*b, v*a: the
// prologue (the limb's forward heap (1, N), the noise (B, 3, N)), then on
// rows above one tile the column pass, grid (1, 3 x tiles, B), and the
// chunk pass, grid (B, tiles, 1); rows that fit one tile take one pass, a
// block per row. K13b is K3's INTT stage on one limb under SaRedc (the
// stage type DecRowSa on stage_tile): the prologue (heap_rows_kernel: the
// limb's inverse heap (1, N)), then on rows above one tile the chunk pass,
// whose load forms c0 + c1*s, and the column pass, whose store folds in
// N^-1 (decrypt_limb_{chunks,cols}_kernel, a block per (row, tile)); rows
// that fit one tile take one pass, a block per row. So three device
// kernels a call at N = 2^16, two at N <= 2^11.
//
// What bounds them on an H100: K2 writes 8 bytes per (row, limb,
// coefficient) but needs three 16-stage NTTs and five Philox-10 words per
// coefficient; K3 one INTT per (row, limb): operations, not bytes. The
// tiled passes of all four keep their butterflies in shared memory (two
// stages per barrier, four points a thread in registers; a row crosses
// device memory twice). Times against the bounds: PERF.md §6.
#include "encrypt_tiled.cuh"

namespace {

// The plaintext of K2: NTT-domain words (B, L, N) of any row and limb
// stride, joined to c0 in the chunk store (encrypt_tiled.cuh), under the
// general REDC.
struct PtNtt {
  static constexpr bool kLoad = false, kStore = true;
  using Red = rt::MontRedc;
  const uint32_t *pt;
  long long row_stride, limb_stride;
  struct Row {
    const uint32_t *w;
    RT_METHOD uint32_t store(int p) const { return w[p]; }
  };
  RT_METHOD Row row(int l, int b, int) const {
    return Row{pt + b * row_stride + l * limb_stride};
  }
  RT_METHOD Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
};

// The plaintext of K13a: K2's on one limb, under the shift-add REDC whose
// constants are the prime's common.sa_table row
struct PtNttSa : PtNtt {
  using Red = rt::SaRedc;
  const int32_t *sa;
  RT_METHOD Red make_red(const uint32_t *) const { return rt::sa_redc(sa); }
};

rt::tiled::EncNtt enc_ntt(const uint32_t *pk_b, const uint32_t *pk_a,
                          const uint32_t *table, uint32_t *c0, uint32_t *c1,
                          uint32_t *vhat, uint32_t *ntt_tw, int8_t *noise,
                          int batch, int n_limbs, int logn, int n_scalars,
                          uint32_t seed0, uint32_t seed1, uint32_t seed2,
                          uint32_t seed3, uint32_t nonce0) {
  return {table, pk_b, pk_a, c0, c1, ntt_tw, noise, vhat, batch, n_limbs,
          logn, n_scalars, {seed0, seed1, seed2, seed3}, nonce0, {}};
}

// K3's transform stage: row b * L_dec + l of the (B, L_dec, N) output m is
// INTT(c0 + c1*s) of limb l of row b, with table row l; m also holds the
// transform between the passes
struct DecRows {
  static constexpr bool kInverse = true;
  using Red = rt::MontRedc;
  RT_MEMBER Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
  const uint32_t *c0, *c1;  // (B, >= L_dec, N), row stride `row_stride`
  long long row_stride;
  const uint32_t *s_mont;   // (>= L_dec, N)
  const uint32_t *table;    // (L_dec, K) seed table
  uint32_t *m;              // (B, L_dec, N)
  int n_limbs, logn, n_scalars;
  struct Row {
    int prime;
    uint32_t *mid;
    const uint32_t *x0, *x1, *s;
    rt::MontRedc red;
    RT_MEMBER uint32_t load(int p) const {
      return rt::addmod(x0[p], rt::redc(red, x1[p], s[p]), red.q);
    }
    RT_MEMBER void store(int p, uint32_t v) const { mid[p] = v; }
  };
  RT_MEMBER Row bind(long long row) const {
    const int l = (int)(row % n_limbs);
    const size_t in = (size_t)(row / n_limbs) * row_stride +
                      ((size_t)l << logn);
    return Row{l, m + ((size_t)row << logn), c0 + in, c1 + in,
               s_mont + ((size_t)l << logn),
               rt::mont_redc(table + (size_t)l * n_scalars)};
  }
};

// K13b's transform stage: row b of the (B, N) output m is INTT(c0 + c1*s)
// of row b of one limb, under the shift-add REDC whose constants are the
// prime's common.sa_table row; m also holds the transform between the
// passes
struct DecRowSa {
  static constexpr bool kInverse = true;
  using Red = rt::SaRedc;
  const uint32_t *c0, *c1;  // (B, N)
  const uint32_t *s_mont;   // (N,)
  const int32_t *sa;        // (SA_COLS,) shift-add REDC row of the prime
  uint32_t *m;              // (B, N)
  int logn;
  struct Row {
    int prime;
    uint32_t *mid;
    const uint32_t *x0, *x1, *s;
    rt::SaRedc red;
    RT_MEMBER uint32_t load(int p) const {
      return rt::addmod(x0[p], rt::redc(red, x1[p], s[p]), red.q);
    }
    RT_MEMBER void store(int p, uint32_t v) const { mid[p] = v; }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t off = (size_t)row << logn;
    return Row{0, m + off, c0 + off, c1 + off, s_mont, rt::sa_redc(sa)};
  }
  RT_MEMBER Red make_red(const uint32_t *) const { return rt::sa_redc(sa); }
};

}  // namespace

// K2's entry arguments (the host entry adds the tile geometry)
#define ENC_PARAMS                                                          \
  const uint32_t *pt, long long pt_row_stride, long long pt_limb_stride,    \
      const uint32_t *pk_b, const uint32_t *pk_a, const uint32_t *table,    \
      uint32_t *c0, uint32_t *c1, uint32_t *v_scratch, uint32_t *ntt_tw,    \
      int8_t *noise, int batch, int n_limbs, int logn, int n_scalars,       \
      uint32_t seed0, uint32_t seed1, uint32_t seed2, uint32_t seed3,       \
      uint32_t nonce0
#define ENC_NTT                                                             \
  enc_ntt(pk_b, pk_a, table, c0, c1, v_scratch, ntt_tw, noise, batch,       \
          n_limbs, logn, n_scalars, seed0, seed1, seed2, seed3, nonce0)
#define ENC_PT PtNtt{pt, pt_row_stride, pt_limb_stride}

// K13a's entry arguments (the host entry adds the tile geometry): K2's for
// one limb, its table row trow and its shift-add REDC row sa. The one table
// row's stride is never read (0).
#define ENC1_PARAMS                                                         \
  const uint32_t *pt, const uint32_t *pk_b, const uint32_t *pk_a,           \
      const uint32_t *trow, const int32_t *sa, uint32_t *c0, uint32_t *c1,  \
      uint32_t *v_scratch, uint32_t *ntt_tw, int8_t *noise, int batch,      \
      int logn, uint32_t seed0, uint32_t seed1, uint32_t seed2,             \
      uint32_t seed3, uint32_t nonce0
#define ENC1_NTT                                                            \
  enc_ntt(pk_b, pk_a, trow, c0, c1, v_scratch, ntt_tw, noise, batch, 1,     \
          logn, 0, seed0, seed1, seed2, seed3, nonce0)
#define ENC1_PT PtNttSa{{pt, (long long)1 << logn, 0}, sa}

// K3's entry arguments (the host entry adds the tile geometry)
#define DEC_PARAMS                                                          \
  const uint32_t *c0, const uint32_t *c1, long long row_stride,             \
      const uint32_t *s_mont, const uint32_t *table, uint32_t *m,           \
      uint32_t *tw_heap, int batch, int n_limbs, int logn, int n_scalars
#define DEC_ROWS                                                            \
  DecRows{c0, c1, row_stride, s_mont, table, m, n_limbs, logn, n_scalars}

// K13b's entry arguments (the host entry adds the tile geometry): one limb's
// (B, N) rows, its table row trow (its stride is never read: 0), its
// shift-add REDC row sa and its (1, N) heap scratch
#define DEC1_PARAMS                                                         \
  const uint32_t *c0, const uint32_t *c1, const uint32_t *s_mont,           \
      const uint32_t *trow, const int32_t *sa, uint32_t *m,                 \
      uint32_t *tw_heap, int batch, int logn
#define DEC1_ROWS DecRowSa{c0, c1, s_mont, sa, m, logn}

#if defined(__CUDACC__)

namespace {

RT_STAGE_KERNELS(decrypt_limbs, DecRows)
RT_STAGE_KERNELS(decrypt_limb, DecRowSa)

// K2's and K13a's launches: the prologue, then the NTT passes
template <class Pt>
int encrypt(rt::tiled::EncNtt a, const Pt &pt, cudaStream_t s) {
  using namespace rt::tiled;
  a.g = enc_ntt_geo(a.logn, -1, -1, -1, a.batch, a.n_limbs);
  if (!geo_valid(a.g)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = enc_prologue_launch(a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)enc_ntt_launch(a, pt, s);
}

}  // namespace

extern "C" int encrypt_limbs_launch(ENC_PARAMS, void *stream) {
  return encrypt(ENC_NTT, ENC_PT, (cudaStream_t)stream);
}

extern "C" int decrypt_limbs_launch(DEC_PARAMS, void *stream) {
  const long long rows = (long long)batch * n_limbs;
  const rt::tiled::Tiling t = rt::tiled::rows_tiling(
      table, n_scalars, tw_heap, rows, logn, -1, -1, -1, 0);
  if (!rt::tiled::geo_valid(t.g)) return (int)cudaErrorInvalidValue;
  if (!rt::tiled::stage_fits(t.g, rows))
    return (int)cudaErrorInvalidConfiguration;  // a grid's x extent
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = rt::tiled::launch_heap_rows<true>(
      table, n_scalars, logn, tw_heap, n_limbs, s);
  if (err != cudaSuccess) return (int)err;
  const DecRows st = DEC_ROWS;
  return (int)rt::tiled::launch_stage(stage_kernels(st), st, t, rows, s);
}

extern "C" int encrypt_limb_launch(ENC1_PARAMS, void *stream) {
  return encrypt(ENC1_NTT, ENC1_PT, (cudaStream_t)stream);
}

extern "C" int decrypt_limb_launch(DEC1_PARAMS, void *stream) {
  const rt::tiled::Tiling t = rt::tiled::rows_tiling(
      trow, 0, tw_heap, batch, logn, -1, -1, -1, 0);
  if (!rt::tiled::geo_valid(t.g)) return (int)cudaErrorInvalidValue;
  if (!rt::tiled::stage_fits(t.g, batch))
    return (int)cudaErrorInvalidConfiguration;  // a grid's x extent
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      rt::tiled::launch_heap_rows<true>(trow, 0, logn, tw_heap, 1, s);
  if (err != cudaSuccess) return (int)err;
  const DecRowSa st = DEC1_ROWS;
  return (int)rt::tiled::launch_stage(stage_kernels(st), st, t, batch, s);
}

#else  // host build of the same block bodies (one thread per block)

namespace {

template <class Pt>
int encrypt_host(rt::tiled::EncNtt a, const Pt &pt, int ga, int lc, int lr) {
  using namespace rt::tiled;
  a.g = enc_ntt_geo(a.logn, ga, lc, lr, a.batch, a.n_limbs);
  if (!geo_valid(a.g)) return 1;
  enc_prologue_host(a);
  enc_ntt_host(a, pt);
  return 0;
}

}  // namespace

// The encrypt host entries take the tile geometry too, so that tests can
// force splits and tile sizes (-1: the CUDA entry's plan).
extern "C" int encrypt_limbs_host(ENC_PARAMS, int ga, int lc, int lr) {
  return encrypt_host(ENC_NTT, ENC_PT, ga, lc, lr);
}

extern "C" int encrypt_limb_host(ENC1_PARAMS, int ga, int lc, int lr) {
  return encrypt_host(ENC1_NTT, ENC1_PT, ga, lc, lr);
}

// K3's host entry takes the tile geometry and the chunk tiles' order too
// (a, lc, lr = -1: the CUDA entry's plan; brev 0: its order).
extern "C" int decrypt_limbs_host(DEC_PARAMS, int ga, int lc, int lr,
                                  int brev) {
  const long long rows = (long long)batch * n_limbs;
  const rt::tiled::Tiling t = rt::tiled::rows_tiling(
      table, n_scalars, tw_heap, rows, logn, ga, lc, lr, brev);
  if (!rt::tiled::geo_valid(t.g)) return 1;
  rt::tiled::heap_rows_host(table, n_scalars, logn, true, tw_heap, n_limbs);
  return rt::tiled::run_stage_host(DEC_ROWS, t, rows) ? 0 : 1;
}

// K13b's host entry takes the tile geometry and the chunk tiles' order too,
// as K3's does.
extern "C" int decrypt_limb_host(DEC1_PARAMS, int ga, int lc, int lr,
                                 int brev) {
  const rt::tiled::Tiling t = rt::tiled::rows_tiling(
      trow, 0, tw_heap, batch, logn, ga, lc, lr, brev);
  if (!rt::tiled::geo_valid(t.g)) return 1;
  rt::tiled::heap_rows_host(trow, 0, logn, true, tw_heap, 1);
  return rt::tiled::run_stage_host(DEC1_ROWS, t, batch) ? 0 : 1;
}

#endif
