// encode+encrypt megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/client_stream.py
// :_encode_encrypt_kernel (pallas_call in encode_encrypt_stream), both of
// its datapaths: df32 SpecialIFFT, bit-reversal, then the exact
// Delta-scale, then per limb: RNS reduction, NTT, Philox (v, e0, e1) keyed
// by (seed, nonce0 + row), c0 = v*b + e0 + pt, c1 = v*a + e1.
//   df32: exact RNE Delta-scale of the df32 pair into balanced base-2^22
//         digits;
//   f64:  the pair collapsed to float64, then round(x * Delta) exactly as
//         a df64 pair (two_prod, rint), split into the same three digits.
// From the digits on, both datapaths run one code path: per limb the
// digits' residues by uint32 Montgomery products. Output words are
// bit-identical to the plain version
// (client_stream.encode_encrypt_stream_plain) and to the JAX reference.
//
// One entry point launches, on the caller's stream, three device kernels
// on rows that fit one tile (logn <= 11) and five on larger ones:
//   1. enc_prologue_kernel, a grid-stride pass: each limb's forward NTT
//      twiddle heap (L, N) (ntt_tiled.cuh), made once per call, and the
//      noise (v, e0, e1) of every (row, coefficient) as int8 (B, 3, N),
//      drawn once: the Philox streams do not depend on the limb;
//   2. the SpecialIFFT over the row's 2^(logn-1) points, tiled in two
//      passes, grid (tiles, B): enc_fft_cols_kernel (slot planes -> a
//      (B, 4, ns) scratch), then enc_fft_chunks_kernel, whose store does
//      the bit reversal, 1/n, the Delta-scale and writes the three digit
//      rows (B, 3, N) int32;
//   3. the forward NTT of three polynomials per (limb, row), v, e0 + pt
//      and e1 (NTT(e0) + NTT(pt) = NTT(e0 + pt) mod q, word for word),
//      tiled in two passes (the encrypt body K2 shares, encrypt_tiled.cuh,
//      with the plaintext's digits entering its load):
//      enc_ntt_cols_kernel, one polynomial per block,
//      grid (L, 3 x tiles, B), forms its polynomial in the load (digits ->
//      residue, int8 noise -> residue) and stores NTT(v) to a (B, L, N)
//      scratch and the other two in the c0 / c1 rows;
//      enc_ntt_chunks_kernel, grid (B, tiles, L), finishes all three and
//      its store writes c0 = v*b + (e0 + pt) and c1 = v*a + e1.
// A row that fits one tile runs each transform as one pass instead,
// enc_fft_row_kernel (one block per row) and enc_ntt_row_kernel (one per
// (limb, row)).
//
// What bounds it on an H100: at the paper profile (N = 2^16, L = 24) the
// integer work (per limb 3 NTTs of 16 stages; 5 Philox-10 words per
// coefficient per row) needs more time at the card's int32 rate than the
// 2*B*L*N*4 bytes of ciphertext (201 MB at B = 16) need at its memory
// rate: operations bound it, and the NTT butterflies are most of them.
// The design keeps the butterflies near that rate: the NTT stages run in
// shared memory, two per barrier with four points per thread in
// registers, so a (limb, row)'s three polynomials cross device memory
// twice (column tiles of 2^a x 32 words, chunk tiles of 8 x 2^b words:
// 128-byte runs) instead of once per stage; the twiddles come from the
// heap table (one REDC chain per word per limb and call, instead of every
// block regenerating every stage's table); the noise is drawn once
// instead of once per limb; and every pass has hundreds of blocks (two or
// more per SM at B = 1). The f64 branch's residues come from the digits
// (no fmod per (limb, coefficient)). Times against the bound: PERF.md §6.
#include "encrypt_tiled.cuh"

namespace {

using rt::tiled::Geo;

struct EncArgs {
  const float *rh, *rl, *ih, *il;  // (B, ns) slot planes
  const float *tw;                 // (4, ns) packed inverse twiddles
  const int32_t *rev;              // (ns,) bit-reversal permutation
  const uint32_t *digit_mont;      // (L, 2): 2^22, 2^44 mod q (Montgomery)
  float *fft;                      // (B, 4, ns) between the FFT passes
  int32_t *digits;                 // (B, 3, N) Delta-scaled digits
  int f64;                         // datapath: 0 df32, 1 f64
  double delta;
  Geo fg;                          // FFT geometry (rows of ns)
  rt::tiled::EncNtt ntt;           // the encrypt: keys, c0 / c1, scratch
};

// The plaintext of K5: the residue of its Delta-scaled digits, joined to
// e0 in the NTT's column load (encrypt_tiled.cuh).
struct PtDigits {
  static constexpr bool kLoad = true, kStore = false;
  using Red = rt::MontRedc;
  const int32_t *digits;       // (B, 3, N)
  const uint32_t *digit_mont;  // (L, 2)
  struct Row {
    const int32_t *dg;
    uint32_t c22, c44;
    int n;
    RT_METHOD uint32_t load(int p, const rt::MontRedc &red) const {
      const uint32_t q = red.q;
      const uint32_t r0 = rt::to_residue(dg[p], q);
      const uint32_t m1 =
          rt::redc_mul(rt::to_residue(dg[n + p], q), c22, q, red.qinv);
      const uint32_t m2 =
          rt::redc_mul(rt::to_residue(dg[2 * n + p], q), c44, q, red.qinv);
      return rt::addmod(rt::addmod(r0, m1, q), m2, q);
    }
  };
  RT_METHOD Row row(int l, int b, int n) const {
    return Row{digits + (size_t)b * 3 * n, digit_mont[2 * l],
               digit_mont[2 * l + 1], n};
  }
  RT_METHOD Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
};

// balanced base-2^22 digits of the integer hi + lo (integer-valued
// doubles, |lo| <= ulp(hi) / 2): d0 + d1 2^22 + d2 2^44 = hi + lo exactly,
// |d0|, |d1| <= 2^21 as from rt::round_digits. Each step is exact: powers
// of two scale exactly and every difference is an integer below 2^53.
RT_FN void dd_digits(rt::dd v, int32_t &d0, int32_t &d1, int32_t &d2) {
  const double fd2 = rint(v.hi * 5.684341886080802e-14);  // 2^-44
  const double t = (v.hi - fd2 * 17592186044416.0) + v.lo;
  const double fd1 = rint(t * 2.384185791015625e-07);     // 2^-22
  d0 = (int32_t)(t - fd1 * 4194304.0);
  d1 = (int32_t)fd1;
  d2 = (int32_t)fd2;
}

RT_FN void store_digits(const EncArgs &a, int32_t *dg, int n, int k,
                        rt::df c) {
  int32_t d0, d1, d2;
  if (a.f64) {
    dd_digits(rt::delta_scale_round((double)c.hi + (double)c.lo, a.delta),
              d0, d1, d2);
  } else {
    const float delta32 = (float)a.delta;  // a power of two (df32 only)
    rt::round_digits(c.hi * delta32, c.lo * delta32, d0, d1, d2);
  }
  dg[k] = d0;
  dg[n + k] = d1;
  dg[2 * n + k] = d2;
}

// One SpecialIFFT tile of row b: kRow, the whole row; kColumns, slot
// planes -> fft scratch; kChunks, fft scratch -> digits.
template <int pass>
RT_BODY void enc_fft_tile(const EncArgs &a, int tile, int b, float *smem) {
  using namespace rt::tiled;
  const Geo &g = a.fg;
  const int ns = 1 << g.logn;
  const int pts = pass == kChunks ? chunk_points(g) : col_points(g);
  const rt::Planes x = smem_planes(smem, pts);
  float *f = a.fft + (size_t)b * 4 * ns;
  const rt::Planes mid = {f, f + ns, f + 2 * ns, f + 3 * ns};
  if (pass != kChunks) {
    const size_t row = (size_t)b * ns;
    for (int i = RT_TID; i < pts; i += RT_NT) {
      const size_t p = row + col_pos(g, tile, i);
      x.rh[i] = a.rh[p];
      x.rl[i] = a.rl[p];
      x.ih[i] = a.ih[p];
      x.il[i] = a.il[p];
    }
  } else {
    for (int i = RT_TID; i < pts; i += RT_NT)
      rt::store_dfc(x, i, rt::load_dfc(mid, chunk_pos(g, tile, i)));
  }
  RT_SYNC();
  if (pass != kChunks) fft_inv_cols(x, g, tile, a.tw);
  if (pass != kColumns) fft_inv_chunks(x, g, a.tw);
  if (pass == kColumns) {
    for (int i = RT_TID; i < pts; i += RT_NT)
      rt::store_dfc(mid, col_pos(g, tile, i), rt::load_dfc(x, i));
    return;
  }
  // point p holds coefficients rev[p] (re) and ns + rev[p] (im)
  const int n = 2 * ns;
  int32_t *dg = a.digits + (size_t)b * 3 * n;
  for (int k = RT_TID; k < pts; k += RT_NT) {
    const int i = chunk_slot_across(g, k);
    const int j = a.rev[chunk_pos(g, tile, i)];
    const rt::dfc z = rt::ifft_scale(rt::load_dfc(x, i), g.logn);
    store_digits(a, dg, n, j, z.re);
    store_digits(a, dg, n, ns + j, z.im);
  }
}

// The geometry of both transforms (geo: a, lc, lr of the NTT, then of the
// FFT; -1 takes the default, as the CUDA entry does). False if a forced one
// is out of range.
bool enc_plan(EncArgs &a, const int *geo) {
  using namespace rt::tiled;
  const int batch = a.ntt.batch, logn = a.ntt.logn;
  a.ntt.g = enc_ntt_geo(logn, geo[0], geo[1], geo[2], batch, a.ntt.n_limbs);
  a.fg = fft_geo(logn - 1, geo[3], geo[4], geo[5], batch);
  return geo_valid(a.ntt.g) && geo_valid(a.fg);
}

EncArgs enc_args(const float *rh, const float *rl, const float *ih,
                 const float *il, const float *tw, const int32_t *rev,
                 const uint32_t *table, const uint32_t *digit_mont,
                 const uint32_t *pk_b, const uint32_t *pk_a, uint32_t *c0,
                 uint32_t *c1, uint32_t *ntt_tw, int8_t *noise, float *fft,
                 int32_t *digits, uint32_t *vhat, int batch, int n_limbs,
                 int logn, int n_scalars, int f64, double delta,
                 uint32_t seed0, uint32_t seed1, uint32_t seed2,
                 uint32_t seed3, uint32_t nonce0) {
  EncArgs a = {rh, rl, ih, il, tw, rev, digit_mont, fft, digits, f64, delta,
               {},
               {table, pk_b, pk_a, c0, c1, ntt_tw, noise, vhat, batch,
                n_limbs, logn, n_scalars, {seed0, seed1, seed2, seed3},
                nonce0, {}}};
  return a;
}

PtDigits pt_digits(const EncArgs &a) {
  return PtDigits{a.digits, a.digit_mont};
}

}  // namespace

#define ENC_PARAMS                                                          \
  const float *rh, const float *rl, const float *ih, const float *il,       \
      const float *tw, const int32_t *rev, const uint32_t *table,           \
      const uint32_t *digit_mont, const uint32_t *pk_b,                     \
      const uint32_t *pk_a, uint32_t *c0, uint32_t *c1, uint32_t *ntt_tw,   \
      int8_t *noise, float *fft_scratch, int32_t *digits, uint32_t *vhat,   \
      int batch, int n_limbs, int logn, int n_scalars, int f64,             \
      double delta, uint32_t seed0, uint32_t seed1, uint32_t seed2,         \
      uint32_t seed3, uint32_t nonce0
#define ENC_ARGS                                                            \
  enc_args(rh, rl, ih, il, tw, rev, table, digit_mont, pk_b, pk_a, c0, c1,  \
           ntt_tw, noise, fft_scratch, digits, vhat, batch, n_limbs, logn,  \
           n_scalars, f64, delta, seed0, seed1, seed2, seed3, nonce0)

#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 256;

// one kernel per pass, so that a profile shows each under its own name
__global__ void __launch_bounds__(kThreads) enc_fft_row_kernel(EncArgs a) {
  extern __shared__ float fft_row_smem[];
  enc_fft_tile<rt::tiled::kRow>(a, 0, blockIdx.y, fft_row_smem);
}

__global__ void __launch_bounds__(kThreads) enc_fft_cols_kernel(EncArgs a) {
  extern __shared__ float fft_cols_smem[];
  enc_fft_tile<rt::tiled::kColumns>(a, blockIdx.x, blockIdx.y,
                                    fft_cols_smem);
}

__global__ void __launch_bounds__(kThreads)
    enc_fft_chunks_kernel(EncArgs a) {
  extern __shared__ float fft_chunks_smem[];
  enc_fft_tile<rt::tiled::kChunks>(a, blockIdx.x, blockIdx.y,
                                   fft_chunks_smem);
}

}  // namespace

extern "C" int encode_encrypt_stream_launch(ENC_PARAMS, void *stream) {
  using namespace rt::tiled;
  EncArgs a = ENC_ARGS;
  const int geo[6] = {-1, -1, -1, -1, -1, -1};
  if (!enc_plan(a, geo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = enc_prologue_launch(a.ntt, s);
  if (err != cudaSuccess) return (int)err;

  static rt::SmemAllowance allow_row, allow_cols, allow_chunks;
  const size_t f4 = 4 * sizeof(float);
  if (single_pass(a.fg)) {
    err = launch_pass(enc_fft_row_kernel, allow_row, dim3(1, batch),
                      kThreads, f4 << a.fg.logn, s, a);
  } else {
    err = launch_pass(enc_fft_cols_kernel, allow_cols,
                      dim3(col_tiles(a.fg), batch), kThreads,
                      f4 * col_points(a.fg), s, a);
    if (err == cudaSuccess)
      err = launch_pass(enc_fft_chunks_kernel, allow_chunks,
                        dim3(chunk_tiles(a.fg), batch), kThreads,
                        f4 * chunk_points(a.fg), s, a);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)enc_ntt_launch(a.ntt, pt_digits(a), s);
}

#else  // host build of the same bodies (one thread per block, each pass's
       // grid in order)

// The host entry takes the tile geometry too, so that tests can force
// splits and tile sizes (-1: the CUDA entry's plan).
extern "C" int encode_encrypt_stream_host(ENC_PARAMS, int a_ntt, int lc_ntt,
                                          int lr_ntt, int a_fft, int lc_fft,
                                          int lr_fft) {
  using namespace rt::tiled;
  EncArgs a = ENC_ARGS;
  const int geo[6] = {a_ntt, lc_ntt, lr_ntt, a_fft, lc_fft, lr_fft};
  if (!enc_plan(a, geo)) return 1;
  enc_prologue_host(a.ntt);

  std::vector<float> fsmem((size_t)4 << a.fg.logn);
  const Geo &fg = a.fg;
  for (int b = 0; b < batch; ++b) {
    if (single_pass(fg)) {
      enc_fft_tile<kRow>(a, 0, b, fsmem.data());
      continue;
    }
    for (int t = 0; t < col_tiles(fg); ++t)
      enc_fft_tile<kColumns>(a, t, b, fsmem.data());
    for (int t = 0; t < chunk_tiles(fg); ++t)
      enc_fft_tile<kChunks>(a, t, b, fsmem.data());
  }
  enc_ntt_host(a.ntt, pt_digits(a));
  return 0;
}

#endif
