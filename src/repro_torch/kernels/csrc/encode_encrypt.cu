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
//      tiled in two passes: enc_ntt_cols_kernel, one polynomial per block,
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
#include "ntt_tiled.cuh"

namespace {

using rt::tiled::Geo;

struct EncArgs {
  const float *rh, *rl, *ih, *il;  // (B, ns) slot planes
  const float *tw;                 // (4, ns) packed inverse twiddles
  const int32_t *rev;              // (ns,) bit-reversal permutation
  const uint32_t *table;           // (L, K) seed table
  const uint32_t *digit_mont;      // (L, 2): 2^22, 2^44 mod q (Montgomery)
  const uint32_t *pk_b, *pk_a;     // (L, N) Montgomery form
  uint32_t *c0, *c1;               // (B, L, N)
  uint32_t *ntt_tw;                // (L, N) forward twiddle heaps
  int8_t *noise;                   // (B, 3, N) v, e0, e1
  float *fft;                      // (B, 4, ns) between the FFT passes
  int32_t *digits;                 // (B, 3, N) Delta-scaled digits
  uint32_t *vhat;                  // (B, L, N) NTT(v) between NTT passes
  int batch, n_limbs, logn, n_scalars;
  int f64;                         // datapath: 0 df32, 1 f64
  double delta;
  rt::Seed seed;
  uint32_t nonce0;
  Geo fg, ng;                      // FFT (rows of ns) and NTT geometry
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

// item t < L*N: limb t / N's heap twiddle t % N (slot 0 unused); else the
// noise of (row, coefficient) t - L*N
RT_FN void enc_prologue_item(const EncArgs &a, long long t) {
  const int n = 1 << a.logn;
  const long long ntw = (long long)a.n_limbs << a.logn;
  if (t < ntw) {
    const int m = (int)(t & (n - 1));
    if (m == 0) return;
    const uint32_t *trow = a.table + (size_t)(t >> a.logn) * a.n_scalars;
    a.ntt_tw[t] = rt::tiled::heap_twiddle(trow, a.logn, false, m,
                                          rt::mont_redc(trow));
    return;
  }
  t -= ntw;
  const int b = (int)(t >> a.logn);
  const uint32_t i = (uint32_t)(t & (n - 1));
  const uint32_t nonce = a.nonce0 + (uint32_t)b;
  const uint32_t sv = 0x10000u + 16u * nonce;  // STREAM_ENC_V + 16*nonce
  const uint32_t s0 = 0x20000u + 16u * nonce;  // STREAM_ENC_E0
  const uint32_t s1 = 0x30000u + 16u * nonce;  // STREAM_ENC_E1
  int8_t *nz = a.noise + (size_t)b * 3 * n;
  nz[i] = (int8_t)rt::zo(rt::philox_word(i, sv, 0u, a.seed));
  nz[n + i] = (int8_t)rt::cbd(rt::philox_word(i, s0, 0u, a.seed),
                              rt::philox_word(i, s0, 1u, a.seed));
  nz[2 * n + i] = (int8_t)rt::cbd(rt::philox_word(i, s1, 0u, a.seed),
                                  rt::philox_word(i, s1, 1u, a.seed));
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

// One NTT tile of (limb l, row b): kRow, the whole row of all three
// polynomials, c0/c1 out; kColumns, a column tile of polynomial `poly` (0
// v, 1 e0 + pt, 2 e1) -> its vhat / c0 / c1 row; kChunks, a chunk tile of
// all three -> c0/c1.
template <int pass>
RT_BODY void enc_ntt_tile(const EncArgs &a, int l, int poly, int tile,
                          int b, uint32_t *x) {
  using namespace rt::tiled;
  const Geo &g = a.ng;
  const int n = 1 << g.logn;
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  const rt::MontRedc red = rt::mont_redc(trow);
  const uint32_t q = red.q;
  const uint32_t *tw = a.ntt_tw + (size_t)l * n;
  const size_t off = ((size_t)b * a.n_limbs + l) * n;
  uint32_t *const vh_row = a.vhat + off, *const c0 = a.c0 + off,
                 *const c1 = a.c1 + off;
  const int lpts = pass == kChunks ? g.lr + geo_b(g) : g.a + g.lc;
  const int pts = 1 << lpts;
  const int npoly = pass == kColumns ? 1 : 3;
  if (pass != kChunks) {
    const int8_t *nz = a.noise + (size_t)b * 3 * n;
    const int32_t *dg = a.digits + (size_t)b * 3 * n;
    const uint32_t c22 = a.digit_mont[2 * l], c44 = a.digit_mont[2 * l + 1];
    const int first = pass == kColumns ? poly : 0;
    for (int idx = RT_TID; idx < npoly << lpts; idx += RT_NT) {
      const int pl = first + (idx >> lpts);
      const int p = col_pos(g, tile, idx & (pts - 1));
      uint32_t w = rt::to_residue(nz[pl * n + p], q);
      if (pl == 1) {  // + the plaintext's residue, from its digits
        const uint32_t r0 = rt::to_residue(dg[p], q);
        const uint32_t m1 =
            rt::redc_mul(rt::to_residue(dg[n + p], q), c22, q, red.qinv);
        const uint32_t m2 =
            rt::redc_mul(rt::to_residue(dg[2 * n + p], q), c44, q, red.qinv);
        w = rt::addmod(rt::addmod(rt::addmod(r0, m1, q), m2, q), w, q);
      }
      x[idx] = w;
    }
  } else {
    for (int i = RT_TID; i < pts; i += RT_NT) {
      const int p = chunk_pos(g, tile, i);
      x[i] = vh_row[p];
      x[pts + i] = c0[p];
      x[2 * pts + i] = c1[p];
    }
  }
  RT_SYNC();
  if (pass != kChunks) ntt_fwd_lines(x, npoly, pts, col_lines(g), g, tw, red);
  if (pass != kColumns)
    ntt_fwd_lines(x, npoly, pts, chunk_lines(g, tile), g, tw, red);
  if (pass == kColumns) {
    uint32_t *dst = poly == 0 ? vh_row : (poly == 1 ? c0 : c1);
    for (int i = RT_TID; i < pts; i += RT_NT) dst[col_pos(g, tile, i)] = x[i];
    return;
  }
  const uint32_t *pkb = a.pk_b + (size_t)l * n, *pka = a.pk_a + (size_t)l * n;
  for (int i = RT_TID; i < pts; i += RT_NT) {
    const int p = chunk_pos(g, tile, i);
    const uint32_t vh = x[i];
    c0[p] = rt::addmod(rt::redc(red, vh, pkb[p]), x[pts + i], q);
    c1[p] = rt::addmod(rt::redc(red, vh, pka[p]), x[2 * pts + i], q);
  }
}

// The geometry of both transforms (geo: a, lc, lr of the NTT, then of the
// FFT; -1 takes the default, as the CUDA entry does). False if a forced one
// is out of range.
bool enc_plan(EncArgs &a, const int *geo) {
  using namespace rt::tiled;
  const long long rows = a.batch, limb_rows = (long long)a.n_limbs * a.batch;
  a.ng = plan_geo(a.logn, geo[0], geo[1], geo[2], kSinglePassLogn,
                  3 * limb_rows, limb_rows, 3, 5, 1, 3, 0);
  a.fg = plan_geo(a.logn - 1, geo[3], geo[4], geo[5], kSinglePassLognFft,
                  rows, rows, 2, 3, 2, 3, 1);
  return geo_valid(a.ng) && geo_valid(a.fg);
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
  EncArgs a = {rh, rl, ih, il, tw, rev, table, digit_mont, pk_b, pk_a,
               c0, c1, ntt_tw, noise, fft, digits, vhat, batch, n_limbs,
               logn, n_scalars, f64, delta,
               {seed0, seed1, seed2, seed3}, nonce0, {}, {}};
  return a;
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

__global__ void __launch_bounds__(kThreads)
    enc_prologue_kernel(EncArgs a, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step)
    enc_prologue_item(a, t);
}

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

__global__ void __launch_bounds__(kThreads) enc_ntt_row_kernel(EncArgs a) {
  extern __shared__ uint32_t ntt_row_smem[];
  enc_ntt_tile<rt::tiled::kRow>(a, blockIdx.x, 0, 0, blockIdx.z,
                                ntt_row_smem);
}

__global__ void __launch_bounds__(kThreads) enc_ntt_cols_kernel(EncArgs a) {
  extern __shared__ uint32_t ntt_cols_smem[];
  enc_ntt_tile<rt::tiled::kColumns>(a, blockIdx.x, blockIdx.y % 3,
                                    blockIdx.y / 3, blockIdx.z,
                                    ntt_cols_smem);
}

__global__ void __launch_bounds__(kThreads)
    enc_ntt_chunks_kernel(EncArgs a) {
  extern __shared__ uint32_t ntt_chunks_smem[];
  enc_ntt_tile<rt::tiled::kChunks>(a, blockIdx.z, 0, blockIdx.y, blockIdx.x,
                                   ntt_chunks_smem);
}

// launch one pass, its dynamic shared memory allowed first where above
// the default 48 KB (one allowance per kernel)
template <typename Kernel>
cudaError_t launch_pass(Kernel kernel, dim3 grid, size_t smem,
                        cudaStream_t s, const EncArgs &a) {
  static rt::SmemAllowance allow;
  if (smem > 48 * 1024) {
    const cudaError_t err = rt::allow_dynamic_smem(kernel, smem, allow);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int encode_encrypt_stream_launch(ENC_PARAMS, void *stream) {
  using namespace rt::tiled;
  EncArgs a = ENC_ARGS;
  const int geo[6] = {-1, -1, -1, -1, -1, -1};
  if (!enc_plan(a, geo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = ((long long)n_limbs + batch) << logn;
  const long long blocks = (total + kThreads - 1) / kThreads;
  enc_prologue_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16),
                        kThreads, 0, s>>>(a, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t f4 = 4 * sizeof(float);
  if (single_pass(a.fg)) {
    err = launch_pass(enc_fft_row_kernel, dim3(1, batch), f4 << a.fg.logn,
                      s, a);
  } else {
    err = launch_pass(enc_fft_cols_kernel, dim3(col_tiles(a.fg), batch),
                      f4 * col_points(a.fg), s, a);
    if (err == cudaSuccess)
      err = launch_pass(enc_fft_chunks_kernel,
                        dim3(chunk_tiles(a.fg), batch),
                        f4 * chunk_points(a.fg), s, a);
  }
  if (err != cudaSuccess) return (int)err;

  const size_t w4 = sizeof(uint32_t);
  if (single_pass(a.ng))
    return (int)launch_pass(enc_ntt_row_kernel, dim3(n_limbs, 1, batch),
                            3 * w4 << logn, s, a);
  err = launch_pass(enc_ntt_cols_kernel,
                    dim3(n_limbs, 3 * col_tiles(a.ng), batch),
                    w4 * col_points(a.ng), s, a);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass(enc_ntt_chunks_kernel,
                          dim3(batch, chunk_tiles(a.ng), n_limbs),
                          3 * w4 * chunk_points(a.ng), s, a);
}

#else  // host build of the same bodies (one thread per block, each pass's
       // grid in order)

#include <vector>

// The host entry takes the tile geometry too, so that tests can force
// splits and tile sizes (-1: the CUDA entry's plan).
extern "C" int encode_encrypt_stream_host(ENC_PARAMS, int a_ntt, int lc_ntt,
                                          int lr_ntt, int a_fft, int lc_fft,
                                          int lr_fft) {
  using namespace rt::tiled;
  EncArgs a = ENC_ARGS;
  const int geo[6] = {a_ntt, lc_ntt, lr_ntt, a_fft, lc_fft, lr_fft};
  if (!enc_plan(a, geo)) return 1;
  const long long total = ((long long)n_limbs + batch) << logn;
  for (long long t = 0; t < total; ++t) enc_prologue_item(a, t);

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

  std::vector<uint32_t> nsmem((size_t)3 << logn);
  const Geo &ng = a.ng;
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < n_limbs; ++l) {
      if (single_pass(ng)) {
        enc_ntt_tile<kRow>(a, l, 0, 0, b, nsmem.data());
        continue;
      }
      for (int poly = 0; poly < 3; ++poly)
        for (int t = 0; t < col_tiles(ng); ++t)
          enc_ntt_tile<kColumns>(a, l, poly, t, b, nsmem.data());
      for (int t = 0; t < chunk_tiles(ng); ++t)
        enc_ntt_tile<kChunks>(a, l, 0, t, b, nsmem.data());
    }
  return 0;
}

// The tiled NTT block alone, for the tests: an (L, rows, N) stack of
// residues through the forward (inverse = 0) or inverse transform of
// geometry (a, lc, lr), in place; tw_heap: (L, N) scratch.
extern "C" int ntt_tiled_host(uint32_t *x, const uint32_t *table,
                              uint32_t *tw_heap, int n_limbs, int rows,
                              int logn, int n_scalars, int inverse, int a,
                              int lc, int lr, int brev) {
  using namespace rt::tiled;
  const Geo g = {logn, a, lc, lr, brev};
  if (!geo_valid(g)) return 1;
  const int n = 1 << logn;
  std::vector<uint32_t> smem((size_t)n);
  uint32_t *t = smem.data();
  for (int l = 0; l < n_limbs; ++l) {
    const uint32_t *trow = table + (size_t)l * n_scalars;
    const rt::MontRedc red = rt::mont_redc(trow);
    uint32_t *tw = tw_heap + (size_t)l * n;
    for (int m = 1; m < n; ++m)
      tw[m] = heap_twiddle(trow, logn, inverse != 0, m, red);
    for (int r = 0; r < rows; ++r) {
      uint32_t *y = x + ((size_t)l * rows + r) * n;
      if (!inverse) {
        for (int c = 0; c < col_tiles(g); ++c) {
          for (int i = 0; i < col_points(g); ++i) t[i] = y[col_pos(g, c, i)];
          ntt_fwd_lines(t, 1, col_points(g), col_lines(g), g, tw, red);
          for (int i = 0; i < col_points(g); ++i) y[col_pos(g, c, i)] = t[i];
        }
        for (int c = 0; c < chunk_tiles(g); ++c) {
          for (int i = 0; i < chunk_points(g); ++i)
            t[i] = y[chunk_pos(g, c, i)];
          ntt_fwd_lines(t, 1, chunk_points(g), chunk_lines(g, c), g, tw,
                        red);
          for (int i = 0; i < chunk_points(g); ++i)
            y[chunk_pos(g, c, i)] = t[i];
        }
      } else {
        for (int c = 0; c < chunk_tiles(g); ++c) {
          for (int i = 0; i < chunk_points(g); ++i)
            t[i] = y[chunk_pos(g, c, i)];
          ntt_inv_lines(t, 1, chunk_points(g), chunk_lines(g, c), g, tw,
                        red);
          for (int i = 0; i < chunk_points(g); ++i)
            y[chunk_pos(g, c, i)] = t[i];
        }
        const uint32_t ninv = trow[rt::OFF_NINV];
        for (int c = 0; c < col_tiles(g); ++c) {
          for (int i = 0; i < col_points(g); ++i) t[i] = y[col_pos(g, c, i)];
          ntt_inv_lines(t, 1, col_points(g), col_lines(g), g, tw, red);
          for (int i = 0; i < col_points(g); ++i)
            y[col_pos(g, c, i)] = rt::redc(red, t[i], ninv);
        }
      }
    }
  }
  return 0;
}

#endif
