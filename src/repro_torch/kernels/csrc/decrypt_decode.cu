// decrypt+decode megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/client_stream.py
// :_decrypt_decode_kernel (pallas_call in decrypt_decode_stream), both of
// its datapaths: per limb (2) m = INTT(c0 + c1*s); the two-limb CRT to the
// centered value and /scale, bit-reversal, df32 SpecialFFT; four (B, N/2)
// float32 planes out.
//   df32: uint32 word-pair CRT, exact /scale (a float32 power of two) to a
//         df32 pair;
//   f64:  64-bit-integer CRT products and df64 sum and centring, then
//         hi/scale + lo/scale in float64 (any float64 scale: the scales a
//         server's ct x ct rescales leave), split to a df32 pair.
// Bit-identical to the plain version
// (client_stream.decrypt_decode_stream_plain) and to the JAX reference.
//
// One entry point launches, on the caller's stream, three device kernels
// on rows that fit one tile (logn <= 11) and five on larger ones:
//   1. dec_prologue_kernel: the two limbs' inverse NTT twiddle heaps
//      (2, N) (ntt_tiled.cuh), made once per call;
//   2. the INTT tiled in two passes, grid (2, tiles, B):
//      dec_ntt_chunks_kernel forms c0 + c1*s in its load,
//      dec_ntt_cols_kernel folds N^-1 into its store; m (B, 2, N) between
//      and after;
//   3. the SpecialFFT tiled in two passes, grid (tiles, B):
//      dec_fft_chunks_kernel's load gathers both limbs at the bit-reversed
//      positions and does the CRT and /scale, dec_fft_cols_kernel writes
//      the four planes (which hold the points between the passes).
// A row that fits one tile runs each transform as one pass instead,
// dec_ntt_row_kernel (one block per (limb, row)) and dec_fft_row_kernel
// (one per row).
//
// What bounds it on an H100: it reads 2*B*2*N*4 bytes of ciphertext and
// writes 4*B*(N/2)*4 bytes of planes (25.7 MB at the paper profile,
// B = 16); the INTT (16 stages) and the df32 FFT (15 stages of complex df
// multiplies) need more time at the card's integer and float rates than
// those bytes need at its memory rate: operations bound it at B = 16, and
// the latency of its chain of dependent stages at B = 1. The stages run in
// shared memory (the INTT's two per barrier in registers), a row crosses
// device memory twice per transform and spreads over many blocks (tens a
// pass at B = 1, hundreds at B = 16), and the twiddles are made once; at
// B = 1 the five launches' latency is most of what is left.
// The f64 CRT's two 64-bit remainders per coefficient are library
// routines on the card (tens of instructions). Times: PERF.md §6.
#include "ntt_tiled.cuh"

namespace {

using rt::tiled::Geo;

struct DecArgs {
  const uint32_t *c0, *c1;  // (B, >=2, N) with row stride `row_stride`
  long long row_stride;
  const uint32_t *s_mont;   // (>=2, N)
  const void *scale;        // (B,) float32 powers of two (df32) or
                            // float64 (f64)
  const float *tw;          // (4, ns) packed forward twiddles
  const int32_t *rev;       // (ns,)
  const uint32_t *table;    // (2, K) seed table
  float *rh, *rl, *ih, *il; // (B, ns) outputs, the FFT's points between
                            // its passes
  uint32_t *m;              // (B, 2, N) scratch
  uint32_t *ntt_tw;         // (2, N) inverse twiddle heaps
  int batch, logn, n_scalars;
  int f64;                  // datapath: 0 df32, 1 f64
  rt::Crt2 crt;
  rt::Crt2F64 crt64;
  Geo ng, fg;               // NTT and FFT (rows of ns) geometry
};

// item t < 2N: limb t / N's heap twiddle t % N (slot 0 unused)
RT_FN void dec_prologue_item(const DecArgs &a, int t) {
  rt::tiled::heap_word(a.table, a.n_scalars, a.logn, true, a.ntt_tw, t);
}

// One INTT tile of (limb l, row b): kRow, the whole row; kChunks, c0 +
// c1*s -> m; kColumns, m -> m with N^-1 folded in.
template <int pass>
RT_BODY void dec_ntt_tile(const DecArgs &a, int l, int tile, int b,
                          uint32_t *x) {
  using namespace rt::tiled;
  const Geo &g = a.ng;
  const int n = 1 << g.logn;
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  const rt::MontRedc red = rt::mont_redc(trow);
  const uint32_t *tw = a.ntt_tw + (size_t)l * n;
  uint32_t *m = a.m + ((size_t)b * 2 + l) * n;
  const int pts = pass == kColumns ? col_points(g) : chunk_points(g);
  if (pass != kColumns) {
    const size_t row = (size_t)b * a.row_stride + (size_t)l * n;
    const uint32_t *x0 = a.c0 + row, *x1 = a.c1 + row;
    const uint32_t *s = a.s_mont + (size_t)l * n;
    for (int i = RT_TID; i < pts; i += RT_NT) {
      const int p = chunk_pos(g, tile, i);
      x[i] = rt::addmod(x0[p], rt::redc(red, x1[p], s[p]), red.q);
    }
  } else {
    for (int i = RT_TID; i < pts; i += RT_NT) x[i] = m[col_pos(g, tile, i)];
  }
  RT_SYNC();
  if (pass != kColumns)
    ntt_inv_lines(x, 1, pts, chunk_lines(g, tile), g, tw, red);
  if (pass != kChunks) ntt_inv_lines(x, 1, pts, col_lines(g), g, tw, red);
  if (pass == kChunks) {
    for (int i = RT_TID; i < pts; i += RT_NT) m[chunk_pos(g, tile, i)] = x[i];
    return;
  }
  const uint32_t ninv = trow[rt::OFF_NINV];
  for (int i = RT_TID; i < pts; i += RT_NT)
    m[col_pos(g, tile, i)] = rt::redc(red, x[i], ninv);
}

// One SpecialFFT tile of row b: kRow, the whole row; kChunks, m -> planes
// through the CRT, /scale and the bit reversal; kColumns, planes ->
// planes.
template <int pass>
RT_BODY void dec_fft_tile(const DecArgs &a, int tile, int b, float *smem) {
  using namespace rt::tiled;
  const Geo &g = a.fg;
  const int ns = 1 << g.logn;
  const int pts = pass == kColumns ? col_points(g) : chunk_points(g);
  const rt::Planes x = smem_planes(smem, pts);
  const size_t row = (size_t)b * ns;
  const rt::Planes out = {a.rh + row, a.rl + row, a.ih + row, a.il + row};
  if (pass != kColumns) {
    const uint32_t *m0 = a.m + (size_t)b * 4 * ns;
    const uint32_t *m1 = m0 + 2 * ns;
    // point p takes coefficients rev[p] (re) and ns + rev[p] (im)
    for (int k = RT_TID; k < pts; k += RT_NT) {
      const int i = chunk_slot_across(g, k);
      const int j = a.rev[chunk_pos(g, tile, i)];
      rt::dfc z;
      if (a.f64) {
        const double s = static_cast<const double *>(a.scale)[b];
        const rt::dd vr = rt::crt2_to_dd(m0[j], m1[j], a.crt64);
        const rt::dd vi = rt::crt2_to_dd(m0[ns + j], m1[ns + j], a.crt64);
        z.re = rt::df_from(rt_ddiv(vr.hi, s) + rt_ddiv(vr.lo, s));
        z.im = rt::df_from(rt_ddiv(vi.hi, s) + rt_ddiv(vi.lo, s));
      } else {
        const float inv = 1.0f / static_cast<const float *>(a.scale)[b];
        z.re = rt::crt2_to_df(m0[j], m1[j], a.crt, inv);
        z.im = rt::crt2_to_df(m0[ns + j], m1[ns + j], a.crt, inv);
      }
      rt::store_dfc(x, i, z);
    }
  } else {
    for (int i = RT_TID; i < pts; i += RT_NT)
      rt::store_dfc(x, i, rt::load_dfc(out, col_pos(g, tile, i)));
  }
  RT_SYNC();
  if (pass != kColumns) fft_fwd_chunks(x, g, a.tw);
  if (pass != kChunks) fft_fwd_cols(x, g, tile, a.tw);
  for (int i = RT_TID; i < pts; i += RT_NT) {
    const int p =
        pass == kChunks ? chunk_pos(g, tile, i) : col_pos(g, tile, i);
    rt::store_dfc(out, p, rt::load_dfc(x, i));
  }
}

// The geometry of both transforms (geo: a, lc, lr of the NTT, then of the
// FFT; -1 takes the default, as the CUDA entry does). False if a forced one
// is out of range.
bool dec_plan(DecArgs &a, const int *geo) {
  using namespace rt::tiled;
  const long long rows = a.batch, limb_rows = 2LL * a.batch;
  a.ng = plan_geo(a.logn, geo[0], geo[1], geo[2], kSinglePassLogn,
                  limb_rows, limb_rows, 3, 5, 1, 3, 0);
  a.fg = fft_geo(a.logn - 1, geo[3], geo[4], geo[5], rows);
  return geo_valid(a.ng) && geo_valid(a.fg);
}

DecArgs dec_args(const uint32_t *c0, const uint32_t *c1,
                 long long row_stride, const uint32_t *s_mont,
                 const void *scale, const float *tw, const int32_t *rev,
                 const uint32_t *table, float *rh, float *rl, float *ih,
                 float *il, uint32_t *m, uint32_t *ntt_tw, int batch,
                 int logn, int n_scalars, int f64, uint32_t q0, uint32_t q1,
                 uint32_t g0_mont, uint32_t g1_mont, uint32_t qinv0,
                 uint32_t qinv1, uint32_t g0, uint32_t g1,
                 unsigned long long qq, unsigned long long half) {
  DecArgs a = {c0, c1, row_stride, s_mont, scale, tw, rev, table, rh, rl,
               ih, il, m, ntt_tw, batch, logn, n_scalars, f64,
               {q0, q1, g0_mont, g1_mont, qinv0, qinv1, qq, half},
               {q0, q1, g0, g1, (double)qq}, {}, {}};
  return a;
}

}  // namespace

#define DEC_PARAMS                                                          \
  const uint32_t *c0, const uint32_t *c1, long long row_stride,             \
      const uint32_t *s_mont, const void *scale, const float *tw,           \
      const int32_t *rev, const uint32_t *table, float *rh, float *rl,      \
      float *ih, float *il, uint32_t *m_scratch, uint32_t *ntt_tw,          \
      int batch, int logn, int n_scalars, int f64, uint32_t q0,             \
      uint32_t q1, uint32_t g0_mont, uint32_t g1_mont, uint32_t qinv0,      \
      uint32_t qinv1, uint32_t g0, uint32_t g1, unsigned long long qq,      \
      unsigned long long half
#define DEC_ARGS                                                            \
  dec_args(c0, c1, row_stride, s_mont, scale, tw, rev, table, rh, rl, ih,   \
           il, m_scratch, ntt_tw, batch, logn, n_scalars, f64, q0, q1,      \
           g0_mont, g1_mont, qinv0, qinv1, g0, g1, qq, half)

#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dec_prologue_kernel(DecArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 2 << a.logn) dec_prologue_item(a, t);
}

// one kernel per pass, so that a profile shows each under its own name
__global__ void __launch_bounds__(kThreads) dec_ntt_row_kernel(DecArgs a) {
  extern __shared__ uint32_t ntt_row_smem[];
  dec_ntt_tile<rt::tiled::kRow>(a, blockIdx.x, 0, blockIdx.z, ntt_row_smem);
}

__global__ void __launch_bounds__(kThreads)
    dec_ntt_chunks_kernel(DecArgs a) {
  extern __shared__ uint32_t ntt_chunks_smem[];
  dec_ntt_tile<rt::tiled::kChunks>(a, blockIdx.x, blockIdx.y, blockIdx.z,
                                   ntt_chunks_smem);
}

__global__ void __launch_bounds__(kThreads) dec_ntt_cols_kernel(DecArgs a) {
  extern __shared__ uint32_t ntt_cols_smem[];
  dec_ntt_tile<rt::tiled::kColumns>(a, blockIdx.x, blockIdx.y, blockIdx.z,
                                    ntt_cols_smem);
}

__global__ void __launch_bounds__(kThreads) dec_fft_row_kernel(DecArgs a) {
  extern __shared__ float fft_row_smem[];
  dec_fft_tile<rt::tiled::kRow>(a, 0, blockIdx.y, fft_row_smem);
}

__global__ void __launch_bounds__(kThreads)
    dec_fft_chunks_kernel(DecArgs a) {
  extern __shared__ float fft_chunks_smem[];
  dec_fft_tile<rt::tiled::kChunks>(a, blockIdx.x, blockIdx.y,
                                   fft_chunks_smem);
}

__global__ void __launch_bounds__(kThreads) dec_fft_cols_kernel(DecArgs a) {
  extern __shared__ float fft_cols_smem[];
  dec_fft_tile<rt::tiled::kColumns>(a, blockIdx.x, blockIdx.y,
                                    fft_cols_smem);
}

}  // namespace

extern "C" int decrypt_decode_stream_launch(DEC_PARAMS, void *stream) {
  using namespace rt::tiled;
  DecArgs a = DEC_ARGS;
  const int geo[6] = {-1, -1, -1, -1, -1, -1};
  if (!dec_plan(a, geo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dec_prologue_kernel<<<((2 << logn) + kThreads - 1) / kThreads, kThreads,
                        0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  static rt::SmemAllowance allow[6];  // one per kernel
  const size_t w4 = sizeof(uint32_t);
  if (single_pass(a.ng)) {
    err = launch_pass(dec_ntt_row_kernel, allow[0], dim3(2, 1, batch),
                      kThreads, w4 << logn, s, a);
  } else {
    err = launch_pass(dec_ntt_chunks_kernel, allow[1],
                      dim3(2, chunk_tiles(a.ng), batch), kThreads,
                      w4 * chunk_points(a.ng), s, a);
    if (err == cudaSuccess)
      err = launch_pass(dec_ntt_cols_kernel, allow[2],
                        dim3(2, col_tiles(a.ng), batch), kThreads,
                        w4 * col_points(a.ng), s, a);
  }
  if (err != cudaSuccess) return (int)err;

  const size_t f4 = 4 * sizeof(float);
  if (single_pass(a.fg))
    return (int)launch_pass(dec_fft_row_kernel, allow[3], dim3(1, batch),
                            kThreads, f4 << a.fg.logn, s, a);
  err = launch_pass(dec_fft_chunks_kernel, allow[4],
                    dim3(chunk_tiles(a.fg), batch), kThreads,
                    f4 * chunk_points(a.fg), s, a);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass(dec_fft_cols_kernel, allow[5],
                          dim3(col_tiles(a.fg), batch), kThreads,
                          f4 * col_points(a.fg), s, a);
}

#else  // host build of the same bodies (one thread per block, each pass's
       // grid in order)

#include <vector>

// The host entry takes the tile geometry too, so that tests can force
// splits and tile sizes (-1: the CUDA entry's plan).
extern "C" int decrypt_decode_stream_host(DEC_PARAMS, int a_ntt, int lc_ntt,
                                          int lr_ntt, int a_fft, int lc_fft,
                                          int lr_fft) {
  using namespace rt::tiled;
  DecArgs a = DEC_ARGS;
  const int geo[6] = {a_ntt, lc_ntt, lr_ntt, a_fft, lc_fft, lr_fft};
  if (!dec_plan(a, geo)) return 1;
  for (int t = 0; t < 2 << logn; ++t) dec_prologue_item(a, t);

  std::vector<uint32_t> nsmem((size_t)1 << logn);
  const Geo &ng = a.ng;
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < 2; ++l) {
      if (single_pass(ng)) {
        dec_ntt_tile<kRow>(a, l, 0, b, nsmem.data());
        continue;
      }
      for (int t = 0; t < chunk_tiles(ng); ++t)
        dec_ntt_tile<kChunks>(a, l, t, b, nsmem.data());
      for (int t = 0; t < col_tiles(ng); ++t)
        dec_ntt_tile<kColumns>(a, l, t, b, nsmem.data());
    }

  std::vector<float> fsmem((size_t)4 << a.fg.logn);
  const Geo &fg = a.fg;
  for (int b = 0; b < batch; ++b) {
    if (single_pass(fg)) {
      dec_fft_tile<kRow>(a, 0, b, fsmem.data());
      continue;
    }
    for (int t = 0; t < chunk_tiles(fg); ++t)
      dec_fft_tile<kChunks>(a, t, b, fsmem.data());
    for (int t = 0; t < col_tiles(fg); ++t)
      dec_fft_tile<kColumns>(a, t, b, fsmem.data());
  }
  return 0;
}

#endif
