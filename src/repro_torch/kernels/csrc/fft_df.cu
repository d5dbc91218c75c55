// df32 SpecialFFT / SpecialIFFT for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel src/repro/kernels/fft_df.py:_kernel (built by
// _build for special_fft_planes / special_ifft_planes) together with the
// bit reversal the reference does around it (a gather before the forward
// stages, after the inverse ones): the canonical-embedding transform over
// rows of n complex slots held as four float32 planes (re_hi, re_lo,
// im_hi, im_lo), with 5^j rotation-group twiddles from the packed (4, n)
// table of the direction. Forward (decode): bit reversal, then
// Cooley-Tukey stages, length 2 .. n. Inverse (encode): Gentleman-Sande
// stages, length n .. 2, the 1/n scale, then bit reversal. Output planes
// are bit-identical to the plain version (fft_df.special_fft_plain: the
// torch gather and fft_df.fft_rows_plain) and to the JAX reference: the
// float code is client_common.cuh's, compiled with --fmad=false.
//
// The transform is K6's (forward) and K5's (inverse) tiled SpecialFFT on
// ntt_tiled.cuh: a row of 2^logn points is a 2^a x 2^b matrix, and one
// entry call launches, on the caller's stream, two passes of tiles held in
// shared memory (fft_geo: hundreds of blocks a pass at B = 16), or one
// pass, a block a row, on rows of at most 2^10 points:
//   forward: special_fft_chunks_kernel gathers each point of its tile from
//     the input at the bit-reversed position, runs the stages of half
//     length < 2^b and stores to the output planes; special_fft_cols_kernel
//     runs the rest there, in place;
//   inverse: special_ifft_cols_kernel reads the input, runs the stages of
//     half length >= 2^b and stores point p to the output planes at
//     bitrev(p); special_ifft_chunks_kernel reads its points back from
//     there, runs the rest, applies 1/n and writes each point where it read
//     it (bitrev(p), the reference's gather after the stages). The output
//     planes hold the points between the passes in both directions, and
//     each chunk tile of the inverse reads and overwrites one set of words:
//     nothing more is allocated, and no block writes what another reads.
// The input planes are read through one row stride (the staged decode
// passes (B, N) -> (B, N/2) views).
//
// What bounds it on an H100: per row (log n) * n/2 butterflies of 168
// float32 operations (a complex df multiply, add and subtract) against 32
// bytes of plane traffic per slot: operations. A row crosses device memory
// twice (once on one pass), the stages run in shared memory, and the bit
// reversal meets runs of 2^lr words (chunk tiles in bit-reversed order).
// Times against the bound: PERF.md §6.
#include "ntt_tiled.cuh"

namespace {

using rt::tiled::Geo;

struct FftArgs {
  const float *rh, *rl, *ih, *il;  // (rows, n) input planes, row stride
  long long in_stride;             // `in_stride`
  float *orh, *orl, *oih, *oil;    // (rows, n) output planes, contiguous
  const float *tw;                 // (4, n) packed twiddles of the direction
  Geo g;
};

RT_FN rt::Planes out_row(const FftArgs &a, long long b) {
  const size_t row = (size_t)b << a.g.logn;
  return rt::Planes{a.orh + row, a.orl + row, a.oih + row, a.oil + row};
}

// input point p of row b into slot i
RT_FN void load_in(const FftArgs &a, long long b, int p, rt::Planes x,
                   int i) {
  const size_t j = (size_t)b * a.in_stride + p;
  x.rh[i] = a.rh[j];
  x.rl[i] = a.rl[j];
  x.ih[i] = a.ih[j];
  x.il[i] = a.il[j];
}

RT_FN int rev(const Geo &g, int p) {
  return (int)rt_brev((uint32_t)p, g.logn);
}

// One forward tile of row b: kRow, the whole row; kChunks, input (gathered
// at the bit-reversed positions) -> output; kColumns, output -> output.
template <int pass>
RT_BODY void fft_fwd_tile(const FftArgs &a, int tile, long long b,
                          float *smem) {
  using namespace rt::tiled;
  const Geo &g = a.g;
  const int pts = pass == kColumns ? col_points(g) : chunk_points(g);
  const rt::Planes x = smem_planes(smem, pts);
  const rt::Planes out = out_row(a, b);
  if (pass != kColumns) {
    for (int k = RT_TID; k < pts; k += RT_NT) {
      const int i = chunk_slot_across(g, k);
      load_in(a, b, rev(g, chunk_pos(g, tile, i)), x, i);
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

// One inverse tile of row b: kRow, the whole row; kColumns, input ->
// output at the bit-reversed positions; kChunks, output -> output at the
// same positions, 1/n applied.
template <int pass>
RT_BODY void fft_inv_tile(const FftArgs &a, int tile, long long b,
                          float *smem) {
  using namespace rt::tiled;
  const Geo &g = a.g;
  const int pts = pass == kChunks ? chunk_points(g) : col_points(g);
  const rt::Planes x = smem_planes(smem, pts);
  const rt::Planes out = out_row(a, b);
  if (pass != kChunks) {
    for (int i = RT_TID; i < pts; i += RT_NT)
      load_in(a, b, col_pos(g, tile, i), x, i);
  } else {
    for (int k = RT_TID; k < pts; k += RT_NT) {
      const int i = chunk_slot_across(g, k);
      rt::store_dfc(x, i, rt::load_dfc(out, rev(g, chunk_pos(g, tile, i))));
    }
  }
  RT_SYNC();
  if (pass != kChunks) fft_inv_cols(x, g, tile, a.tw);
  if (pass != kColumns) fft_inv_chunks(x, g, a.tw);
  if (pass == kColumns) {
    for (int k = RT_TID; k < pts; k += RT_NT) {
      const int i = col_slot_across(g, k);
      rt::store_dfc(out, rev(g, col_pos(g, tile, i)), rt::load_dfc(x, i));
    }
    return;
  }
  for (int k = RT_TID; k < pts; k += RT_NT) {
    const int i = chunk_slot_across(g, k);
    rt::store_dfc(out, rev(g, chunk_pos(g, tile, i)),
                  rt::ifft_scale(rt::load_dfc(x, i), g.logn));
  }
}

// block blk of a pass: row blk >> log tiles, tile the rest
template <int pass>
RT_BODY void fft_tile(const FftArgs &a, bool inverse, long long blk,
                      float *smem) {
  const int lt = rt::tiled::log_tiles(a.g, pass);
  const int tile = (int)(blk & ((1 << lt) - 1));
  if (inverse)
    fft_inv_tile<pass>(a, tile, blk >> lt, smem);
  else
    fft_fwd_tile<pass>(a, tile, blk >> lt, smem);
}

// The arguments and geometry of a call (a, lc, lr < 0: the CUDA entry's
// plan); false if a forced geometry is out of range or a pass's grid
// exceeds a grid's x extent.
bool fft_plan(FftArgs &a, int rows, int logn, int ga, int lc, int lr) {
  a.g = rt::tiled::fft_geo(logn, ga, lc, lr, rows);
  return rt::tiled::stage_fits(a.g, rows);
}

}  // namespace

#define FFT_PARAMS                                                          \
  const float *rh, const float *rl, const float *ih, const float *il,       \
      long long in_stride, float *orh, float *orl, float *oih, float *oil,  \
      const float *tw, int rows, int logn, int inverse
#define FFT_ARGS {rh, rl, ih, il, in_stride, orh, orl, oih, oil, tw, {}}

#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 256;

template <int pass>
__device__ void fft_pass(const FftArgs &a, bool inverse) {
  extern __shared__ float fft_smem[];
  fft_tile<pass>(a, inverse, blockIdx.x, fft_smem);
}

// one kernel per (direction, pass), so that a profile shows each under its
// own name
__global__ void __launch_bounds__(kThreads)
    special_fft_row_kernel(FftArgs a) {
  fft_pass<rt::tiled::kRow>(a, false);
}
__global__ void __launch_bounds__(kThreads)
    special_fft_chunks_kernel(FftArgs a) {
  fft_pass<rt::tiled::kChunks>(a, false);
}
__global__ void __launch_bounds__(kThreads)
    special_fft_cols_kernel(FftArgs a) {
  fft_pass<rt::tiled::kColumns>(a, false);
}
__global__ void __launch_bounds__(kThreads)
    special_ifft_row_kernel(FftArgs a) {
  fft_pass<rt::tiled::kRow>(a, true);
}
__global__ void __launch_bounds__(kThreads)
    special_ifft_cols_kernel(FftArgs a) {
  fft_pass<rt::tiled::kColumns>(a, true);
}
__global__ void __launch_bounds__(kThreads)
    special_ifft_chunks_kernel(FftArgs a) {
  fft_pass<rt::tiled::kChunks>(a, true);
}

}  // namespace

extern "C" int special_fft_launch(FFT_PARAMS, void *stream) {
  using namespace rt::tiled;
  FftArgs a = FFT_ARGS;
  if (!fft_plan(a, rows, logn, -1, -1, -1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  static rt::SmemAllowance allow[6];  // one per kernel
  const size_t f4 = 4 * sizeof(float);
  const int d = inverse ? 3 : 0;
  if (single_pass(a.g))
    return (int)launch_pass(
        inverse ? special_ifft_row_kernel : special_fft_row_kernel, allow[d],
        dim3((unsigned)rows), kThreads, f4 << logn, s, a);
  // forward: the chunk pass, then the column pass; inverse: the reverse
  for (int step = 0; step < 2; ++step) {
    const bool col_pass = (step == 0) == (inverse != 0);
    const int pass = col_pass ? kColumns : kChunks;
    void (*kernel)(FftArgs) =
        inverse ? (col_pass ? special_ifft_cols_kernel
                            : special_ifft_chunks_kernel)
                : (col_pass ? special_fft_cols_kernel
                            : special_fft_chunks_kernel);
    const cudaError_t err = launch_pass(
        kernel, allow[d + 1 + (col_pass ? 1 : 0)],
        dim3((unsigned)pass_blocks(a.g, pass, rows)), kThreads,
        f4 * (col_pass ? col_points(a.g) : chunk_points(a.g)), s, a);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

#else  // host build of the same bodies (one thread per block, each pass's
       // blocks in order)

#include <vector>

// The host entry takes the tile geometry too, so that tests can force
// splits and tile sizes (-1: the CUDA entry's plan).
extern "C" int special_fft_host(FFT_PARAMS, int ga, int lc, int lr) {
  using namespace rt::tiled;
  FftArgs a = FFT_ARGS;
  if (!fft_plan(a, rows, logn, ga, lc, lr)) return 1;
  std::vector<float> smem((size_t)4 << logn);
  const bool inv = inverse != 0;
  if (single_pass(a.g)) {
    for (long long blk = 0; blk < rows; ++blk)
      fft_tile<kRow>(a, inv, blk, smem.data());
    return 0;
  }
  for (int step = 0; step < 2; ++step) {
    if ((step == 0) == inv) {
      for (long long blk = 0; blk < pass_blocks(a.g, kColumns, rows); ++blk)
        fft_tile<kColumns>(a, inv, blk, smem.data());
    } else {
      for (long long blk = 0; blk < pass_blocks(a.g, kChunks, rows); ++blk)
        fft_tile<kChunks>(a, inv, blk, smem.data());
    }
  }
  return 0;
}

#endif
