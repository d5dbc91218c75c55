// df32 SpecialFFT / SpecialIFFT for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel src/repro/kernels/fft_df.py:_kernel (built by
// _build for special_fft_planes / special_ifft_planes): the canonical-
// embedding transform over rows of n complex slots held as four float32
// planes (re_hi, re_lo, im_hi, im_lo), with 5^j rotation-group twiddles
// from the packed (4, n) table of the direction. Forward (decode):
// Cooley-Tukey stages, length 2 .. n, on bit-reversed input. Inverse
// (encode): Gentleman-Sande stages, length n .. 2, then the 1/n scale; the
// output is bit-reversed afterwards. As in the reference the bit-reversal
// stays outside the kernel (a torch gather in fft_df.special_*_planes).
// Output planes are bit-identical to the plain version
// (fft_df.fft_rows_plain) and to the JAX reference: the float code is
// client_common.cuh's, compiled with --fmad=false.
//
// Grid (rows,): one block per row copies the row's four planes into the
// output planes and runs the stage loop (rt::fft_fwd_stages /
// rt::fft_inv_stages) in place on them, then (inverse) scales by 1/n.
// At the paper profile a row is 32768 slots (512 KB of planes) and the
// table 512 KB, both above a block's 227 KB of shared memory, so the
// stages run on the global-memory copy, a barrier per stage.
//
// What bounds it on an H100: per row (log n) * n/2 butterflies of 168
// float32 operations (a complex df multiply, add and subtract) against 32
// bytes of plane traffic per slot: operations. With one block per row the
// grid fills only `rows` of 132 SMs.
#include "client_common.cuh"

namespace {

struct FftArgs {
  const float *rh, *rl, *ih, *il;  // (rows, n) input planes
  float *orh, *orl, *oih, *oil;    // (rows, n) output planes
  const float *tw;                 // (4, n) packed twiddles of the direction
  int logns;
  bool inverse;
};

RT_BODY void fft_row(const FftArgs &a, int r) {
  const int n = 1 << a.logns;
  const size_t row = (size_t)r * n;
  rt::Planes x = {a.orh + row, a.orl + row, a.oih + row, a.oil + row};
  for (int i = RT_TID; i < n; i += RT_NT) {
    x.rh[i] = a.rh[row + i];
    x.rl[i] = a.rl[row + i];
    x.ih[i] = a.ih[row + i];
    x.il[i] = a.il[row + i];
  }
  RT_SYNC();
  if (!a.inverse) {
    rt::fft_fwd_stages(x, a.logns, a.tw);
    return;
  }
  rt::fft_inv_stages(x, a.logns, a.tw);
  for (int i = RT_TID; i < n; i += RT_NT)
    rt::store_dfc(x, i, rt::ifft_scale(rt::load_dfc(x, i), a.logns));
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) fft_rows_kernel(FftArgs a) {
  fft_row(a, blockIdx.x);
}

}  // namespace

extern "C" int fft_rows_launch(const float *rh, const float *rl,
                               const float *ih, const float *il, float *orh,
                               float *orl, float *oih, float *oil,
                               const float *tw, int rows, int logns,
                               int inverse, void *stream) {
  FftArgs a = {rh, rl, ih, il, orh, orl, oih, oil, tw, logns, inverse != 0};
  fft_rows_kernel<<<rows, 1024, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block body (one thread per block)

extern "C" int fft_rows_host(const float *rh, const float *rl,
                             const float *ih, const float *il, float *orh,
                             float *orl, float *oih, float *oil,
                             const float *tw, int rows, int logns,
                             int inverse) {
  FftArgs a = {rh, rl, ih, il, orh, orl, oih, oil, tw, logns, inverse != 0};
  for (int r = 0; r < rows; ++r) fft_row(a, r);
  return 0;
}

#endif
