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
// Two kernels launched back to back on the caller's stream by one entry
// point:
//   1. decrypt_limbs_kernel, grid (2, B): one block per (limb, row) forms
//      c0 + c1*s into a (B, 2, N) scratch row and runs the INTT stage loop
//      on it in place (rt::decrypt_limb_block, shared with the staged
//      kernel K3);
//   2. decode_rows_kernel, grid (B): one block per row recombines the two
//      limbs, scales, bit-reverses into the output planes and runs the
//      SpecialFFT stages in place on them.
//
// What bounds it on an H100: it reads 2*B*2*N*4 bytes of ciphertext and
// writes 4*B*(N/2)*4 bytes of planes (25.7 MB at the paper profile,
// B = 16); the INTT (16 stages) and the df32 FFT (15 stages of complex df
// multiplies) need more time at the card's integer and float rates than
// those bytes need at its memory rate: operations bound it. This first
// version stages every butterfly through global memory (rows of 256 KB do
// not fit shared memory) with a block barrier between stages, and phase 2
// runs on only B of 132 SMs. The f64 CRT's two 64-bit remainders per
// coefficient are library routines on the card (tens of instructions).
#include "client_common.cuh"

namespace {

struct DecArgs {
  const uint32_t *c0, *c1;  // (B, >=2, N) with row stride `row_stride`
  long long row_stride;
  const uint32_t *s_mont;   // (>=2, N)
  const void *scale;        // (B,) float32 powers of two (df32) or
                            // float64 (f64)
  const float *tw;          // (4, ns) packed forward twiddles
  const int32_t *rev;       // (ns,)
  const uint32_t *table;    // (2, K) seed table
  float *rh, *rl, *ih, *il; // (B, ns) outputs
  uint32_t *m;              // (B, 2, N) scratch
  int logn, n_scalars;
  int f64;                  // datapath: 0 df32, 1 f64
  rt::Crt2 crt;
  rt::Crt2F64 crt64;
};

RT_BODY void decrypt_limb(const DecArgs &a, int l, int b, uint32_t *tw) {
  const int n = 1 << a.logn;
  const size_t row = (size_t)b * a.row_stride + (size_t)l * n;
  rt::decrypt_limb_block(a.c0 + row, a.c1 + row, a.s_mont + (size_t)l * n,
                         a.m + ((size_t)b * 2 + l) * n, a.logn,
                         a.table + (size_t)l * a.n_scalars, tw);
}

RT_BODY void decode_row(const DecArgs &a, int b) {
  const int logns = a.logn - 1;
  const int ns = 1 << logns;
  const int n = 1 << a.logn;
  const uint32_t *m0 = a.m + (size_t)b * 2 * n;
  const uint32_t *m1 = m0 + n;
  const size_t row = (size_t)b * ns;
  rt::Planes x = {a.rh + row, a.rl + row, a.ih + row, a.il + row};
  if (a.f64) {
    const double s = static_cast<const double *>(a.scale)[b];
    for (int j = RT_TID; j < ns; j += RT_NT) {
      const int k = a.rev[j];
      const rt::dd vr = rt::crt2_to_dd(m0[k], m1[k], a.crt64);
      const rt::dd vi = rt::crt2_to_dd(m0[ns + k], m1[ns + k], a.crt64);
      rt::dfc z;
      z.re = rt::df_from(rt_ddiv(vr.hi, s) + rt_ddiv(vr.lo, s));
      z.im = rt::df_from(rt_ddiv(vi.hi, s) + rt_ddiv(vi.lo, s));
      rt::store_dfc(x, j, z);
    }
  } else {
    const float inv = 1.0f / static_cast<const float *>(a.scale)[b];
    for (int j = RT_TID; j < ns; j += RT_NT) {
      const int k = a.rev[j];
      rt::dfc z;
      z.re = rt::crt2_to_df(m0[k], m1[k], a.crt, inv);
      z.im = rt::crt2_to_df(m0[ns + k], m1[ns + k], a.crt, inv);
      rt::store_dfc(x, j, z);
    }
  }
  RT_SYNC();
  rt::fft_fwd_stages(x, logns, a.tw);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) decrypt_limbs_kernel(DecArgs a) {
  extern __shared__ uint32_t tw_smem[];
  decrypt_limb(a, blockIdx.x, blockIdx.y, tw_smem);
}

__global__ void __launch_bounds__(1024) decode_rows_kernel(DecArgs a) {
  decode_row(a, blockIdx.x);
}

}  // namespace

extern "C" int decrypt_decode_stream_launch(
    const uint32_t *c0, const uint32_t *c1, long long row_stride,
    const uint32_t *s_mont, const void *scale, const float *tw,
    const int32_t *rev, const uint32_t *table, float *rh, float *rl,
    float *ih, float *il, uint32_t *m_scratch, int batch, int logn,
    int n_scalars, int f64, uint32_t q0, uint32_t q1, uint32_t g0_mont,
    uint32_t g1_mont, uint32_t qinv0, uint32_t qinv1, uint32_t g0,
    uint32_t g1, unsigned long long qq, unsigned long long half,
    void *stream) {
  DecArgs a = {c0, c1, row_stride, s_mont, scale, tw, rev, table, rh, rl,
               ih, il, m_scratch, logn, n_scalars, f64,
               {q0, q1, g0_mont, g1_mont, qinv0, qinv1, qq, half},
               {q0, q1, g0, g1, (double)qq}};
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 1024;
  const size_t smem = sizeof(uint32_t) << (logn - 1);  // one stage's twiddles
  static rt::SmemAllowance allowance;
  cudaError_t err =
      rt::allow_dynamic_smem(decrypt_limbs_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  decrypt_limbs_kernel<<<dim3(2, batch), threads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_rows_kernel<<<batch, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block bodies (one thread per block)

#include <vector>

extern "C" int decrypt_decode_stream_host(
    const uint32_t *c0, const uint32_t *c1, long long row_stride,
    const uint32_t *s_mont, const void *scale, const float *tw,
    const int32_t *rev, const uint32_t *table, float *rh, float *rl,
    float *ih, float *il, uint32_t *m_scratch, int batch, int logn,
    int n_scalars, int f64, uint32_t q0, uint32_t q1, uint32_t g0_mont,
    uint32_t g1_mont, uint32_t qinv0, uint32_t qinv1, uint32_t g0,
    uint32_t g1, unsigned long long qq, unsigned long long half) {
  DecArgs a = {c0, c1, row_stride, s_mont, scale, tw, rev, table, rh, rl,
               ih, il, m_scratch, logn, n_scalars, f64,
               {q0, q1, g0_mont, g1_mont, qinv0, qinv1, qq, half},
               {q0, q1, g0, g1, (double)qq}};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < 2; ++l) decrypt_limb(a, l, b, tw_smem.data());
  for (int b = 0; b < batch; ++b) decode_row(a, b);
  return 0;
}

#endif
