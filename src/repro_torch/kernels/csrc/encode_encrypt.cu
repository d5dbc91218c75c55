// encode+encrypt megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/client_stream.py
// :_encode_encrypt_kernel (pallas_call in encode_encrypt_stream), both of
// its datapaths: df32 SpecialIFFT, bit-reversal, then the exact
// Delta-scale, then per limb: RNS reduction, NTT, Philox (v, e0, e1) keyed
// by (seed, nonce0 + row), c0 = v*b + e0 + pt, c1 = v*a + e1.
//   df32: exact RNE Delta-scale of the df32 pair into balanced base-2^22
//         digits; per limb the digits' residues by uint32 Montgomery
//         products;
//   f64:  the pair collapsed to float64, then round(x * Delta) exactly as
//         a df64 pair (two_prod, rint); per limb the pair's residue by
//         fmod (exact on integer-valued doubles).
// Both give the same words. Output words are bit-identical to the plain
// version (client_stream.encode_encrypt_stream_plain) and to the JAX
// reference.
//
// Two kernels launched back to back on the caller's stream by one entry
// point, because the two phases want different grids:
//   1. encode_rows_kernel, grid (B): one block per batch row runs the
//      SpecialIFFT stages on a copy of the row's four planes (global
//      scratch), then bit-reverses, scales by 1/n and Delta and writes the
//      three digit rows (B, 3, N) int32 (df32) or the two float64 rows
//      (hi, lo) (B, 2, N) (f64) to global scratch;
//   2. encrypt_limbs_kernel, grid (L, B): one block per (limb, row) builds
//      the limb's plaintext residues into a (B, L, 2, N) scratch, then runs
//      the encrypt block body it shares with the staged kernel K2
//      (rt::encrypt_limb_block): draws (v, e0, e1) (limb-independent
//      Philox streams, regenerated per limb as the reference's blocks do),
//      one NTT stage loop over the four rows pt, v, e0, e1, and c0/c1.
//      e0 and e1 are transformed in place in the c0/c1 output rows, pt and
//      v in the scratch.
//
// What bounds it on an H100: at the paper profile (N = 2^16, L = 24) the
// kernel must write 2*B*L*N*4 bytes of ciphertext (201 MB at B = 16), but
// the integer work the function needs (per limb 3 NTTs of 16 stages, since
// pt + e0 can share one, and 5 Philox-10 words per coefficient per row) is
// larger: operations, not bytes, bound it. This kernel does more than
// that: 4 NTTs per limb, and the Philox words regenerated per limb. On
// the f64 datapath the per-(limb, coefficient) RNS step is three fmod
// calls, each a loop of FP64 instructions on the card (a library routine,
// exact), at the H100's FP64 rate of half its FP32 one. This
// first version is simple rather than fast: the NTT rows (256 KB each)
// do not fit a block's 227 KB of shared memory, so every butterfly stage
// reads and writes global memory (kept in the 50 MB L2 as far as it goes)
// with a block barrier between stages; only the stage's twiddles
// (<= 128 KB) sit in shared memory. Phase 1 fills only B of 132 SMs.
#include "client_common.cuh"

namespace {

struct EncArgs {
  const float *rh, *rl, *ih, *il;  // (B, ns) slot planes
  const float *tw;                 // (4, ns) packed inverse twiddles
  const int32_t *rev;              // (ns,) bit-reversal permutation
  const uint32_t *table;           // (L, K) seed table
  const uint32_t *digit_mont;      // (L, 2): 2^22, 2^44 mod q (Montgomery)
  const uint32_t *pk_b, *pk_a;     // (L, N) Montgomery form
  uint32_t *c0, *c1;               // (B, L, N)
  float *fft;                      // (B, 4, ns) scratch
  void *scaled;                    // (B, 3, N) int32 digits (df32) or
                                   // (B, 2, N) float64 (hi, lo) (f64)
  uint32_t *ntt;                   // (B, L, 2, N) scratch
  int n_limbs, logn, n_scalars;
  int f64;                         // datapath: 0 df32, 1 f64
  double delta;
  rt::Seed seed;
  uint32_t nonce0;
};

RT_BODY void encode_row(const EncArgs &a, int b) {
  const int logns = a.logn - 1;
  const int ns = 1 << logns;
  const int n = 1 << a.logn;
  float *f = a.fft + (size_t)b * 4 * ns;
  rt::Planes x = {f, f + ns, f + 2 * ns, f + 3 * ns};
  const size_t row = (size_t)b * ns;
  for (int i = RT_TID; i < ns; i += RT_NT) {
    x.rh[i] = a.rh[row + i];
    x.rl[i] = a.rl[row + i];
    x.ih[i] = a.ih[row + i];
    x.il[i] = a.il[row + i];
  }
  RT_SYNC();
  rt::fft_inv_stages(x, logns, a.tw);
  // bit-reversal + 1/n, then coefficient k = re (k < ns) ++ im (k >= ns)
  int32_t *dg = static_cast<int32_t *>(a.scaled) + (size_t)b * 3 * n;
  double *sd = static_cast<double *>(a.scaled) + (size_t)b * 2 * n;
  const float delta32 = (float)a.delta;  // a power of two (df32 only)
  for (int k = RT_TID; k < n; k += RT_NT) {
    const int j = k < ns ? k : k - ns;
    const rt::dfc z = rt::ifft_scale(rt::load_dfc(x, a.rev[j]), logns);
    const rt::df c = k < ns ? z.re : z.im;
    if (a.f64) {
      const rt::dd v =
          rt::delta_scale_round((double)c.hi + (double)c.lo, a.delta);
      sd[k] = v.hi;
      sd[n + k] = v.lo;
    } else {
      int32_t d0, d1, d2;
      rt::round_digits(c.hi * delta32, c.lo * delta32, d0, d1, d2);
      dg[k] = d0;
      dg[n + k] = d1;
      dg[2 * n + k] = d2;
    }
  }
}

RT_BODY void encrypt_limb(const EncArgs &a, int l, int b, uint32_t *tw) {
  const int n = 1 << a.logn;
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  const uint32_t q = trow[rt::OFF_Q], qinv = trow[rt::OFF_QINV];
  const uint32_t c22 = a.digit_mont[2 * l], c44 = a.digit_mont[2 * l + 1];
  const size_t off = ((size_t)b * a.n_limbs + l) * n;
  uint32_t *pt = a.ntt + 2 * off;
  if (a.f64) {
    const double *sd =
        static_cast<const double *>(a.scaled) + (size_t)b * 2 * n;
    const double qf = (double)q;
    for (int i = RT_TID; i < n; i += RT_NT) {
      rt::dd v;
      v.hi = sd[i];
      v.lo = sd[n + i];
      pt[i] = rt::fmod_residue(v, qf);
    }
  } else {
    const int32_t *dg =
        static_cast<const int32_t *>(a.scaled) + (size_t)b * 3 * n;
    for (int i = RT_TID; i < n; i += RT_NT) {
      const uint32_t r0 = rt::to_residue(dg[i], q);
      const uint32_t m1 =
          rt::redc_mul(rt::to_residue(dg[n + i], q), c22, q, qinv);
      const uint32_t m2 =
          rt::redc_mul(rt::to_residue(dg[2 * n + i], q), c44, q, qinv);
      pt[i] = rt::addmod(rt::addmod(r0, m1, q), m2, q);
    }
  }
  // the shared body's first barrier orders these writes before the NTT
  rt::EncLimb e = {a.c0 + off, a.c1 + off, pt + n, pt,
                   a.pk_b + (size_t)l * n, a.pk_a + (size_t)l * n, trow,
                   a.logn, true, a.nonce0 + (uint32_t)b, a.seed};
  rt::encrypt_limb_block(e, tw);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) encode_rows_kernel(EncArgs a) {
  encode_row(a, blockIdx.x);
}

__global__ void __launch_bounds__(1024) encrypt_limbs_kernel(EncArgs a) {
  extern __shared__ uint32_t tw_smem[];
  encrypt_limb(a, blockIdx.x, blockIdx.y, tw_smem);
}

}  // namespace

extern "C" int encode_encrypt_stream_launch(
    const float *rh, const float *rl, const float *ih, const float *il,
    const float *tw, const int32_t *rev, const uint32_t *table,
    const uint32_t *digit_mont, const uint32_t *pk_b, const uint32_t *pk_a,
    uint32_t *c0, uint32_t *c1, float *fft_scratch, void *scaled_scratch,
    uint32_t *ntt_scratch, int batch, int n_limbs, int logn, int n_scalars,
    int f64, double delta, uint32_t seed0, uint32_t seed1, uint32_t seed2,
    uint32_t seed3, uint32_t nonce0, void *stream) {
  EncArgs a = {rh,     rl,          ih,          il,   tw,   rev,
               table,  digit_mont,  pk_b,        pk_a, c0,   c1,
               fft_scratch, scaled_scratch, ntt_scratch, n_limbs, logn,
               n_scalars, f64, delta, {seed0, seed1, seed2, seed3}, nonce0};
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 1024;
  encode_rows_kernel<<<batch, threads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(uint32_t) << (logn - 1);  // one stage's twiddles
  static rt::SmemAllowance allowance;
  err = rt::allow_dynamic_smem(encrypt_limbs_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  encrypt_limbs_kernel<<<dim3(n_limbs, batch), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block bodies (one thread per block)

#include <vector>

extern "C" int encode_encrypt_stream_host(
    const float *rh, const float *rl, const float *ih, const float *il,
    const float *tw, const int32_t *rev, const uint32_t *table,
    const uint32_t *digit_mont, const uint32_t *pk_b, const uint32_t *pk_a,
    uint32_t *c0, uint32_t *c1, float *fft_scratch, void *scaled_scratch,
    uint32_t *ntt_scratch, int batch, int n_limbs, int logn, int n_scalars,
    int f64, double delta, uint32_t seed0, uint32_t seed1, uint32_t seed2,
    uint32_t seed3, uint32_t nonce0) {
  EncArgs a = {rh,     rl,          ih,          il,   tw,   rev,
               table,  digit_mont,  pk_b,        pk_a, c0,   c1,
               fft_scratch, scaled_scratch, ntt_scratch, n_limbs, logn,
               n_scalars, f64, delta, {seed0, seed1, seed2, seed3}, nonce0};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b) encode_row(a, b);
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < n_limbs; ++l) encrypt_limb(a, l, b, tw_smem.data());
  return 0;
}

#endif
