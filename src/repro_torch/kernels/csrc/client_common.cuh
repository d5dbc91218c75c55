// Shared device code of the client kernels (the megakernels
// encode_encrypt.cu, decrypt_decode.cu, the staged kernels ntt_limbs.cu,
// client_pointwise.cu, fft_df.cu, and the per-prime kernels ntt_rows.cu,
// ntt_matmul.cu): the two uint32 Montgomery REDC policies (MontRedc: the
// general one with -q^-1; SaRedc: the shift-add NTT-friendly one of paper
// eq. 9-11; a tiled stage or encrypt picks one at compile time, see
// ntt_tiled.cuh), the u64 REDC of the server kernels, Philox-4x32-10, the
// df32 error-free transforms, the exact Delta-scale digit split, the
// two-limb CRT, the f64 datapath's df64 transforms (exact Delta-scale
// round, fmod RNS, df64 CRT), the (L, K) seed-table layout the NTT
// twiddles are made from, and the df32 SpecialIFFT's 1/n scale.
//
// Every function returns exactly the words / floats of its plain PyTorch
// counterpart in repro_torch (and of the JAX reference): the float code is
// written operation for operation in the reference's order and must be
// compiled with --fmad=false (no multiply-add contraction, float and
// double alike; g++: -ffp-contract=off), IEEE division and no
// flush-to-zero. Rounding to nearest-even is rintf / rint, never roundf /
// round (which round half away from zero).
//
// Work layout: a block body walks its index ranges with a stride of the
// block size and separates dependent phases with RT_SYNC(). The NTT and FFT
// transforms (ntt_tiled.cuh) hold their tiles in shared memory; no kernel
// runs a transform over a row in device memory. The one-row NTT stage
// loops are only the host tests' oracle (ntt_limbs.cu:
// ntt_limbs_loop_host).
//
// The same header compiles as plain C++ (no __CUDACC__): one thread per
// block, RT_SYNC a no-op. Each phase is race-free by construction, so that
// host build computes what the kernel computes; the port's tests use it to
// check this source's arithmetic against the plain versions on a CPU.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RT_FN __device__ __forceinline__
#define RT_BODY __device__
#define RT_TID (threadIdx.x)
#define RT_NT (blockDim.x)
#define RT_SYNC() __syncthreads()
RT_FN uint32_t rt_mulhi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
RT_FN int rt_popc(uint32_t x) { return __popc(x); }
RT_FN double rt_ddiv(double a, double b) { return __ddiv_rn(a, b); }
#else
#define RT_FN static inline
#define RT_BODY static
#define RT_TID 0u
#define RT_NT 1u
#define RT_SYNC() ((void)0)
RT_FN uint32_t rt_mulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
RT_FN int rt_popc(uint32_t x) { return __builtin_popcount(x); }
RT_FN double rt_ddiv(double a, double b) { return a / b; }
#endif

namespace rt {

// ---------------------------------------------------------------------------
// (L, K) seed-table layout (kernels/common.py: OFF_Q, OFF_QINV, OFF_NINV,
// then per forward stage s: [base, f_0..f_{s-1}], then per inverse stage
// t: [base, f_0..f_{logn-2-t}])
// ---------------------------------------------------------------------------
constexpr int OFF_Q = 0;
constexpr int OFF_QINV = 1;
constexpr int OFF_NINV = 2;

RT_FN int fwd_off(int s) { return 3 + s * (s + 1) / 2; }
RT_FN int inv_off(int logn, int t) {
  return 3 + logn * (logn + 1) / 2 + t * logn - t * (t - 1) / 2;
}

// ---------------------------------------------------------------------------
// modular arithmetic on uint32 residues (q < 2^31)
// ---------------------------------------------------------------------------
RT_FN uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

RT_FN uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// REDC(a * b) = a*b*2^-32 mod q with one conditional subtraction: the words
// modmul.mulmod_montgomery_limb_t returns (its 16-bit-limb products are the
// exact 64-bit product; here one mul.lo / mul.hi pair each).
RT_FN uint32_t redc_mul(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv) {
  uint32_t t_lo = a * b;
  uint32_t t_hi = rt_mulhi(a, b);
  uint32_t m = t_lo * qinv;
  uint32_t u = t_hi + rt_mulhi(m, q) + (t_lo != 0u ? 1u : 0u);
  return u >= q ? u - q : u;
}

// The REDC policies: redc(red, a, b) = a*b*2^-32 mod q. Every correct REDC
// returns the same word, so the policy changes the instructions, never the
// result.
struct MontRedc {
  uint32_t q, qinv;
};

RT_FN uint32_t redc(const MontRedc &r, uint32_t a, uint32_t b) {
  return redc_mul(a, b, r.q, r.qinv);
}

RT_FN MontRedc mont_redc(const uint32_t *trow) {
  return MontRedc{trow[OFF_Q], trow[OFF_QINV]};
}

// NTT-friendly Montgomery REDC (modmul.mulmod_montgomery_sa_limb): for
// q = 2^p_bw + k 2^(n+1) + 1 with k a sum of at most three signed powers of
// two, -q^-1 = 2^p_bw + k 2^(n+1) - 1 mod 2^32 (eq. 11), so m = t_lo * (-q^-1)
// and m*q are shifts and adds; a*b is the only general product. The
// constants come from a row of common.sa_table: q, p_bw, n+1, the number of
// k-terms, then each term's exponent e (+2^e) or ~e (-2^e).
struct SaRedc {
  uint32_t q;
  int p_bw, np1, nterms;
  int term[3];
};

RT_FN SaRedc sa_redc(const int32_t *row) {
  SaRedc r;
  r.q = (uint32_t)row[0];
  r.p_bw = row[1];
  r.np1 = row[2];
  r.nterms = row[3];
  for (int i = 0; i < 3; ++i) r.term[i] = row[4 + i];
  return r;
}

// v * k mod 2^64 by shifts and adds (modmul._mul_by_k64)
RT_FN uint64_t mul_by_k64(uint32_t v, const SaRedc &r) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i < r.nterms) {
      const int t = r.term[i];
      const uint64_t s = (uint64_t)v << (t < 0 ? ~t : t);
      acc += t < 0 ? (uint64_t)0 - s : s;
    }
  }
  return acc;
}

RT_FN uint32_t redc(const SaRedc &r, uint32_t a, uint32_t b) {
  const uint32_t t_lo = a * b;
  const uint32_t t_hi = rt_mulhi(a, b);
  const uint32_t m =
      (t_lo << r.p_bw) + ((uint32_t)mul_by_k64(t_lo, r) << r.np1) - t_lo;
  const uint64_t mq =
      ((uint64_t)m << r.p_bw) + (mul_by_k64(m, r) << r.np1) + m;
  const uint32_t u = t_hi + (uint32_t)(mq >> 32) + (t_lo != 0u ? 1u : 0u);
  return u >= r.q ? u - r.q : u;
}

// The reference's u64 REDC (modmul.mulmod_montgomery_u64_t): t = a*b in one
// 64-bit product, m = (uint32)t * -q^-1, u = (t + m q) >> 32, one
// conditional subtraction. a < 2^32 and b < q < 2^31, so t < 2^63 and
// t + m q < 2^63 + 2^63: the sum fits a uint64_t. The pointwise REDC of the
// server kernels (server_common.cuh, server_eval.cu) on both datapaths; the
// same words as redc_mul.
RT_FN uint32_t redc_u64(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * qinv;
  const uint32_t u = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return u >= q ? u - q : u;
}

// signed value in (-q, q) -> residue
RT_FN uint32_t to_residue(int32_t x, uint32_t q) {
  return (uint32_t)(x < 0 ? x + (int32_t)q : x);
}

// ---------------------------------------------------------------------------
// Philox-4x32-10: counter (index, stream, word ^ seed2, seed3), key
// (seed0, seed1); first output word (core/prng.py random_u32)
// ---------------------------------------------------------------------------
struct Seed {
  uint32_t w0, w1, w2, w3;
};

RT_FN uint32_t philox_word(uint32_t idx, uint32_t stream, uint32_t word,
                           Seed sd) {
  uint32_t c0 = idx, c1 = stream, c2 = word ^ sd.w2, c3 = sd.w3;
  uint32_t k0 = sd.w0, k1 = sd.w1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t lo0 = 0xD2511F53u * c0, hi0 = rt_mulhi(0xD2511F53u, c0);
    uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = rt_mulhi(0xCD9E8D57u, c2);
    uint32_t n0 = hi1 ^ c1 ^ k0;
    uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// ZO(0.5): +1 below 2^30, -1 below 2^31, else 0
RT_FN int32_t zo(uint32_t u) {
  return u < (1u << 30) ? 1 : (u < (1u << 31) ? -1 : 0);
}

// centered binomial, eta = 21
RT_FN int32_t cbd(uint32_t a, uint32_t b) {
  return rt_popc(a & 0x1FFFFFu) - rt_popc(b & 0x1FFFFFu);
}

// ---------------------------------------------------------------------------
// df32 error-free transforms (core/dfloat.py), reference operation order
// ---------------------------------------------------------------------------
struct df {
  float hi, lo;
};
struct dfc {
  df re, im;
};

RT_FN void two_sum(float a, float b, float &s, float &e) {
  s = a + b;
  float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

RT_FN df quick_two_sum(float a, float b) {
  float s = a + b;
  df r;
  r.hi = s;
  r.lo = b - (s - a);
  return r;
}

RT_FN void two_prod(float a, float b, float &p, float &e) {
  const float c = 4097.0f;  // Veltkamp splitter 2^12 + 1
  p = a * b;
  float ca = c * a;
  float a_hi = ca - (ca - a);
  float a_lo = a - a_hi;
  float cb = c * b;
  float b_hi = cb - (cb - b);
  float b_lo = b - b_hi;
  e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

RT_FN df df_add(df x, df y) {
  float s, e;
  two_sum(x.hi, y.hi, s, e);
  e = e + x.lo + y.lo;
  return quick_two_sum(s, e);
}

RT_FN df df_sub(df x, df y) {
  df ny;
  ny.hi = -y.hi;
  ny.lo = -y.lo;
  return df_add(x, ny);
}

RT_FN df df_mul(df x, df y) {
  float p, e;
  two_prod(x.hi, y.hi, p, e);
  e = e + x.hi * y.lo + x.lo * y.hi;
  return quick_two_sum(p, e);
}

RT_FN dfc dfc_add(dfc a, dfc b) {
  dfc r;
  r.re = df_add(a.re, b.re);
  r.im = df_add(a.im, b.im);
  return r;
}

RT_FN dfc dfc_sub(dfc a, dfc b) {
  dfc r;
  r.re = df_sub(a.re, b.re);
  r.im = df_sub(a.im, b.im);
  return r;
}

RT_FN dfc dfc_mul(dfc a, dfc b) {
  df ac = df_mul(a.re, b.re);
  df bd = df_mul(a.im, b.im);
  df ad = df_mul(a.re, b.im);
  df bc = df_mul(a.im, b.re);
  dfc r;
  r.re = df_sub(ac, bd);
  r.im = df_add(ad, bc);
  return r;
}

// four float planes (re_hi, re_lo, im_hi, im_lo) of one row
struct Planes {
  float *rh, *rl, *ih, *il;
};

RT_FN dfc load_dfc(Planes p, int i) {
  dfc z;
  z.re.hi = p.rh[i];
  z.re.lo = p.rl[i];
  z.im.hi = p.ih[i];
  z.im.lo = p.il[i];
  return z;
}

RT_FN void store_dfc(Planes p, int i, dfc z) {
  p.rh[i] = z.re.hi;
  p.rl[i] = z.re.lo;
  p.ih[i] = z.im.hi;
  p.il[i] = z.im.lo;
}

// twiddle i of the packed (4, n) table
RT_FN dfc load_tw(const float *tw, int n, int i) {
  dfc w;
  w.re.hi = tw[i];
  w.re.lo = tw[n + i];
  w.im.hi = tw[2 * n + i];
  w.im.lo = tw[3 * n + i];
  return w;
}

// ---------------------------------------------------------------------------
// exact Delta-scale rounding and digit split (dfloat.df_round_rne,
// dfloat.expansion3_digits)
// ---------------------------------------------------------------------------
RT_FN bool is_odd_int(float x) {
  float half = x * 0.5f;
  return (x - 2.0f * floorf(half)) == 1.0f;
}

// digits of RNE(hi + lo): value = d0 + d1*2^22 + d2*2^44
RT_FN void round_digits(float hi, float lo, int32_t &d0, int32_t &d1,
                        int32_t &d2) {
  float s, err;
  two_sum(hi, lo, s, err);
  float rs = rintf(s);
  float t = s - rs;
  float f, e;
  two_sum(t, err, f, e);
  float fr = rintf(f);
  float d = f - fr;
  float g, h;
  two_sum(d, e, g, h);
  bool up = (g > 0.5f) || ((g == 0.5f) && (h > 0.0f));
  bool up_tie = (g == 0.5f) && (h == 0.0f);
  bool dn = (g < -0.5f) || ((g == -0.5f) && (h < 0.0f));
  bool dn_tie = (g == -0.5f) && (h == 0.0f);
  bool odd = is_odd_int(rs) != is_odd_int(fr);
  float adj = ((up || (up_tie && odd)) ? 1.0f : 0.0f) -
              ((dn || (dn_tie && odd)) ? 1.0f : 0.0f);
  float a, b;
  two_sum(fr, adj, a, b);
  float s1, c;
  two_sum(rs, a, s1, c);
  // expansion3_digits(s1, c, b)
  const float r44 = 17592186044416.0f;         // 2^44
  const float r44i = 5.684341886080802e-14f;   // 2^-44
  const float r22 = 4194304.0f;                // 2^22
  const float r22i = 2.384185791015625e-07f;   // 2^-22
  float fd2 = rintf(s1 * r44i);
  float s0 = s1 - fd2 * r44;
  float u, e2;
  two_sum(c, b, u, e2);
  float t1, e1;
  two_sum(s0, u, t1, e1);
  float t2, t3;
  two_sum(e1, e2, t2, t3);
  float fd1 = rintf(t1 * r22i);
  float fd0 = ((t1 - fd1 * r22) + t2) + t3;
  d0 = (int32_t)fd0;
  d1 = (int32_t)fd1;
  d2 = (int32_t)fd2;
}

// ---------------------------------------------------------------------------
// the f64 datapath: df64 error-free transforms (core/dfloat.py on float64,
// Veltkamp splitter 2^27 + 1), the exact Delta-scale round
// (encoder.delta_scale_round), the fmod RNS step (rns.to_rns_limb_t) and
// the df64 two-limb CRT (rns.crt2_to_df). Overloads of the df32 names on
// double; each product and sum rounds on its own (--fmad=false).
// ---------------------------------------------------------------------------
struct dd {
  double hi, lo;
};

RT_FN void two_sum(double a, double b, double &s, double &e) {
  s = a + b;
  double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

RT_FN dd quick_two_sum(double a, double b) {
  double s = a + b;
  dd r;
  r.hi = s;
  r.lo = b - (s - a);
  return r;
}

RT_FN void two_prod(double a, double b, double &p, double &e) {
  const double c = 134217729.0;  // Veltkamp splitter 2^27 + 1
  p = a * b;
  double ca = c * a;
  double a_hi = ca - (ca - a);
  double a_lo = a - a_hi;
  double cb = c * b;
  double b_hi = cb - (cb - b);
  double b_lo = b - b_hi;
  e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

RT_FN dd dd_add(dd x, dd y) {
  double s, e;
  two_sum(x.hi, y.hi, s, e);
  e = e + x.lo + y.lo;
  return quick_two_sum(s, e);
}

RT_FN dd dd_sub(dd x, dd y) {
  dd ny;
  ny.hi = -y.hi;
  ny.lo = -y.lo;
  return dd_add(x, ny);
}

// round(x * Delta), exact, as an integer-valued pair: two_prod, then
// df_round (rint: half to even, as torch.round / jnp.round)
RT_FN dd delta_scale_round(double x, double delta) {
  dd v;
  two_prod(x, delta, v.hi, v.lo);
  const double rh = rint(v.hi);
  const double frac = (v.hi - rh) + v.lo;  // exact: |v.hi - rh| <= 0.5
  const double rl = rint(frac);
  return quick_two_sum(rh, rl);
}

// the residue of the integer hi + lo mod q: fmod of an integer-valued
// double by q < 2^31 is exact (a library routine on the card, not one
// instruction)
RT_FN uint32_t fmod_residue(dd x, double qf) {
  double r = fmod(x.hi, qf) + fmod(x.lo, qf);  // in (-2q, 2q)
  r = fmod(r, qf);
  if (r < 0.0) r = r + qf;
  return (uint32_t)r;
}

// two-limb CRT -> the centered integer as an exact df64 pair:
// t_i = c_i g_i mod q_i in 64-bit integers (a 64-bit remainder: a library
// routine on the card), t0 q1 + t1 q0 in df64 (each product < 2^62 exact
// by two_prod), minus fl64(Q) when >= fl64(Q), then minus fl64(Q) again
// when above fl64(Q) / 2
struct Crt2F64 {
  uint32_t q0, q1, g0, g1;
  double qq;  // fl64(q0 * q1)
};

RT_FN dd crt2_to_dd(uint32_t c0, uint32_t c1, const Crt2F64 &k) {
  const uint64_t t0 = (uint64_t)c0 * k.g0 % k.q0;
  const uint64_t t1 = (uint64_t)c1 * k.g1 % k.q1;
  dd a, b;
  two_prod((double)t0, (double)k.q1, a.hi, a.lo);
  two_prod((double)t1, (double)k.q0, b.hi, b.lo);
  dd v = dd_add(a, b);  // < 2Q
  dd qq;
  qq.hi = k.qq;
  qq.lo = 0.0;
  const dd vq = dd_sub(v, qq);
  if (v.hi >= k.qq) v = vq;
  const dd vc = dd_sub(v, qq);
  if (v.hi > k.qq / 2.0) v = vc;
  return v;
}

// float64 -> df32 pair (dfloat.df_from): hi the rounded cast, lo the
// rounded residual
RT_FN df df_from(double x) {
  df r;
  r.hi = (float)x;
  r.lo = (float)(x - (double)r.hi);
  return r;
}

// ---------------------------------------------------------------------------
// the 1/n scale of the df32 SpecialIFFT (fft_df.fft_stage_pipeline's last
// step; the tiled stage loops are ntt_tiled.cuh's)
// ---------------------------------------------------------------------------
RT_FN dfc ifft_scale(dfc z, int logns) {
  df sc;
  sc.hi = 1.0f / (float)(1 << logns);  // 1/n is a power of two: lo = 0
  sc.lo = 0.0f;
  dfc r;
  r.re = df_mul(z.re, sc);
  r.im = df_mul(z.im, sc);
  return r;
}

// ---------------------------------------------------------------------------
// two-limb CRT -> centered value / scale as a df32 pair
// (rns.crt2_centered_u32 + rns.centered_to_df; native 64-bit integers give
// the reference's u32 word-pair results, fl64(Q) reduction included)
// ---------------------------------------------------------------------------
struct Crt2 {
  uint32_t q0, q1, g0_mont, g1_mont, qinv0, qinv1;
  uint64_t qq, half;  // fl64(q0*q1) and its floor half
};

RT_FN df crt2_to_df(uint32_t m0, uint32_t m1, Crt2 k, float inv_scale) {
  const uint32_t t0 = redc_mul(m0, k.g0_mont, k.q0, k.qinv0);
  const uint32_t t1 = redc_mul(m1, k.g1_mont, k.q1, k.qinv1);
  uint64_t v = (uint64_t)t0 * k.q1 + (uint64_t)t1 * k.q0;  // < 2Q < 2^63
  if (v >= k.qq) v -= k.qq;
  const bool gt = v > k.half;
  const bool geq = v >= k.qq;
  const bool neg = gt && !geq;
  const uint64_t mag = neg ? k.qq - v : ((gt && geq) ? v - k.qq : v);
  const float sign = neg ? -1.0f : 1.0f;
  const uint32_t hi = (uint32_t)(mag >> 32), lo = (uint32_t)mag;
  const float s = sign * inv_scale;
  const float w0 = (float)(lo & 0xFFFFu) * s;
  const float w1 = (float)(lo >> 16) * 65536.0f * s;
  const float w2 = (float)(hi & 0xFFFFu) * 4294967296.0f * s;
  const float w3 = (float)(hi >> 16) * 281474976710656.0f * s;
  // terms4_to_df(w3, w2, w1, w0)
  float a, e1, e2, e3, hi_f;
  two_sum(w1, w0, a, e1);
  two_sum(w2, a, a, e2);
  two_sum(w3, a, hi_f, e3);
  const float lo_f = (e3 + e2) + e1;
  return quick_two_sum(hi_f, lo_f);
}

}  // namespace rt

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <mutex>

namespace rt {

// Dynamic shared memory above 48 KB has to be allowed per kernel and
// device, and the allowance persists: raise it once per device, to the
// largest size asked so far, instead of on every launch.
struct SmemAllowance {
  static constexpr int kDevices = 64;
  std::mutex mu;
  int bytes[kDevices] = {};
};

template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes,
                                      SmemAllowance &state) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(state.mu);
  if (dev < SmemAllowance::kDevices && state.bytes[dev] >= (int)bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < SmemAllowance::kDevices)
    state.bytes[dev] = (int)bytes;
  return err;
}

}  // namespace rt
#endif
