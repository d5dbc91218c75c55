// Row bodies of the server-side CKKS kernels (server_eval.cu): the centered
// lift of an NTT row to key-switch digits, the base extension of a digit
// row onto another prime, the scale-down that finishes a rescale or a
// mod-down by the special prime, the digit multiply-accumulate against a
// key-switch key, and the elementwise ops.
//
// Every body returns exactly the words of its plain PyTorch counterpart in
// kernels/server_eval.py (and of the JAX reference's stage helpers
// _to_digit, _digit_to_row, _ks_accumulate, _ks_moddown and _rescale2):
// integer arithmetic only, on the uint32 helpers and the NTT / INTT stage
// loops of client_common.cuh. The pointwise REDC (the reference's _mm) is
// redc_u64, the reference's u64 REDC, on both datapaths: it gives the words
// of the df32 datapath's uint32 REDC too, so one body serves both; the NTT /
// INTT stage loops keep the uint32 REDC, as the reference's do. Like that
// header, this one compiles as plain C++ (one thread per block, barriers as
// no-ops) for the host-build tests.
#pragma once

#include "client_common.cuh"

namespace rt {

// centered digit of a residue (rns.ks_center_t): q is odd, values above
// q >> 1 map down by q
RT_FN int32_t ks_center(uint32_t v, uint32_t q) {
  return v > (q >> 1) ? (int32_t)v - (int32_t)q : (int32_t)v;
}

// One row lifted to centered coefficient digits (_to_digit, and the first
// half of _rescale2 / _ks_moddown): dst <- src, gathered by perm when given
// (sigma_g of an NTT row) and REDC'd by the plaintext row pm when given
// (the fused ct x pt in front of a rescale); INTT with trow's prime; then
// each residue centered in place. src must not alias dst.
RT_FN void lift_row(const uint32_t *src, const int32_t *perm,
                    const uint32_t *pm, int32_t *dst, int logn,
                    const uint32_t *trow, uint32_t *tw) {
  const int n = 1 << logn;
  const uint32_t q = trow[OFF_Q], qinv = trow[OFF_QINV];
  uint32_t *u = reinterpret_cast<uint32_t *>(dst);
  for (int i = RT_TID; i < n; i += RT_NT) {
    uint32_t v = src[perm ? perm[i] : i];
    if (pm) v = redc_u64(v, pm[i], q, qinv);
    u[i] = v;
  }
  RT_SYNC();
  Rows rows = {{u, u, u, u}};
  ntt_inv(rows, 1, logn, trow, tw);
  for (int i = RT_TID; i < n; i += RT_NT) dst[i] = ks_center(u[i], q);
  RT_SYNC();
}

// One digit row base-extended onto trow's prime and transformed
// (_digit_to_row): dst <- NTT(residue(w)). |w| < 2^30 <= q, so the residue
// is one conditional add.
RT_FN void extend_row(const int32_t *w, uint32_t *dst, int logn,
                      const uint32_t *trow, uint32_t *tw) {
  const int n = 1 << logn;
  const uint32_t q = trow[OFF_Q];
  for (int i = RT_TID; i < n; i += RT_NT) dst[i] = to_residue(w[i], q);
  RT_SYNC();
  Rows rows = {{dst, dst, dst, dst}};
  ntt_fwd(rows, 1, logn, trow, tw);
}

// The second half of a rescale (_rescale2: c = q_drop^-1 R) or a mod-down
// (_ks_moddown: c = P^-1 R) on one target row: y = extend_row(w) in dst,
// then dst = REDC(x' - y, c) with x' = REDC(x, pm) when pm is given, and
// then addmod(add[perm'], dst) when add is given (the key-switched ct's
// other half: sigma_g(c0) for a rotation, d0 / d1 for a relinearization).
RT_FN void scale_down_row(const uint32_t *x, const uint32_t *pm,
                          const int32_t *w, const uint32_t *add,
                          const int32_t *add_perm, uint32_t *dst, uint32_t c,
                          int logn, const uint32_t *trow, uint32_t *tw) {
  const int n = 1 << logn;
  const uint32_t q = trow[OFF_Q], qinv = trow[OFF_QINV];
  extend_row(w, dst, logn, trow, tw);
  for (int i = RT_TID; i < n; i += RT_NT) {
    uint32_t xv = x[i];
    if (pm) xv = redc_u64(xv, pm[i], q, qinv);
    uint32_t r = redc_u64(submod(xv, dst[i], q), c, q, qinv);
    if (add) r = addmod(add[add_perm ? add_perm[i] : i], r, q);
    dst[i] = r;
  }
  RT_SYNC();
}

// Multiply-accumulate of one target row's digit stack against the key
// (_ks_accumulate), columns [c0, c1): acc_b[k] = sum_j REDC(h[j][k'],
// kb[j][k]) and acc_a the same against ka, k' = perm[k] when a permutation
// is given (the hoisted rotation permutes the digits). h: (l, N) digit NTTs
// of this target row; kb / ka: this row of digit 0 of the key, digit j at
// j * kstride. The sums run in the reference's order (addmod is exact, so
// any order gives these words).
RT_FN void mac_cols(const uint32_t *h, const int32_t *perm,
                    const uint32_t *kb, const uint32_t *ka, size_t kstride,
                    uint32_t *acc_b, uint32_t *acc_a, int l, int logn,
                    int c0, int c1, uint32_t q, uint32_t qinv) {
  const size_t n = (size_t)1 << logn;
  for (int k = c0 + (int)RT_TID; k < c1; k += RT_NT) {
    const int kk = perm ? perm[k] : k;
    uint32_t hv = h[kk];
    uint32_t sb = redc_u64(hv, kb[k], q, qinv);
    uint32_t sa = redc_u64(hv, ka[k], q, qinv);
    for (int j = 1; j < l; ++j) {
      hv = h[j * n + kk];
      sb = addmod(sb, redc_u64(hv, kb[j * kstride + k], q, qinv), q);
      sa = addmod(sa, redc_u64(hv, ka[j * kstride + k], q, qinv), q);
    }
    acc_b[k] = sb;
    acc_a[k] = sa;
  }
}

}  // namespace rt
