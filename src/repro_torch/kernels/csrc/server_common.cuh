// Block bodies of the server-side CKKS kernels (server_eval.cu): the twiddle
// heaps an op makes once per call, the digit multiply-accumulate against a
// key-switch key, and the centred digit of a residue. The transform stages
// themselves run on ntt_tiled.cuh's stage_tile.
//
// Every body returns exactly the words of its plain PyTorch counterpart in
// kernels/server_eval.py (and of the JAX reference's stage helpers
// _to_digit, _digit_to_row, _ks_accumulate, _ks_moddown and _rescale2):
// integer arithmetic only. The transforms are the tiled NTT / INTT of
// ntt_tiled.cuh (ntt_fwd_lines / ntt_inv_lines on column and chunk tiles,
// the words of the one-row stage loops (ntt_limbs.cu's host oracle) under
// any tiling, with the uint32 REDC of the reference's stage loops); the
// pointwise REDC (the reference's _mm) is redc_u64, the reference's u64
// REDC, on both datapaths: it gives the words of the df32 datapath's
// uint32 REDC too, so one body serves both. Like those headers, this one
// compiles as plain C++ (one thread per block, barriers as no-ops) for the
// host-build tests.
#pragma once

#include "ntt_tiled.cuh"

namespace rt {

// centered digit of a residue (rns.ks_center_t): q is odd, values above
// q >> 1 map down by q
RT_FN int32_t ks_center(uint32_t v, uint32_t q) {
  return v > (q >> 1) ? (int32_t)v - (int32_t)q : (int32_t)v;
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

namespace server {

// The twiddle heaps of one op, made once per entry call: (2, rows, N)
// words, table row r's forward heap at tw + r N and its inverse heap at
// tw + (rows + r) N (tiled::heap_word's layout, slot 0 unused); made for the
// forward rows [f0, f1) and the inverse rows [i0, i1) only.
struct Heaps {
  const uint32_t *table;  // (rows, ncols) server constant table
  int ncols, logn, rows;
  uint32_t *tw;
  int f0, f1, i0, i1;
};

RT_HD long long heap_words(const Heaps &h) {
  return ((long long)(h.f1 - h.f0) + (h.i1 - h.i0)) << h.logn;
}

// word t of the heaps made, the forward rows' first
RT_FN void heap_word(const Heaps &h, long long t) {
  const long long nf = (long long)(h.f1 - h.f0) << h.logn;
  const bool inverse = t >= nf;
  const int r0 = inverse ? h.i0 : h.f0;
  tiled::heap_word(h.table + (size_t)r0 * h.ncols, h.ncols, h.logn, inverse,
                   h.tw + (((size_t)(inverse ? h.rows : 0) + r0) << h.logn),
                   inverse ? t - nf : t);
}

}  // namespace server
}  // namespace rt
