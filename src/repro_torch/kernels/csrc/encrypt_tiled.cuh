// The RLWE public-key encrypt of the client kernels on the tiled NTT block
// (ntt_tiled.cuh): one body for K5 (encode_encrypt.cu), K2 and K13a
// (client_pointwise.cu).
//
// For every (limb l, row b) of a batch: Philox (v, e0, e1) keyed by
// (seed, nonce0 + b) (the sum wraps mod 2^32), residues, the forward NTT
// of three polynomials, c0 = v*b + e0 + pt and c1 = v*a + e1. The
// kernels differ only in where the plaintext enters and in the REDC, a
// policy class Pt:
//   K5 (PtDigits): its coefficients' residues join polynomial 1 in the
//       column load, so the three NTTs are of v, e0 + pt and e1
//       (NTT(e0) + NTT(pt) = NTT(e0 + pt) mod q, word for word);
//   K2 (PtNtt) and K13a (PtNttSa, one limb): its NTT-domain words join c0
//       in the chunk store (addition of canonical residues mod q gives the
//       same word in any order, so c0 = v*b + (e0 + pt) is the plain
//       version's (v*b + e0) + pt bit for bit).
// Pt::kLoad / Pt::kStore say which. pt.row(l, b, n) binds one (limb,
// row) once per block; its load(p, red) (kLoad) gives coefficient p's
// residue, its store(p) (kStore) the NTT-domain word at position p.
// pt.make_red(table row) gives the REDC policy Pt::Red of the butterflies
// and of v*b, v*a: the general MontRedc for K5 and K2, the shift-add SaRedc
// (paper eq. 9-11) for K13a, as their TPU kernels run. The twiddle heaps
// are made under MontRedc in every case (heap_word: the same words).
//
// Launches, on the caller's stream:
//   1. enc_prologue_kernel, grid-stride: each limb's forward twiddle heap
//      (L, N) (heap_word), made once per call, and the noise (v, e0,
//      e1) of every (row, coefficient) as int8 (B, 3, N), drawn once: the
//      Philox streams do not depend on the limb;
//   2. on rows above one tile (logn > kSinglePassLogn) two passes:
//      enc_ntt_cols_kernel, one polynomial per block, grid (L, 3 x tiles,
//      B): the load forms the polynomial (int8 noise -> residue, + the
//      plaintext for K5), the store writes NTT-so-far of v to a (B, L, N)
//      scratch and of the other two into the c0 / c1 rows;
//      enc_ntt_chunks_kernel, grid (B, tiles, L), finishes all three and
//      its store writes c0 and c1; on rows that fit one tile,
//      enc_ntt_row_kernel, one block per (limb, row), grid (L, 1, B).
// K5 runs its SpecialIFFT passes between 1 and 2 (they write the digits
// its column load reads).
//
// Compiles as plain C++ too (one thread per block), like ntt_tiled.cuh:
// enc_prologue_host / enc_ntt_host run every block of each pass in order.
#pragma once

#include "ntt_tiled.cuh"

#if defined(__CUDACC__)
#define RT_METHOD __device__ __forceinline__
#else
#define RT_METHOD inline
#endif

namespace rt {
namespace tiled {

// What the encrypt's NTT part reads and writes.
struct EncNtt {
  const uint32_t *table;        // (L, K) seed table
  const uint32_t *pk_b, *pk_a;  // (>= L, N) Montgomery form
  uint32_t *c0, *c1;            // (B, L, N)
  uint32_t *ntt_tw;             // (L, N) forward twiddle heaps
  int8_t *noise;                // (B, 3, N) v, e0, e1
  uint32_t *vhat;               // (B, L, N) NTT(v) between the passes
  int batch, n_limbs, logn, n_scalars;
  Seed seed;
  uint32_t nonce0;
  Geo g;
};

// The NTT geometry of an encrypt of B rows and L limbs (a, lc, lr < 0:
// the CUDA entry's plan): column tiles of 2^3 .. 2^5 columns (32-128 byte
// runs), chunk tiles of 2^1 .. 2^3 chunks of three polynomials.
inline Geo enc_ntt_geo(int logn, int a, int lc, int lr, int batch,
                       int n_limbs) {
  const long long limb_rows = (long long)n_limbs * batch;
  return plan_geo(logn, a, lc, lr, kSinglePassLogn, 3 * limb_rows,
                  limb_rows, 3, 5, 1, 3, 0);
}

// items of the prologue: L*N heap words, then B*N noise triples
inline long long enc_prologue_items(const EncNtt &a) {
  return ((long long)a.n_limbs + a.batch) << a.logn;
}

// item t < L*N: limb t / N's heap twiddle t % N (slot 0 unused); else the
// noise of (row, coefficient) t - L*N
RT_FN void enc_prologue_item(const EncNtt &a, long long t) {
  const int n = 1 << a.logn;
  const long long ntw = (long long)a.n_limbs << a.logn;
  if (t < ntw) {
    heap_word(a.table, a.n_scalars, a.logn, false, a.ntt_tw, t);
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
  nz[i] = (int8_t)zo(philox_word(i, sv, 0u, a.seed));
  nz[n + i] = (int8_t)cbd(philox_word(i, s0, 0u, a.seed),
                          philox_word(i, s0, 1u, a.seed));
  nz[2 * n + i] = (int8_t)cbd(philox_word(i, s1, 0u, a.seed),
                              philox_word(i, s1, 1u, a.seed));
}

// One NTT tile of (limb l, row b): kRow, the whole row of all three
// polynomials, c0/c1 out; kColumns, a column tile of polynomial `poly` (0
// v, 1 e0 (+ pt), 2 e1) -> its vhat / c0 / c1 row; kChunks, a chunk tile
// of all three -> c0/c1.
template <int pass, class Pt>
RT_BODY void enc_ntt_tile(const EncNtt &a, const Pt &pt, int l, int poly,
                          int tile, int b, uint32_t *x) {
  const Geo &g = a.g;
  const int n = 1 << g.logn;
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  const typename Pt::Red red = pt.make_red(trow);
  const uint32_t q = red.q;
  const uint32_t *tw = a.ntt_tw + (size_t)l * n;
  const size_t off = ((size_t)b * a.n_limbs + l) * n;
  uint32_t *const vh_row = a.vhat + off, *const c0 = a.c0 + off,
                 *const c1 = a.c1 + off;
  const int lpts = pass == kChunks ? g.lr + geo_b(g) : g.a + g.lc;
  const int pts = 1 << lpts;
  const int npoly = pass == kColumns ? 1 : 3;
  const typename Pt::Row pr = pt.row(l, b, n);
  if (pass != kChunks) {
    const int8_t *nz = a.noise + (size_t)b * 3 * n;
    const int first = pass == kColumns ? poly : 0;
    for (int idx = RT_TID; idx < npoly << lpts; idx += RT_NT) {
      const int pl = first + (idx >> lpts);
      const int p = col_pos(g, tile, idx & (pts - 1));
      uint32_t w = to_residue(nz[pl * n + p], q);
      if constexpr (Pt::kLoad) {
        if (pl == 1) w = addmod(pr.load(p, red), w, q);
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
    uint32_t e0 = x[pts + i];
    if constexpr (Pt::kStore) e0 = addmod(e0, pr.store(p), q);
    c0[p] = addmod(redc(red, vh, pkb[p]), e0, q);
    c1[p] = addmod(redc(red, vh, pka[p]), x[2 * pts + i], q);
  }
}

}  // namespace tiled
}  // namespace rt

#if defined(__CUDACC__)

namespace {

constexpr int kEncThreads = 256;

__global__ void __launch_bounds__(kEncThreads)
    enc_prologue_kernel(rt::tiled::EncNtt a, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step)
    rt::tiled::enc_prologue_item(a, t);
}

// one kernel per pass, so that a profile shows each under its own name
template <class Pt>
__global__ void __launch_bounds__(kEncThreads)
    enc_ntt_row_kernel(rt::tiled::EncNtt a, Pt pt) {
  extern __shared__ uint32_t enc_row_smem[];
  rt::tiled::enc_ntt_tile<rt::tiled::kRow>(a, pt, blockIdx.x, 0, 0,
                                           blockIdx.z, enc_row_smem);
}

template <class Pt>
__global__ void __launch_bounds__(kEncThreads)
    enc_ntt_cols_kernel(rt::tiled::EncNtt a, Pt pt) {
  extern __shared__ uint32_t enc_cols_smem[];
  rt::tiled::enc_ntt_tile<rt::tiled::kColumns>(
      a, pt, blockIdx.x, blockIdx.y % 3, blockIdx.y / 3, blockIdx.z,
      enc_cols_smem);
}

template <class Pt>
__global__ void __launch_bounds__(kEncThreads)
    enc_ntt_chunks_kernel(rt::tiled::EncNtt a, Pt pt) {
  extern __shared__ uint32_t enc_chunks_smem[];
  rt::tiled::enc_ntt_tile<rt::tiled::kChunks>(a, pt, blockIdx.z, 0,
                                              blockIdx.y, blockIdx.x,
                                              enc_chunks_smem);
}

// the prologue: heaps and noise (a grid-stride pass of at most 16 blocks
// per SM)
inline cudaError_t enc_prologue_launch(const rt::tiled::EncNtt &a,
                                       cudaStream_t s) {
  const long long total = rt::tiled::enc_prologue_items(a);
  const long long blocks = (total + kEncThreads - 1) / kEncThreads;
  enc_prologue_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16),
                        kEncThreads, 0, s>>>(a, total);
  return cudaGetLastError();
}

// the NTT passes, after the prologue (and whatever writes Pt's input)
template <class Pt>
cudaError_t enc_ntt_launch(const rt::tiled::EncNtt &a, const Pt &pt,
                           cudaStream_t s) {
  using namespace rt::tiled;
  static rt::SmemAllowance allow_row, allow_cols, allow_chunks;
  const Geo &g = a.g;
  const size_t w4 = sizeof(uint32_t);
  if (single_pass(g))
    return launch_pass(enc_ntt_row_kernel<Pt>, allow_row,
                       dim3(a.n_limbs, 1, a.batch), kEncThreads,
                       3 * w4 << g.logn, s, a, pt);
  const cudaError_t err = launch_pass(
      enc_ntt_cols_kernel<Pt>, allow_cols,
      dim3(a.n_limbs, 3 * col_tiles(g), a.batch), kEncThreads,
      w4 * col_points(g), s, a, pt);
  if (err != cudaSuccess) return err;
  return launch_pass(enc_ntt_chunks_kernel<Pt>, allow_chunks,
                     dim3(a.batch, chunk_tiles(g), a.n_limbs), kEncThreads,
                     3 * w4 * chunk_points(g), s, a, pt);
}

}  // namespace

#else  // host build: every block of each pass in order

#include <vector>

namespace {

inline void enc_prologue_host(const rt::tiled::EncNtt &a) {
  const long long total = rt::tiled::enc_prologue_items(a);
  for (long long t = 0; t < total; ++t) rt::tiled::enc_prologue_item(a, t);
}

template <class Pt>
void enc_ntt_host(const rt::tiled::EncNtt &a, const Pt &pt) {
  using namespace rt::tiled;
  const Geo &g = a.g;
  std::vector<uint32_t> smem((size_t)3 << g.logn);
  uint32_t *x = smem.data();
  for (int b = 0; b < a.batch; ++b)
    for (int l = 0; l < a.n_limbs; ++l) {
      if (single_pass(g)) {
        enc_ntt_tile<kRow>(a, pt, l, 0, 0, b, x);
        continue;
      }
      for (int poly = 0; poly < 3; ++poly)
        for (int t = 0; t < col_tiles(g); ++t)
          enc_ntt_tile<kColumns>(a, pt, l, poly, t, b, x);
      for (int t = 0; t < chunk_tiles(g); ++t)
        enc_ntt_tile<kChunks>(a, pt, l, 0, t, b, x);
    }
}

}  // namespace

#endif
