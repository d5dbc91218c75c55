// The tiled two-pass NTT / INTT and df32 SpecialFFT / IFFT of the client
// megakernels (encode_encrypt.cu, decrypt_decode.cu), of the staged
// SpecialFFT / IFFT K4 (fft_df.cu), of the folded and per-limb encrypts K2
// and K13a (client_pointwise.cu, through encrypt_tiled.cuh), and the
// transform stage (stage_tile and its pass launchers) that the limb-folded
// NTT / INTT K1 (ntt_limbs.cu), the per-prime NTT / INTT K12
// (ntt_rows.cu), the folded decrypt K3 (client_pointwise.cu) and the
// server's lift, base extension and scale-down (server_eval.cu) run.
//
// A row of 2^logn points is viewed as a 2^a x 2^b matrix, a + b = logn,
// point p at row p >> b, column p & (2^b - 1). The butterflies of a
// network stage of stride >= 2^b pair two points of one column; those of
// stride < 2^b pair two points of one aligned chunk of 2^b (a matrix row).
// So every network falls into two passes:
//   * a column pass: tiles of 2^lc whole columns (2^a points each), which
//     runs the stages of stride >= 2^b;
//   * a chunk pass: tiles of 2^lr whole chunks, which runs the stages of
//     stride < 2^b.
// The forward NTT (CT, DIT) and the SpecialIFFT (GS, lengths n .. 2) run
// the column pass first; the INTT (GS) and the SpecialFFT (CT, lengths
// 2 .. n) the chunk pass first. A tile is one block's work: loaded once
// into shared memory, its stages run there, and stored once. Passes are
// separate launches, so the launch boundary is the grid-wide barrier
// between them. The NTT loops run two stages per barrier, each thread
// holding four points of a line in registers; the FFT loops one.
//
// A tile that holds the whole row (lc = b, lr = a) is a single pass: the
// column stages and then the chunk stages run on one shared-memory row in
// natural order, since both tile maps are then the identity.
//
// Each butterfly is the one of the one-row stage loops (common.ntt_stages_t /
// intt_stages_t; their host copy is ntt_limbs.cu's ntt_limbs_loop_host)
// and of fft_df.fft_stage_pipeline, on the same words with the same
// twiddle words: the schedule changes where data lives and which block
// does which butterfly, never a butterfly's arithmetic. So a tiled
// transform gives the words of the stage loops bit for bit.
//
// The NTT twiddles come from a per-limb heap table made once per call
// (heap_twiddle): stage s's table tw_s[0 .. 2^s) at tw[2^s + j] (forward)
// and the inverse stage st's at tw[2^(logn-1-st) + j], each word the base
// of the seed table REDC'd by the factors of j's set bits, ascending: the
// very REDCs the stage loops' twiddle doubling (gen_twiddles_t) applies to
// reach index j.
//
// A transform stage is an NTT or INTT of independent rows whose first load
// and last store carry elementwise work: a stage type S gives, per row, its
// table row and what the first pass loads and the last pass stores, and
// stage_tile runs one tile of any pass of it. K1's and K12's stages load
// and store the words as they are, K3's load forms c0 + c1*s; the server's
// stages gather, REDC, centre and combine there.
//
// The REDC policy is the stage's, fixed at compile time: S::Red, made by
// s.make_red(table row). Every stage but K12's runs the general MontRedc;
// K12 (ntt_rows.cu) runs the shift-add SaRedc of paper eq. 9-11, as its TPU
// kernel does. The encrypt tile of encrypt_tiled.cuh takes its policy the
// same way from its plaintext policy Pt (K13a: SaRedc). The butterfly loops
// are templates on the policy, so no loop branches on it at run time.
//
// Compiles as plain C++ too (one thread per block, RT_SYNC a no-op), like
// client_common.cuh, so the host build checks these loops on a CPU.
#pragma once

#include "client_common.cuh"

#if defined(__CUDACC__)
#define RT_HD __host__ __device__ __forceinline__
#define RT_MEMBER __device__ __forceinline__
RT_FN uint32_t rt_brev(uint32_t x, int bits) {
  return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}
RT_FN int rt_ilog2(uint32_t x) { return 31 - __clz(x); }
RT_FN uint32_t rt_ldg(const uint32_t *p) { return __ldg(p); }
#else
#include <vector>
#define RT_HD static inline
#define RT_MEMBER inline
RT_FN uint32_t rt_brev(uint32_t x, int bits) {
  uint32_t r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1u);
  return r;
}
RT_FN int rt_ilog2(uint32_t x) { return 31 - __builtin_clz(x); }
RT_FN uint32_t rt_ldg(const uint32_t *p) { return *p; }
#endif

namespace rt {
namespace tiled {

// What one block of a transform runs: the whole row (a single pass), a
// column tile or a chunk tile.
enum Pass { kRow = 0, kColumns = 1, kChunks = 2 };

// Tile geometry of one transform of rows of 2^logn points.
struct Geo {
  int logn;  // row length 2^logn
  int a;     // column height 2^a; chunk length 2^b, b = logn - a
  int lc;    // a column tile holds 2^lc columns
  int lr;    // a chunk tile holds 2^lr chunks
  int brev;  // chunk tile t holds the chunks bitrev_a(t 2^lr + i), so that
             // a gather or scatter through a bit reversal meets runs of
             // 2^lr neighbouring words (0 on a single pass)
};

RT_HD int geo_b(const Geo &g) { return g.logn - g.a; }
RT_HD bool single_pass(const Geo &g) {
  return g.lc == geo_b(g) && g.lr == g.a;
}
RT_HD int col_tiles(const Geo &g) { return 1 << (geo_b(g) - g.lc); }
RT_HD int chunk_tiles(const Geo &g) { return 1 << (g.a - g.lr); }
RT_HD int col_points(const Geo &g) { return 1 << (g.a + g.lc); }
RT_HD int chunk_points(const Geo &g) { return 1 << (g.lr + geo_b(g)); }

// row position of slot i = (r << lc) + cc of column tile `tile`
RT_FN int col_pos(const Geo &g, int tile, int i) {
  const int r = i >> g.lc;
  const int cc = i & ((1 << g.lc) - 1);
  return (r << geo_b(g)) + (tile << g.lc) + cc;
}

// matrix row of chunk rr of chunk tile `tile`
RT_FN int chunk_row(const Geo &g, int tile, int rr) {
  const int r = (tile << g.lr) + rr;
  return g.brev ? (int)rt_brev((uint32_t)r, g.a) : r;
}

// row position of slot i = (rr << b) + c of chunk tile `tile`
RT_FN int chunk_pos(const Geo &g, int tile, int i) {
  const int b = geo_b(g);
  return (chunk_row(g, tile, i >> b) << b) + (i & ((1 << b) - 1));
}

// Slot of the k-th point a chunk tile's threads visit when they load or
// store through a bit reversal: neighbouring k walk neighbouring chunks
// (neighbouring rows of the reversed order), so a warp's global accesses
// fall in runs of 2^lr words.
RT_FN int chunk_slot_across(const Geo &g, int k) {
  return ((k & ((1 << g.lr) - 1)) << geo_b(g)) + (k >> g.lr);
}

// The same for a column tile that stores through a bit reversal: point
// (r, c) goes to bitrev(c) 2^a + bitrev_a(r), so neighbouring k walk
// neighbouring bitrev_a(r) in runs of 2^lr (the chunk pass's run), then the
// tile's columns, then the runs.
RT_FN int col_slot_across(const Geo &g, int k) {
  const int run = k & ((1 << g.lr) - 1);
  const int cc = (k >> g.lr) & ((1 << g.lc) - 1);
  const int rev_r = ((k >> (g.lr + g.lc)) << g.lr) + run;
  return ((int)rt_brev((uint32_t)rev_r, g.a) << g.lc) + cc;
}

// ---------------------------------------------------------------------------
// NTT twiddles: one limb's heap table (see the header)
// ---------------------------------------------------------------------------
template <class Red>
RT_FN uint32_t heap_twiddle(const uint32_t *trow, int logn, bool inverse,
                            int m, const Red &red) {
  const int u = rt_ilog2((uint32_t)m);
  const int j = m - (1 << u);
  const uint32_t *col =
      trow + (inverse ? inv_off(logn, logn - 1 - u) : fwd_off(u));
  uint32_t w = col[0];
  for (int k = 0; k < u; ++k)
    if ((j >> k) & 1) w = redc(red, w, col[1 + k]);
  return w;
}

// Word t of the heaps of one direction for consecutive table rows, laid out
// (rows, N) from tw: row t / N's heap twiddle t % N (slot 0 unused); table
// row r at table + r * stride. Made under MontRedc for every stage, those
// under SaRedc too: every correct REDC returns the same word
// (client_common.cuh), so the heap is the same table under either policy.
RT_FN void heap_word(const uint32_t *table, int stride, int logn,
                     bool inverse, uint32_t *tw, long long t) {
  const int m = (int)(t & ((1 << logn) - 1));
  if (m == 0) return;
  const uint32_t *trow = table + (size_t)(t >> logn) * stride;
  tw[t] = heap_twiddle(trow, logn, inverse, m, mont_redc(trow));
}

// ---------------------------------------------------------------------------
// NTT stage loops on a tile of npoly polynomials in shared memory (poly
// stride `pts`, the tile's points); tw: this limb's heap table
// ---------------------------------------------------------------------------

// A tile's lines as the NTT stage loops see them: line l (of 2^nl) holds
// 2^h points, point x at slot l * ls + x * xs; a step along a line is
// 2^gshift row positions (2^b in a column, 1 in a chunk). The stage that
// pairs points 2^ld apart in a line pairs them 2^(ld + gshift) apart in the
// row, so its twiddles are tw[2^(logn - 1 - ld - gshift) + j], and its
// group j of line l is (lrow << (h - 1 - ld)) + the line's own group, lrow
// the chunk's matrix row (0 in a column, which spans every group).
struct Lines {
  int nl, h, ls, xs, gshift;
  int tile;  // the chunk tile, -1 for a column tile
};

RT_FN Lines col_lines(const Geo &g) {
  return Lines{g.lc, g.a, 1, 1 << g.lc, geo_b(g), -1};
}

RT_FN Lines chunk_lines(const Geo &g, int tile) {
  return Lines{g.lr, geo_b(g), 1 << geo_b(g), 1, 0, tile};
}

// Work item idx over npoly x 2^nl lines x 2^lu units -> its first slot and
// its line's matrix row. Lines vary fastest on a column tile (neighbouring
// lines are neighbouring words), units on a chunk tile.
RT_FN uint32_t *line_item(uint32_t *x, int pts, const Lines &t,
                          const Geo &g, int lu, int idx, int &u, int &lrow) {
  const int per = t.nl + lu;
  const int k = idx & ((1 << per) - 1);
  int l;
  if (t.tile < 0) {
    l = k & ((1 << t.nl) - 1);
    u = k >> t.nl;
    lrow = 0;
  } else {
    u = k & ((1 << lu) - 1);
    l = k >> lu;
    lrow = chunk_row(g, t.tile, l);
  }
  return x + (idx >> per) * pts + l * t.ls;
}

// forward CT stages of every line, line distances 2^(h-1) .. 1: two per
// barrier in registers (four points, the two stages' four butterflies),
// the last one alone when h is odd
template <class Red>
RT_FN void ntt_fwd_lines(uint32_t *x, int npoly, int pts, const Lines &t,
                         const Geo &g, const uint32_t *tw, const Red &red) {
  const uint32_t q = red.q;
  int ld = t.h - 1;
  for (; ld >= 1; ld -= 2) {  // stages of distance 2^ld and 2^(ld-1)
    const uint32_t *w_hi = tw + (1 << (g.logn - 1 - ld - t.gshift));
    const uint32_t *w_lo = tw + (1 << (g.logn - ld - t.gshift));
    const int lu = t.h - 2;
    for (int idx = RT_TID; idx < npoly << (t.nl + lu); idx += RT_NT) {
      int u, lrow;
      uint32_t *y = line_item(x, pts, t, g, lu, idx, u, lrow);
      const int J = u >> (ld - 1);
      const int x0 = (J << (ld + 1)) + (u & ((1 << (ld - 1)) - 1));
      const int d = t.xs << (ld - 1);
      uint32_t *p = y + x0 * t.xs;
      uint32_t u0 = p[0], u1 = p[d], u2 = p[2 * d], u3 = p[3 * d];
      const int j = (lrow << (t.h - 1 - ld)) + J;
      const uint32_t w = rt_ldg(w_hi + j);
      uint32_t v = redc(red, u2, w);
      u2 = submod(u0, v, q);
      u0 = addmod(u0, v, q);
      v = redc(red, u3, w);
      u3 = submod(u1, v, q);
      u1 = addmod(u1, v, q);
      v = redc(red, u1, rt_ldg(w_lo + 2 * j));
      u1 = submod(u0, v, q);
      u0 = addmod(u0, v, q);
      v = redc(red, u3, rt_ldg(w_lo + 2 * j + 1));
      u3 = submod(u2, v, q);
      u2 = addmod(u2, v, q);
      p[0] = u0;
      p[d] = u1;
      p[2 * d] = u2;
      p[3 * d] = u3;
    }
    RT_SYNC();
  }
  if (ld == 0) {  // the last stage, distance 1
    const uint32_t *ws = tw + (1 << (g.logn - 1 - t.gshift));
    const int lu = t.h - 1;
    for (int idx = RT_TID; idx < npoly << (t.nl + lu); idx += RT_NT) {
      int u, lrow;
      uint32_t *y = line_item(x, pts, t, g, lu, idx, u, lrow);
      uint32_t *p = y + 2 * u * t.xs;
      const uint32_t a = p[0];
      const uint32_t v = redc(red, p[t.xs], rt_ldg(ws + (lrow << lu) + u));
      p[0] = addmod(a, v, q);
      p[t.xs] = submod(a, v, q);
    }
    RT_SYNC();
  }
}

// inverse GS stages of every line, line distances 1 .. 2^(h-1): two per
// barrier in registers, the last one alone when h is odd; N^-1 is left to
// the caller's store
template <class Red>
RT_FN void ntt_inv_lines(uint32_t *x, int npoly, int pts, const Lines &t,
                         const Geo &g, const uint32_t *tw, const Red &red) {
  const uint32_t q = red.q;
  int ld = 0;
  for (; ld + 1 < t.h; ld += 2) {  // stages of distance 2^ld and 2^(ld+1)
    const uint32_t *w_lo = tw + (1 << (g.logn - 1 - ld - t.gshift));
    const uint32_t *w_hi = tw + (1 << (g.logn - 2 - ld - t.gshift));
    const int lu = t.h - 2;
    for (int idx = RT_TID; idx < npoly << (t.nl + lu); idx += RT_NT) {
      int u, lrow;
      uint32_t *y = line_item(x, pts, t, g, lu, idx, u, lrow);
      const int J = u >> ld;
      const int x0 = (J << (ld + 2)) + (u & ((1 << ld) - 1));
      const int d = t.xs << ld;
      uint32_t *p = y + x0 * t.xs;
      uint32_t u0 = p[0], u1 = p[d], u2 = p[2 * d], u3 = p[3 * d];
      const int j = (lrow << (t.h - 2 - ld)) + J;
      uint32_t s = addmod(u0, u1, q);
      u1 = redc(red, submod(u0, u1, q), rt_ldg(w_lo + 2 * j));
      u0 = s;
      s = addmod(u2, u3, q);
      u3 = redc(red, submod(u2, u3, q), rt_ldg(w_lo + 2 * j + 1));
      u2 = s;
      const uint32_t w = rt_ldg(w_hi + j);
      s = addmod(u0, u2, q);
      u2 = redc(red, submod(u0, u2, q), w);
      u0 = s;
      s = addmod(u1, u3, q);
      u3 = redc(red, submod(u1, u3, q), w);
      u1 = s;
      p[0] = u0;
      p[d] = u1;
      p[2 * d] = u2;
      p[3 * d] = u3;
    }
    RT_SYNC();
  }
  if (ld < t.h) {  // the last stage, distance 2^(h-1)
    const uint32_t *ws = tw + (1 << (g.logn - 1 - ld - t.gshift));
    const int lu = t.h - 1;
    for (int idx = RT_TID; idx < npoly << (t.nl + lu); idx += RT_NT) {
      int u, lrow;
      uint32_t *y = line_item(x, pts, t, g, lu, idx, u, lrow);
      const int J = u >> ld;
      uint32_t *p = y + ((J << (ld + 1)) + (u & ((1 << ld) - 1))) * t.xs;
      const int d = t.xs << ld;
      const uint32_t a = p[0], b = p[d];
      const uint32_t w = rt_ldg(ws + (lrow << (t.h - 1 - ld)) + J);
      p[0] = addmod(a, b, q);
      p[d] = redc(red, submod(a, b, q), w);
    }
    RT_SYNC();
  }
}

// ---------------------------------------------------------------------------
// df32 SpecialFFT stage loops on a tile of one row's n = 2^logn complex
// points (four float planes in shared memory); tw: the packed (4, n)
// twiddle table of the direction
// ---------------------------------------------------------------------------

// encode direction, GS stages 0 .. a-1 (half length 2^(logn-1-s) >= 2^b)
// on column tile `tile`
RT_FN void fft_inv_cols(Planes x, const Geo &g, int tile, const float *tw) {
  const int n = 1 << g.logn, b = geo_b(g), lc = g.lc;
  for (int s = 0; s < g.a; ++s) {
    const int ld = g.a - 1 - s;
    const int off = n - (n >> s);
    for (int idx = RT_TID; idx < 1 << (g.a - 1 + lc); idx += RT_NT) {
      const int kr = idx >> lc, cc = idx & ((1 << lc) - 1);
      const int rlo = kr & ((1 << ld) - 1);
      const int i0 = ((((kr >> ld) << (ld + 1)) + rlo) << lc) + cc;
      const int i1 = i0 + (1 << (ld + lc));
      const int wi = (rlo << b) + (tile << lc) + cc;  // p0 mod half length
      const dfc u = load_dfc(x, i0), v = load_dfc(x, i1);
      store_dfc(x, i0, dfc_add(u, v));
      store_dfc(x, i1, dfc_mul(dfc_sub(u, v), load_tw(tw, n, off + wi)));
    }
    RT_SYNC();
  }
}

// encode direction, GS stages a .. logn-1 (half length < 2^b) on a chunk
// tile (the twiddle depends on the position within the chunk only)
RT_FN void fft_inv_chunks(Planes x, const Geo &g, const float *tw) {
  const int n = 1 << g.logn, b = geo_b(g);
  for (int s = g.a; s < g.logn; ++s) {
    const int loglh = g.logn - 1 - s;
    const int off = n - (n >> s);
    for (int idx = RT_TID; idx < 1 << (g.lr + b - 1); idx += RT_NT) {
      const int rr = idx >> (b - 1);
      const int kk = idx & ((1 << (b - 1)) - 1);
      const int i = kk & ((1 << loglh) - 1);
      const int i0 = (rr << b) + ((kk >> loglh) << (loglh + 1)) + i;
      const int i1 = i0 + (1 << loglh);
      const dfc u = load_dfc(x, i0), v = load_dfc(x, i1);
      store_dfc(x, i0, dfc_add(u, v));
      store_dfc(x, i1, dfc_mul(dfc_sub(u, v), load_tw(tw, n, off + i)));
    }
    RT_SYNC();
  }
}

// decode direction, CT stages 0 .. b-1 (half length 2^s < 2^b) on a chunk
// tile
RT_FN void fft_fwd_chunks(Planes x, const Geo &g, const float *tw) {
  const int n = 1 << g.logn, b = geo_b(g);
  for (int s = 0; s < b; ++s) {
    const int off = (1 << s) - 1;
    for (int idx = RT_TID; idx < 1 << (g.lr + b - 1); idx += RT_NT) {
      const int rr = idx >> (b - 1);
      const int kk = idx & ((1 << (b - 1)) - 1);
      const int i = kk & ((1 << s) - 1);
      const int i0 = (rr << b) + ((kk >> s) << (s + 1)) + i;
      const int i1 = i0 + (1 << s);
      const dfc u = load_dfc(x, i0);
      const dfc v = dfc_mul(load_dfc(x, i1), load_tw(tw, n, off + i));
      store_dfc(x, i0, dfc_add(u, v));
      store_dfc(x, i1, dfc_sub(u, v));
    }
    RT_SYNC();
  }
}

// decode direction, CT stages b .. logn-1 (half length >= 2^b) on column
// tile `tile`
RT_FN void fft_fwd_cols(Planes x, const Geo &g, int tile, const float *tw) {
  const int n = 1 << g.logn, b = geo_b(g), lc = g.lc;
  for (int s = b; s < g.logn; ++s) {
    const int ld = s - b;
    const int off = (1 << s) - 1;
    for (int idx = RT_TID; idx < 1 << (g.a - 1 + lc); idx += RT_NT) {
      const int kr = idx >> lc, cc = idx & ((1 << lc) - 1);
      const int rlo = kr & ((1 << ld) - 1);
      const int i0 = ((((kr >> ld) << (ld + 1)) + rlo) << lc) + cc;
      const int i1 = i0 + (1 << (ld + lc));
      const int wi = (rlo << b) + (tile << lc) + cc;  // p0 mod 2^s
      const dfc u = load_dfc(x, i0);
      const dfc v = dfc_mul(load_dfc(x, i1), load_tw(tw, n, off + wi));
      store_dfc(x, i0, dfc_add(u, v));
      store_dfc(x, i1, dfc_sub(u, v));
    }
    RT_SYNC();
  }
}

// four planes of `pts` floats each, one after the other from `smem`
RT_FN Planes smem_planes(float *smem, int pts) {
  return Planes{smem, smem + pts, smem + 2 * pts, smem + 3 * pts};
}

// ---------------------------------------------------------------------------
// Tile planning, shared by the CUDA entries and their host builds
// ---------------------------------------------------------------------------

// Rows up to this size take a single pass: one tile holds the whole row.
constexpr int kSinglePassLogn = 11;      // NTT: 3 x 2^11 words = 24 KB
constexpr int kSinglePassLognFft = 10;   // FFT: 2^10 points x 16 B = 16 KB
// A pass's grid should have at least this many blocks (two per SM of an
// H100); tiles shrink towards their lower bound until it does.
constexpr long long kTargetBlocks = 2 * 132;

// the largest log tile size in [lo, hi] (both capped at `free`, the log
// of the lines a row has) whose grid of other * 2^(free - l) blocks
// reaches kTargetBlocks; lo where none does
inline int pick_log_tile(int free, int lo, int hi, long long other) {
  hi = hi < free ? hi : free;
  lo = lo < hi ? lo : hi;
  int l = hi;
  while (l > lo && (other << (free - l)) < kTargetBlocks) --l;
  return l;
}

// The geometry of a transform of `rows_col` / `rows_chunk` independent
// rows per column / chunk pass (the blocks beside the tile index). a, lc,
// lr < 0 take the defaults: a = ceil(logn / 2); a single pass when logn <=
// single_logn, else the tiles above within [lc_lo, lc_hi] / [lr_lo,
// lr_hi]. Forcing lc = b and lr = a forces a single pass; `brev` is kept
// only on two passes.
inline Geo plan_geo(int logn, int a, int lc, int lr, int single_logn,
                    long long rows_col, long long rows_chunk, int lc_lo,
                    int lc_hi, int lr_lo, int lr_hi, int brev) {
  Geo g;
  g.logn = logn;
  g.a = a >= 0 ? a : (logn + 1) / 2;
  const int b = logn - g.a;
  const bool one = a < 0 && lc < 0 && lr < 0 && logn <= single_logn;
  g.lc = lc >= 0 ? lc : (one ? b : pick_log_tile(b, lc_lo, lc_hi, rows_col));
  g.lr = lr >= 0 ? lr
                 : (one ? g.a : pick_log_tile(g.a, lr_lo, lr_hi, rows_chunk));
  g.brev = single_pass(g) ? 0 : brev;
  return g;
}

inline bool geo_valid(const Geo &g) {
  const int b = g.logn - g.a;
  return g.logn >= 2 && g.a >= 1 && b >= 1 && g.lc >= 0 && g.lc <= b &&
         g.lr >= 0 && g.lr <= g.a;
}

// The geometry of a df32 SpecialFFT / IFFT of `rows` rows of 2^logn points
// (the FFT of K6, K5 and K4): chunk tiles in bit-reversed order, so that the
// gather and scatter through the bit reversal meet runs of 2^lr words.
inline Geo fft_geo(int logn, int a, int lc, int lr, long long rows) {
  return plan_geo(logn, a, lc, lr, kSinglePassLognFft, rows, rows, 2, 3, 2,
                  3, 1);
}

#if defined(__CUDACC__)
// Launch one pass of `threads` threads a block with `smem` bytes of dynamic
// shared memory, allowed first where above the default 48 KB. `allow`
// records what was allowed for this kernel: one SmemAllowance per kernel.
template <typename Kernel, typename... Args>
inline cudaError_t launch_pass(Kernel kernel, SmemAllowance &allow,
                               dim3 grid, int threads, size_t smem,
                               cudaStream_t s, const Args &...args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_dynamic_smem(kernel, smem, allow);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// Transform stages: a tiled NTT / INTT of independent rows, a stage's
// elementwise work in its first load and last store
// ---------------------------------------------------------------------------

// What every pass of a stage shares: its tile geometry, the constant table
// (row r at table + r * ncols: q, the REDC constant, N^-1 and the seed
// columns) and the heaps of the stage's direction, table row r's at tw + r N.
struct Tiling {
  Geo g;
  const uint32_t *table;
  int ncols;
  const uint32_t *tw;
};

// The tiling of an NTT / INTT stage over `rows` rows of 2^logn words, as K1
// and K3 plan it (a, lc, lr < 0: the defaults; brev: the chunk tiles'
// order, 0 on the card); tw: the heaps, table row r's at tw + r N.
inline Tiling rows_tiling(const uint32_t *table, int ncols,
                          const uint32_t *tw, long long rows, int logn,
                          int a, int lc, int lr, int brev) {
  return Tiling{plan_geo(logn, a, lc, lr, kSinglePassLogn, rows, rows, 3, 5,
                         1, 3, brev),
                table, ncols, tw};
}

// log2 of a pass's tiles per row
RT_HD int log_tiles(const Geo &g, int pass) {
  return pass == kRow ? 0 : (pass == kColumns ? geo_b(g) - g.lc : g.a - g.lr);
}

// blocks of a pass over `rows` rows
RT_HD long long pass_blocks(const Geo &g, int pass, long long rows) {
  return rows << log_tiles(g, pass);
}

// whether the geometry is valid and every pass's grid fits a grid's x
// extent
inline bool stage_fits(const Geo &g, long long rows) {
  return geo_valid(g) && pass_blocks(g, kColumns, rows) <= 0x7FFFFFFFLL &&
         pass_blocks(g, kChunks, rows) <= 0x7FFFFFFFLL;
}

// One tile of block `blk` (row blk >> log_tiles, tile the rest) of a pass
// of the stage S: a forward NTT (S::kInverse false: the column pass, then
// the chunk pass) or an INTT (the chunk pass, then the column pass, whose
// store applies N^-1), or on one pass (kRow) the whole row. S::bind(row)
// gives the row's Row: its table row `prime`, the row buffer `mid` that
// holds the transform between the passes, load(p) (the word the first
// pass reads at position p: the stage's elementwise work in front of the
// transform) and store(p, v) (what the last pass does with the transform's
// word v at p). s.make_red(trow) gives the REDC policy S::Red of the
// butterflies and of N^-1.
template <int pass, class S>
RT_BODY void stage_tile(const S &s, const Tiling &t, long long blk,
                        uint32_t *x) {
  constexpr bool inverse = S::kInverse;
  const Geo &g = t.g;
  const int lt = log_tiles(g, pass);
  const int tile = (int)(blk & ((1 << lt) - 1));
  const typename S::Row r = s.bind(blk >> lt);
  const uint32_t *trow = t.table + (size_t)r.prime * t.ncols;
  const typename S::Red red = s.make_red(trow);
  const uint32_t *tw = t.tw + ((size_t)r.prime << g.logn);
  constexpr bool first =
      pass == kRow || pass == (inverse ? kChunks : kColumns);
  const int pts = pass == kChunks ? chunk_points(g) : col_points(g);
  for (int i = RT_TID; i < pts; i += RT_NT) {
    const int p =
        pass == kChunks ? chunk_pos(g, tile, i) : col_pos(g, tile, i);
    x[i] = first ? r.load(p) : r.mid[p];
  }
  RT_SYNC();
  if (!inverse) {
    if (pass != kChunks) ntt_fwd_lines(x, 1, pts, col_lines(g), g, tw, red);
    if (pass != kColumns)
      ntt_fwd_lines(x, 1, pts, chunk_lines(g, tile), g, tw, red);
  } else {
    if (pass != kColumns)
      ntt_inv_lines(x, 1, pts, chunk_lines(g, tile), g, tw, red);
    if (pass != kChunks) ntt_inv_lines(x, 1, pts, col_lines(g), g, tw, red);
  }
  if (pass != kRow && first) {  // between the passes: the raw transform
    for (int i = RT_TID; i < pts; i += RT_NT)
      r.mid[pass == kChunks ? chunk_pos(g, tile, i) : col_pos(g, tile, i)] =
          x[i];
    return;
  }
  const uint32_t ninv = trow[OFF_NINV];
  for (int i = RT_TID; i < pts; i += RT_NT) {
    const int p =
        pass == kChunks ? chunk_pos(g, tile, i) : col_pos(g, tile, i);
    r.store(p, inverse ? redc(red, x[i], ninv) : x[i]);
  }
}

#if defined(__CUDACC__)

// the most threads of a pass's block
constexpr int kPassThreads = 256;

// threads of a pass's blocks: a quarter of the tile's points (the stage
// loops give each thread four points), within [32, kPassThreads]
inline int pass_threads(int pts) {
  const int t = pts / 4;
  return t < 32 ? 32 : (t > kPassThreads ? kPassThreads : t);
}

template <class S>
struct PassKernels {
  void (*row)(S, Tiling);
  void (*cols)(S, Tiling);
  void (*chunks)(S, Tiling);
};

// A stage's three pass kernels, prefix_{row,cols,chunks}_kernel (one per
// pass, so that a profile shows each under its own name), and
// stage_kernels(S), which returns them.
#define RT_PASS_KERNEL(name, S, pass)                                       \
  __global__ void __launch_bounds__(rt::tiled::kPassThreads)                \
      name(S s, rt::tiled::Tiling t) {                                      \
    extern __shared__ uint32_t name##_smem[];                               \
    rt::tiled::stage_tile<rt::tiled::pass>(s, t, blockIdx.x, name##_smem);  \
  }
#define RT_STAGE_KERNELS(prefix, S)                                         \
  RT_PASS_KERNEL(prefix##_row_kernel, S, kRow)                              \
  RT_PASS_KERNEL(prefix##_cols_kernel, S, kColumns)                         \
  RT_PASS_KERNEL(prefix##_chunks_kernel, S, kChunks)                        \
  inline rt::tiled::PassKernels<S> stage_kernels(const S &) {               \
    return {prefix##_row_kernel, prefix##_cols_kernel,                      \
            prefix##_chunks_kernel};                                        \
  }

// The stage s over `rows` rows on stream `st`: one pass, or two (the
// column pass first for an NTT, the chunk pass first for an INTT).
template <class S>
inline cudaError_t launch_stage(const PassKernels<S> &k, const S &s,
                                const Tiling &t, long long rows,
                                cudaStream_t st) {
  if (!geo_valid(t.g)) return cudaErrorInvalidValue;
  if (!stage_fits(t.g, rows)) return cudaErrorInvalidConfiguration;
  static SmemAllowance allow[3];  // one per kernel of S
  const size_t w4 = sizeof(uint32_t);
  if (single_pass(t.g)) {
    const int pts = 1 << t.g.logn;
    return launch_pass(k.row, allow[0], dim3((unsigned)rows),
                       pass_threads(pts), w4 * pts, st, s, t);
  }
  for (int step = 0; step < 2; ++step) {
    const bool col_pass = (step == 0) != S::kInverse;
    const int pass = col_pass ? kColumns : kChunks;
    const int pts = col_pass ? col_points(t.g) : chunk_points(t.g);
    const cudaError_t err = launch_pass(
        col_pass ? k.cols : k.chunks, allow[col_pass ? 1 : 2],
        dim3((unsigned)pass_blocks(t.g, pass, rows)), pass_threads(pts),
        w4 * pts, st, s, t);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The heaps of one direction for table rows 0 .. rows - 1 into tw (rows,
// N), a grid-stride pass of at most 16 blocks an SM (K1's, K3's and K12's
// prologue).
template <bool inverse>
__global__ void __launch_bounds__(kPassThreads)
    heap_rows_kernel(const uint32_t *table, int ncols, int logn,
                     uint32_t *tw, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step)
    heap_word(table, ncols, logn, inverse, tw, t);
}

template <bool inverse>
inline cudaError_t launch_heap_rows(const uint32_t *table, int ncols,
                                    int logn, uint32_t *tw, long long rows,
                                    cudaStream_t s) {
  const long long total = rows << logn;
  long long blocks = (total + kPassThreads - 1) / kPassThreads;
  blocks = blocks < 132 * 16 ? blocks : 132 * 16;
  heap_rows_kernel<inverse><<<(int)blocks, kPassThreads, 0, s>>>(
      table, ncols, logn, tw, total);
  return cudaGetLastError();
}

#else  // host build: every block of each pass in order, one thread a block

inline void heap_rows_host(const uint32_t *table, int ncols, int logn,
                           bool inverse, uint32_t *tw, long long rows) {
  for (long long t = 0; t < rows << logn; ++t)
    heap_word(table, ncols, logn, inverse, tw, t);
}

template <int pass, class S>
void host_pass(const S &s, const Tiling &t, long long rows, uint32_t *smem) {
  for (long long blk = 0; blk < pass_blocks(t.g, pass, rows); ++blk)
    stage_tile<pass>(s, t, blk, smem);
}

// The stage s over `rows` rows; false if the geometry is out of range.
template <class S>
bool run_stage_host(const S &s, const Tiling &t, long long rows) {
  if (!geo_valid(t.g)) return false;
  std::vector<uint32_t> smem((size_t)1 << t.g.logn);
  if (single_pass(t.g)) {
    host_pass<kRow>(s, t, rows, smem.data());
  } else if (!S::kInverse) {
    host_pass<kColumns>(s, t, rows, smem.data());
    host_pass<kChunks>(s, t, rows, smem.data());
  } else {
    host_pass<kChunks>(s, t, rows, smem.data());
    host_pass<kColumns>(s, t, rows, smem.data());
  }
  return true;
}

#endif

}  // namespace tiled
}  // namespace rt
