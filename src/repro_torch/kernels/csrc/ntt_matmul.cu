// Four-step negacyclic NTT / INTT as modular matrix products of int8
// digits on the tensor cores, for Hopper (sm_90a): K14.
//
// Replaces the TPU kernels src/repro/kernels/ntt_matmul.py:_kernel_fwd and
// :_kernel_inv (ntt_rows_mm / intt_rows_mm: Bailey's four-step algorithm
// with N = N1 x N2, the psi-twist and the T matrix generated in VMEM, and
// two modular matmuls on the MXU, each as 16 int8 x int8 -> int32 digit
// products recombined mod q by one Barrett multiply per digit weight).
// Forward, per row x of a prime with psi (W = psi^2):
//
//   p[n] = x[n] psi^n;  P[n1, n2] = p[n2 N1 + n1];  B = P F2;
//   C = B o T, T[n1, k2] = W^(n1 k2);  D^T = C^T F1;  out[k1 N2 + k2] = D
//
// (natural order: out[k] = x(psi^(2k+1))); the inverse runs mirrored with
// F1^-1 (carrying N1^-1), T^-1, F2^-1 (carrying N2^-1) and psi^-n. Output
// words are bit-identical to the plain version
// (ntt_matmul.limb_rows_mm_plain), to K1's output under the bit-reversal
// permutation, and to the JAX reference: every exact reduction returns the
// same canonical word, so the order of the sums and the way they are
// reduced change no output.
//
// The psi^k table is a constant of the primes: ntt_mm_pow_table builds it
// once (pow_table_kernel: tab[l][k] = psi_l^k R mod q for k < 2N, each by
// square-and-multiply from the limb's log2(2N) constants mont(psi^(2^j)),
// shift-add REDC), and the wrapper keeps it beside the digit tables.
// psi^-n = tab[2N - n] and W^(+-e) = tab[+-2e mod 2N], so one table serves
// both directions. Then one C call transforms an (L, rows, N) stack (limbs
// folded into the grid; the reference launches once per limb) with two
// launches, mm_stage1_kernel and mm_stage2_kernel, one per modular matmul
// (the same block body), the intermediate in an (L, rows, N) global
// scratch. A block owns one row's strip of BM = 64 rows of A (M x K, K =
// N1 or N2 <= 256):
//   1. it loads the strip once (twisting it in stage 1 of the forward),
//      splits each word into four balanced base-256 digits (one add and
//      one xor for all four, then a byte transpose) and keeps it in shared
//      memory as four digit planes, four consecutive k of a digit per
//      32-bit word: the word an int8 mma fragment register holds;
//   2. for each 32-column n-tile it streams the table's digit planes
//      (ntt_matmul.packed: (L, 4, Nc, K/4), the same words) through a ring
//      of two shared-memory k-slices filled by cp.async (the next slice in
//      flight while the current one is used; the first before the strip
//      loads), and each of its four warps runs, per 32-deep k-step, the 16
//      digit products of its 16 x 32 output tile as
//      mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, seven int32
//      accumulators per output (one per digit weight g = i + j; |sum| <=
//      4 * 256 * 128 * 128 = 2^24: exact);
//   3. the epilogue combines the seven sums in 64 bits, S = sum_g s_g
//      (2^(8g+32) mod q) (|S| < 2^27 q), reduces S + 2^27 q once by a
//      64-bit Montgomery REDC to (A F) mod q, multiplies by T, T^-1 or
//      psi^-n where the stage needs it (shift-add REDC) and writes it.
// Register budget (the design constraint): the seven accumulators of a
// 16 x 32 warp tile are 112 registers a thread, plus 16 of A fragments and
// 8 of B fragments (ptxas: about 210 in all, no spills); blocks of 128
// threads, two an SM (106 KB of shared memory each at K = 256): seven
// accumulators on a small warp tile rather than one weight at a time over
// whole digit planes, with the A strip resident so that each A word is
// twisted and split once per stage, not once per n-tile.
// Fragment rows, k and columns come from the frag_* maps below (PTX ISA,
// "Matrix Fragments for mma.m16n8k32"); the shared-memory row strides are
// 4 mod 8 words, so the eight rows of a fragment load fall in distinct
// banks. K < 32 (tiny: 8 x 8) and ragged tiles are padded with zero
// digits, which add nothing.
//
// What bounds it on an H100: the least work is 2 x 16 x N1 N2 (N1 or N2)
// int8 products per row on the tensor cores, but they no longer set the
// pace (taking the mma instructions out changes the time by a few percent:
// they overlap the other phases; tools/k14_phases.py, PERF.md). The int32
// work and its latency at 8 warps an SM do: the epilogue's 64-bit
// combination and shift-add REDC, the strip's twist and split, and the
// table slices' L2 latency, in phases a block runs in turn (the registers
// and the shared memory allow no third block an SM). Left for later: wgmma with the A strip and the
// tables in shared memory by TMA and warp-specialised producers, so that
// the int32 phases overlap the products; TMA multicast of the tables across
// a cluster; a persistent grid; stage 1 writing C's digits so that stage 2
// splits nothing.
//
// The same source compiles as plain C++ (one thread per block):
// ntt_mm_pow_table_host fills the table and ntt_mm_host runs each block's
// phases in turn, emulating each warp's mma from its 32 lanes' fragment
// registers through the same frag_* maps, so the CPU tests check the
// fragment loads, the tiles and this arithmetic against the plain version.
#include "client_common.cuh"

namespace mm {

// (L, n_consts) int32 rows of per-limb constants (ntt_matmul.py: MM_*):
//   [0, 8) the prime's shift-add REDC row (common.sa_table)
//   [8] -q^-1 mod 2^32  [9] R mod q  [10, 17) 2^(8g+32) mod q, g = 0..6
//   [17, 17 + logn + 1) mont(psi^(2^j))
constexpr int MM_QINV = 8;
constexpr int MM_R = 9;
constexpr int MM_C = 10;
constexpr int MM_PW = 17;

constexpr int NG = 7;              // digit weights g = i + j
constexpr int ND = 4;              // balanced base-256 digits of a word
constexpr int BM = 64;             // rows of A a block keeps
constexpr int BN = 32;             // columns of an n-tile
constexpr int WARPS = BM / 16;     // a warp's tile: 16 rows x BN columns
constexpr int THREADS = 32 * WARPS;
constexpr int NN = BN / 8;         // n8 tiles of a warp tile

enum { EPI_NONE = 0, EPI_T = 1, EPI_TINV = 2, EPI_UNTWIST = 3 };

struct Consts {
  rt::SaRedc sa;
  uint32_t qinv, r1;
  int32_t c[NG];  // 2^(8g+32) mod q < 2^31
};

RT_FN Consts load_consts(const int32_t *row) {
  Consts k;
  k.sa = rt::sa_redc(row);
  k.qinv = (uint32_t)row[MM_QINV];
  k.r1 = (uint32_t)row[MM_R];
  for (int g = 0; g < NG; ++g) k.c[g] = row[MM_C + g];
  return k;
}

// Fragment maps of mma.m16n8k32 with .s8 operands, lane = 4 g + t: which
// row / column and which packed k-word (4 consecutive k, byte b = k % 4)
// register r of a lane holds. A (16 x 32, row-major): registers 0..3 hold
// rows g, g + 8, g, g + 8 at words t, t, t + 4, t + 4. B (32 x 8,
// column-major): column g, words t and t + 4. C / D (16 x 8 int32): rows
// g, g, g + 8, g + 8, columns 2t, 2t + 1, 2t, 2t + 1.
RT_FN int frag_a_row(int lane, int r) { return (lane >> 2) + 8 * (r & 1); }
RT_FN int frag_a_kw(int lane, int r) { return (lane & 3) + 4 * (r >> 1); }
RT_FN int frag_b_col(int lane) { return lane >> 2; }
RT_FN int frag_b_kw(int lane, int r) { return (lane & 3) + 4 * r; }
RT_FN int frag_c_row(int lane, int r) { return (lane >> 2) + 8 * (r >> 1); }
RT_FN int frag_c_col(int lane, int r) { return 2 * (lane & 3) + (r & 1); }

// one modular matmul of the four-step transform: out = A F mod q over an
// (M, K) x (K, Nc) product, A[m, k] = src_row[k * a_sk + m] (times psi^idx
// when twist), out_row[m * o_sm + n * o_sn] (times T, T^-1 or psi^-o per
// epi)
struct Stage {
  const uint32_t *src;
  uint32_t *dst;
  const int32_t *f;  // (L, 4, Nc, K/4): digit j, column, packed k
  int M, K, Nc;
  int a_sk, o_sm, o_sn;
  int twist, epi;
};

struct Geo {
  const int32_t *consts;  // (L, n_consts)
  const uint32_t *tab;    // (L, 2N) psi^k R mod q
  int rows, logn, n_consts;
};

// Shared-memory layout of a block: the A strip as ND planes of BM rows of
// kwp words (K padded to a multiple of 32), row stride sa; a ring of
// NSLICE table slices, each ND planes of BN columns of ksw words, column
// stride sb. Both strides are 4 mod 8, so the rows g = 0..7 of a fragment
// load hit distinct banks.
constexpr int NSLICE = 2;
struct Smem {
  int kwp, sa;  // packed words of a padded A row, its stride
  int ksw, sb;  // packed words of a table slice, its column stride
};

// ksw_force > 0 forces the slice (8, 16 or 32 words; the host tests);
// host code
inline Smem smem_plan(int K, int ksw_force) {
  Smem s;
  s.kwp = ((K + 31) / 32) * 8;
  s.sa = s.kwp + 4;
  s.ksw = ksw_force > 0 ? ksw_force : (s.kwp < 32 ? s.kwp : 32);
  s.sb = s.ksw + 4;
  return s;
}

RT_FN size_t slice_words(const Smem &s) { return (size_t)ND * BN * s.sb; }

inline size_t smem_words(const Smem &s) {
  return (size_t)ND * BM * s.sa + (size_t)NSLICE * ND * BN * s.sb;
}

struct Acc {
  int32_t g[NG][NN][4];
};

// every loop over the accumulators is unrolled, so that they stay in
// registers (an index the compiler cannot resolve puts them on the stack)
RT_FN void zero(Acc &a) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) a.g[g][n][r] = 0;
}

RT_FN uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDACC__)
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int b = 0; b < 4; ++b)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * b)) & 7))) & 255u) << (8 * b);
  return r;
#endif
}

// The balanced base-256 digits of v (< 0x7F7F7F80) as int8 bytes: with
// b = v + 0x80808080 (the byte carries are the digit carries), digit i =
// byte i of b minus 128, i.e. byte i of b ^ 0x80808080.
RT_FN uint32_t digit_bytes(uint32_t v) {
  return (v + 0x80808080u) ^ 0x80808080u;
}

// Stage the block's A strip, rows [m0, m0 + BM) x all K, as packed digit
// planes: As[(i BM + m) sa + kw] holds digit i of A[m, 4kw .. 4kw + 3].
// Lanes take (m, kw) as m = lane / 4, kw % 4 = lane % 4: the global loads
// meet runs of 8 words, the stores distinct banks. A thread issues the
// loads of AU items (and their twist factors) before it uses any, so that
// they are in flight together.
constexpr int AU = 4;
RT_FN void load_a_strip(const Stage &st, const Geo &geo, const Consts &k,
                        const Smem &sm, int z, int m0, int32_t *As) {
  const int n = 1 << geo.logn;
  const int l = z / geo.rows;
  const uint32_t *src = st.src + (size_t)z * n;
  const uint32_t *tab = geo.tab + ((size_t)l << (geo.logn + 1));
  const int items = BM * sm.kwp;
  const size_t plane = (size_t)BM * sm.sa;
  for (int base = RT_TID; base < items; base += AU * RT_NT) {
    uint32_t v[AU][4], f[AU][4];
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const int it = base + u * RT_NT;
      const int m = (it >> 2) % BM;
      const int kw = ((it >> 2) / BM) * 4 + (it & 3);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = 4 * kw + t;
        const int idx = kk * st.a_sk + m0 + m;
        const bool in = it < items && m0 + m < st.M && kk < st.K;
        v[u][t] = in ? src[idx] : 0u;
        f[u][t] = in && st.twist ? tab[idx] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const int it = base + u * RT_NT;
      if (it >= items) break;
      uint32_t w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w[t] = digit_bytes(st.twist ? rt::redc(k.sa, v[u][t], f[u][t])
                                    : v[u][t]);
      // 4 x 4 byte transpose: digit i of the four k into one word
      const uint32_t lo01 = byte_perm(w[0], w[1], 0x5140);
      const uint32_t lo23 = byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi01 = byte_perm(w[0], w[1], 0x7362);
      const uint32_t hi23 = byte_perm(w[2], w[3], 0x7362);
      const int m = (it >> 2) % BM;
      const int kw = ((it >> 2) / BM) * 4 + (it & 3);
      int32_t *row = As + (size_t)m * sm.sa + kw;
      row[0] = (int32_t)byte_perm(lo01, lo23, 0x5410);
      row[plane] = (int32_t)byte_perm(lo01, lo23, 0x7632);
      row[2 * plane] = (int32_t)byte_perm(hi01, hi23, 0x5410);
      row[3 * plane] = (int32_t)byte_perm(hi01, hi23, 0x7632);
    }
  }
}

// Copies into shared memory that complete in the background (cp.async,
// 16 or 4 bytes, zero-filled where `valid` is false), grouped per table
// slice; the host copies at once.
RT_FN void copy_async(int32_t *dst, const int32_t *src, int words,
                      bool valid) {
#if defined(__CUDACC__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (words == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
#else
  for (int w = 0; w < words; ++w) dst[w] = valid ? src[w] : 0;
#endif
}

RT_FN void async_commit() {
#if defined(__CUDACC__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
RT_FN void async_wait() {
#if defined(__CUDACC__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

// Start the copy of slice p of the stage's (n-tile, k-slice) sequence, the
// table's words [kw0, kw0 + ksw) of columns [n0, n0 + BN): Bs[(j BN + c)
// sb + w] = f[l][j][n0 + c][kw0 + w], zeros outside F. 16-byte copies where
// a column's K/4 words are a multiple of 4 (K >= 16), word copies below.
RT_FN void issue_b_slice(const Stage &st, const Smem &sm, int l, int p,
                         int32_t *ring) {
  const int nks = sm.kwp / sm.ksw;
  const int n0 = (p / nks) * BN, kw0 = (p % nks) * sm.ksw;
  int32_t *Bs = ring + (p % NSLICE) * slice_words(sm);
  const int kw4 = st.K / 4;
  const int cw = kw4 % 4 == 0 ? 4 : 1;  // words a copy moves
  const int per_col = sm.ksw / cw;
  const int32_t *f = st.f + (size_t)l * ND * st.Nc * kw4;
  for (int it = RT_TID; it < ND * BN * per_col; it += RT_NT) {
    const int w = (it % per_col) * cw, c = (it / per_col) % BN;
    const int j = it / (per_col * BN);
    const bool valid = n0 + c < st.Nc && kw0 + w < kw4;
    copy_async(Bs + (size_t)(j * BN + c) * sm.sb + w,
               valid ? f + ((size_t)j * st.Nc + n0 + c) * kw4 + kw0 + w : f,
               cw, valid);
  }
}

#if defined(__CUDACC__)
// d += a b for one lane's fragments (the hardware exchanges the rest)
template <int NL>
RT_FN void mma_lanes(Acc *acc, int g, int nn, uint32_t (*a)[4],
                     uint32_t (*b)[2]) {
  static_assert(NL == 1, "a device lane runs its own fragments");
  int32_t *d = acc[0].g[g][nn];
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(b[0][0]), "r"(b[0][1]));
}
#else
// The host's emulation of one warp's mma: A (16 x 32) and B (32 x 8) are
// rebuilt from the 32 lanes' registers through the fragment maps, D from
// their product through the C map.
template <int NL>
RT_FN void mma_lanes(Acc *acc, int g, int nn, uint32_t (*a)[4],
                     uint32_t (*b)[2]) {
  static_assert(NL == 32, "the host runs a whole warp");
  int32_t A[16][32] = {}, B[32][8] = {};
  for (int lane = 0; lane < 32; ++lane) {
    for (int r = 0; r < 4; ++r)
      for (int y = 0; y < 4; ++y)
        A[frag_a_row(lane, r)][4 * frag_a_kw(lane, r) + y] =
            (int8_t)(uint8_t)(a[lane][r] >> (8 * y));
    for (int r = 0; r < 2; ++r)
      for (int y = 0; y < 4; ++y)
        B[4 * frag_b_kw(lane, r) + y][frag_b_col(lane)] =
            (int8_t)(uint8_t)(b[lane][r] >> (8 * y));
  }
  for (int lane = 0; lane < 32; ++lane)
    for (int r = 0; r < 4; ++r) {
      const int row = frag_c_row(lane, r), col = frag_c_col(lane, r);
      int32_t s = 0;
      for (int kk = 0; kk < 32; ++kk) s += A[row][kk] * B[kk][col];
      acc[lane].g[g][nn][r] += s;
    }
}
#endif

// One warp's products over the staged table slice: lanes lane0 ..
// lane0 + NL - 1 of warp `warp` (NL = 1 on the card, 32 on the host), the
// warp's rows 16 warp .. 16 warp + 15 of the strip, slice words kw0 ..
// kw0 + ksw of A. Per 32-deep k-step: the four A digit fragments, then per
// table digit j its B fragments and the products into weights i + j.
template <int NL>
RT_FN void warp_slice(Acc *acc, const int32_t *As, const int32_t *Bs,
                      const Smem &sm, int warp, int lane0, int kw0) {
  const size_t pa = (size_t)BM * sm.sa, pb = (size_t)BN * sm.sb;
  for (int s = 0; s < sm.ksw; s += 8) {
    uint32_t a[ND][NL][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
      for (int l = 0; l < NL; ++l)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[i][l][r] = (uint32_t)As[i * pa +
                                    (size_t)(16 * warp +
                                             frag_a_row(lane0 + l, r)) *
                                        sm.sa +
                                    kw0 + s + frag_a_kw(lane0 + l, r)];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      uint32_t b[NN][NL][2];
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
        for (int l = 0; l < NL; ++l)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            b[nn][l][r] = (uint32_t)Bs[j * pb +
                                       (size_t)(8 * nn +
                                                frag_b_col(lane0 + l)) *
                                           sm.sb +
                                       s + frag_b_kw(lane0 + l, r)];
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int nn = 0; nn < NN; ++nn)
          mma_lanes<NL>(acc, i + j, nn, a[i], b[nn]);
    }
  }
}

// sum_g s_g 2^(8g) mod q from the seven weight sums: S = sum_g s_g
// (2^(8g+32) mod q) in 64 bits (|S| < 7 2^24 q < 2^27 q), then one
// Montgomery REDC of T = S + 2^27 q (0 < T < 2^28 q < 2^32 q): T 2^-32 mod q
// = sum_g s_g 2^(8g) mod q, below 2q before its one subtraction.
RT_FN uint32_t combine(const int32_t (&s)[NG], const Consts &k) {
  const uint32_t q = k.sa.q;
  int64_t acc = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) acc += (int64_t)s[g] * k.c[g];  // 32 x 32
  const uint64_t t = (uint64_t)acc + ((uint64_t)q << 27);
  const uint32_t lo = (uint32_t)t;
  const uint32_t m = lo * k.qinv;
  const uint32_t u =
      (uint32_t)(t >> 32) + rt_mulhi(m, q) + (lo != 0u ? 1u : 0u);
  return u >= q ? u - q : u;
}

// The n-tile's outputs of lanes lane0 .. lane0 + NL - 1 of warp `warp`:
// per n8 tile, the four factors of T, T^-1 or psi^-o are loaded before any
// is used, then each output is combined, multiplied and, inside the
// matrix, stored.
template <int NL>
RT_FN void epilogue(const Acc *acc, const Stage &st, const Geo &geo,
                    const Consts &k, int z, int m0, int n0, int warp,
                    int lane0) {
  const int logn = geo.logn;
  const int l = z / geo.rows;
  const uint32_t *tab = geo.tab + ((size_t)l << (logn + 1));
  const int mask = (2 << logn) - 1;  // exponents mod 2N
  uint32_t *dst = st.dst + ((size_t)z << logn);
  for (int ln = 0; ln < NL; ++ln) {
    const int lane = lane0 + ln;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      uint32_t f[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * warp + frag_c_row(lane, r);
        const int n = n0 + 8 * nn + frag_c_col(lane, r);
        const int e = (2 * m * n) & mask;  // W^(mn) = psi^(2mn)
        const int o = m * st.o_sm + n * st.o_sn;
        const int x = st.epi == EPI_T      ? e
                      : st.epi == EPI_TINV ? (mask + 1 - e) & mask
                                           : (mask + 1 - o) & mask;
        f[r] = st.epi != EPI_NONE ? tab[x] : 0u;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * warp + frag_c_row(lane, r);
        const int n = n0 + 8 * nn + frag_c_col(lane, r);
        int32_t s[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) s[g] = acc[ln].g[g][nn][r];
        uint32_t v = combine(s, k);
        if (st.epi != EPI_NONE) v = rt::redc(k.sa, v, f[r]);
        if (m < st.M && n < st.Nc) dst[m * st.o_sm + n * st.o_sn] = v;
      }
    }
  }
}

// tab[k] = psi^k R mod q for k < 2N: R times the set bits' psi^(2^j)
RT_FN uint32_t psi_power(const Consts &k, const int32_t *row, int logn,
                         int e) {
  uint32_t acc = k.r1;
  for (int j = 0; j <= logn; ++j)
    if ((e >> j) & 1) acc = rt::redc(k.sa, acc, (uint32_t)row[MM_PW + j]);
  return acc;
}

// the two stages of one direction; fa / fb the stage-1 / stage-2 tables
// (host code: the launch and the host build call it)
inline void make_stages(Stage s[2], const uint32_t *x, uint32_t *out,
                        uint32_t *y, const int32_t *fa, const int32_t *fb,
                        int logn1, int logn2, bool inverse) {
  const int n1 = 1 << logn1, n2 = 1 << logn2;
  if (!inverse) {
    // B = P F2, C = B o T into y[n1 N2 + k2]; D^T = C^T F1 into out
    s[0] = Stage{x, y, fa, n1, n2, n2, n1, n2, 1, 1, EPI_T};
    s[1] = Stage{y, out, fb, n2, n1, n1, n2, 1, n2, 0, EPI_NONE};
  } else {
    // C^T = D^T F1^-1, B = C o T^-1 into y[k2 N1 + n1]; P = B F2^-1,
    // p[n2 N1 + n1] psi^-n into out
    s[0] = Stage{x, y, fa, n2, n1, n1, n2, n1, 1, 0, EPI_TINV};
    s[1] = Stage{y, out, fb, n1, n2, n2, n1, 1, n1, 0, EPI_UNTWIST};
  }
}

// what the entries take: 4 <= K <= 256 (16 <= N <= 2^16)
inline bool shape_ok(int logn1, int logn2) {
  return logn1 >= 2 && logn2 >= 2 && logn1 <= 8 && logn2 <= 8;
}

}  // namespace mm

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(256)
    pow_table_kernel(mm::Geo geo, uint32_t *tab) {
  const int l = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (2 << geo.logn)) return;
  const int32_t *row = geo.consts + (size_t)l * geo.n_consts;
  const mm::Consts k = mm::load_consts(row);
  tab[((size_t)l << (geo.logn + 1)) + e] = mm::psi_power(k, row, geo.logn, e);
}

// one block of a stage, grid (row z, A strip): the strip once, then the
// stage's (n-tile, k-slice) sequence, the table slices NSLICE - 1 ahead in
// a ring of cp.async copies (the first ones in flight while the strip
// loads), an epilogue after each n-tile's last slice
__device__ __forceinline__ void mm_block(const mm::Stage &st,
                                         const mm::Geo &geo,
                                         const mm::Smem &sm,
                                         int32_t *smem) {
  int32_t *As = smem;
  int32_t *ring = smem + (size_t)mm::ND * mm::BM * sm.sa;
  const int z = blockIdx.x, m0 = blockIdx.y * mm::BM;
  const int l = z / geo.rows;
  const mm::Consts k = mm::load_consts(geo.consts + (size_t)l * geo.n_consts);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nks = sm.kwp / sm.ksw;
  const int total = (st.Nc + mm::BN - 1) / mm::BN * nks;
  for (int p = 0; p < mm::NSLICE - 1; ++p) {
    if (p < total) mm::issue_b_slice(st, sm, l, p, ring);
    mm::async_commit();
  }
  mm::load_a_strip(st, geo, k, sm, z, m0, As);
  mm::Acc acc;
  for (int q = 0; q < total; ++q) {
    mm::async_wait<mm::NSLICE - 2>();
    __syncthreads();  // slice q and the strip are in; slice q - 1 is read
    if (q + mm::NSLICE - 1 < total)
      mm::issue_b_slice(st, sm, l, q + mm::NSLICE - 1, ring);
    mm::async_commit();
    const int ks = q % nks;
    if (ks == 0) mm::zero(acc);
    mm::warp_slice<1>(&acc, As, ring + (q % mm::NSLICE) * mm::slice_words(sm),
                      sm, warp, lane, ks * sm.ksw);
    if (ks == nks - 1)
      mm::epilogue<1>(&acc, st, geo, k, z, m0, q / nks * mm::BN, warp, lane);
  }
}

// the two products under their own names, so that a profile shows each
__global__ void __launch_bounds__(mm::THREADS, 2)
    mm_stage1_kernel(mm::Stage st, mm::Geo geo, mm::Smem sm) {
  extern __shared__ int32_t mm1_smem[];
  mm_block(st, geo, sm, mm1_smem);
}

__global__ void __launch_bounds__(mm::THREADS, 2)
    mm_stage2_kernel(mm::Stage st, mm::Geo geo, mm::Smem sm) {
  extern __shared__ int32_t mm2_smem[];
  mm_block(st, geo, sm, mm2_smem);
}

}  // namespace

// tab: (L, 2N) psi^k R mod q, built once per (primes, N, device)
extern "C" int ntt_mm_pow_table(uint32_t *tab, const int32_t *consts,
                                int n_limbs, int logn, int n_consts,
                                void *stream) {
  const mm::Geo geo = {consts, tab, 1, logn, n_consts};
  pow_table_kernel<<<dim3(((2 << logn) + 255) / 256, n_limbs), 256, 0,
                     (cudaStream_t)stream>>>(geo, tab);
  return (int)cudaGetLastError();
}

extern "C" int ntt_mm_launch(const uint32_t *x, uint32_t *out, uint32_t *y,
                             const uint32_t *tab, const int32_t *fa,
                             const int32_t *fb, const int32_t *consts,
                             int n_limbs, int rows, int logn1, int logn2,
                             int n_consts, int inverse, void *stream) {
  if (!mm::shape_ok(logn1, logn2)) return (int)cudaErrorInvalidValue;
  const int logn = logn1 + logn2;
  const mm::Geo geo = {consts, tab, rows, logn, n_consts};
  cudaStream_t s = (cudaStream_t)stream;
  static rt::SmemAllowance allowance[2];
  void (*const kernels[2])(mm::Stage, mm::Geo, mm::Smem) = {
      mm_stage1_kernel, mm_stage2_kernel};
  mm::Stage st[2];
  mm::make_stages(st, x, out, y, fa, fb, logn1, logn2, inverse != 0);
  for (int i = 0; i < 2; ++i) {
    const mm::Smem sm = mm::smem_plan(st[i].K, 0);
    const size_t smem = sizeof(int32_t) * mm::smem_words(sm);
    cudaError_t err = rt::allow_dynamic_smem(kernels[i], smem, allowance[i]);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_limbs * rows, (st[i].M + mm::BM - 1) / mm::BM);
    kernels[i]<<<grid, mm::THREADS, smem, s>>>(st[i], geo, sm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

#else  // host build of the same bodies (one thread per block)

#include <vector>

extern "C" int ntt_mm_pow_table_host(uint32_t *tab, const int32_t *consts,
                                     int n_limbs, int logn, int n_consts) {
  for (int l = 0; l < n_limbs; ++l) {
    const int32_t *row = consts + (size_t)l * n_consts;
    const mm::Consts k = mm::load_consts(row);
    for (int e = 0; e < (2 << logn); ++e)
      tab[((size_t)l << (logn + 1)) + e] = mm::psi_power(k, row, logn, e);
  }
  return 0;
}

// ksw: the table slice's packed words (8, 16 or 32; 0: the CUDA entry's
// plan)
extern "C" int ntt_mm_host(const uint32_t *x, uint32_t *out, uint32_t *y,
                           const uint32_t *tab, const int32_t *fa,
                           const int32_t *fb, const int32_t *consts,
                           int n_limbs, int rows, int logn1, int logn2,
                           int n_consts, int inverse, int ksw) {
  if (!mm::shape_ok(logn1, logn2)) return 1;
  if (ksw != 0 && ksw != 8 && ksw != 16 && ksw != 32) return 1;
  const int logn = logn1 + logn2;
  const mm::Geo geo = {consts, tab, rows, logn, n_consts};
  mm::Stage st[2];
  mm::make_stages(st, x, out, y, fa, fb, logn1, logn2, inverse != 0);
  std::vector<mm::Acc> acc(mm::THREADS);
  for (int i = 0; i < 2; ++i) {
    const mm::Smem sm = mm::smem_plan(st[i].K, ksw);
    if (sm.kwp % sm.ksw != 0) return 1;
    std::vector<int32_t> smem(mm::smem_words(sm));
    int32_t *As = smem.data();
    int32_t *ring = As + (size_t)mm::ND * mm::BM * sm.sa;
    const int nks = sm.kwp / sm.ksw;
    const int total = (st[i].Nc + mm::BN - 1) / mm::BN * nks;
    for (int z = 0; z < n_limbs * rows; ++z) {
      const int l = z / rows;
      const mm::Consts k = mm::load_consts(consts + (size_t)l * n_consts);
      for (int m0 = 0; m0 < st[i].M; m0 += mm::BM) {
        // the device block's sequence, the copies done at once
        for (int p = 0; p < mm::NSLICE - 1 && p < total; ++p)
          mm::issue_b_slice(st[i], sm, l, p, ring);
        mm::load_a_strip(st[i], geo, k, sm, z, m0, As);
        for (int q = 0; q < total; ++q) {
          if (q + mm::NSLICE - 1 < total)
            mm::issue_b_slice(st[i], sm, l, q + mm::NSLICE - 1, ring);
          const int ks = q % nks;
          if (ks == 0)
            for (auto &a : acc) mm::zero(a);
          for (int w = 0; w < mm::WARPS; ++w)
            mm::warp_slice<32>(&acc[32 * w], As,
                               ring + (q % mm::NSLICE) * mm::slice_words(sm),
                               sm, w, 0, ks * sm.ksw);
          if (ks == nks - 1)
            for (int w = 0; w < mm::WARPS; ++w)
              mm::epilogue<32>(&acc[32 * w], st[i], geo, k, z, m0,
                               q / nks * mm::BN, w, 0);
        }
      }
    }
  }
  return 0;
}

// The fragment maps, for the tests to hold against the PTX ISA's tables:
// per lane, A's (row, word) of registers 0..3, B's (column, word) of
// registers 0..1, C's (row, column) of registers 0..3: 20 ints a lane.
extern "C" int ntt_mm_frag_maps_host(int32_t *out) {
  for (int lane = 0; lane < 32; ++lane) {
    int32_t *o = out + 20 * lane;
    for (int r = 0; r < 4; ++r) {
      o[2 * r] = mm::frag_a_row(lane, r);
      o[2 * r + 1] = mm::frag_a_kw(lane, r);
      o[12 + 2 * r] = mm::frag_c_row(lane, r);
      o[13 + 2 * r] = mm::frag_c_col(lane, r);
    }
    for (int r = 0; r < 2; ++r) {
      o[8 + 2 * r] = mm::frag_b_col(lane);
      o[9 + 2 * r] = mm::frag_b_kw(lane, r);
    }
  }
  return 0;
}

#endif
