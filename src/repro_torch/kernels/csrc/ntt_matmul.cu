// Four-step negacyclic NTT / INTT as modular matrix products of int8
// digits, for Hopper (sm_90a): K14.
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
// permutation, and to the JAX reference.
//
// The psi^k table is a constant of the primes: ntt_mm_pow_table builds it
// once (pow_table_kernel: tab[l][k] = psi_l^k R mod q for k < 2N, each by
// square-and-multiply from the limb's log2(2N) constants mont(psi^(2^j)),
// shift-add REDC), and the wrapper keeps it beside the digit tables.
// psi^-n = tab[2N - n] and W^(+-e) = tab[+-2e mod 2N], so one table serves
// both directions. Then one C call transforms an (L, rows, N) stack (limbs
// folded into the grid; the reference launches once per limb) with two
// launches:
//   1. mm_kernel, stage 1, and 2. mm_kernel, stage 2: one block per
//      (row, 64 x 64 output tile). For each 32-wide K-slice the block loads
//      its A tile from the row (twisting it in stage 1 of the forward),
//      splits each word into four balanced base-256 digits and packs four
//      consecutive k of a digit into one int32 in shared memory; the
//      table's digits arrive packed the same way (ntt_matmul.packed). Each
//      thread accumulates a 2 x 4 output micro-tile with __dp4a (four int8
//      products and their sum per instruction) into seven int32 sums, one
//      per digit weight g = i + j (|sum| < 4 * 256 * 128 * 128 = 2^24: exact).
//      The epilogue recombines them as the reference does, sum_g Barrett(
//      s_g + q, 2^(8g) mod q) mod q, multiplies by T, T^-1 or psi^-n where
//      the stage needs it, and writes the tile. The intermediate between
//      the two products goes through an (L, rows, N) global scratch.
//
// What bounds it on an H100: 2 x 16 x N1 N2 (N1 or N2) int8 products per
// row, which the tensor cores would do in ~0.2 ms at paper B=16, and ~0.6
// ms of int32 work (digits, seven Barretts per output per product, twist,
// T) on the integer units: operations. This first version computes the
// digit products with __dp4a on the integer units (16.7e12 instructions/s:
// >= 3.1 ms at paper B=16); int8 mma / wgmma with the digit planes brought
// in by TMA is the next step (ROADMAP queue 4).
//
// The same source compiles as plain C++ (one thread per block):
// ntt_mm_pow_table_host fills the table and ntt_mm_host runs each block's
// slices and its virtual threads' micro-tiles in turn,
// so the CPU tests check this arithmetic against the plain version.
#include "client_common.cuh"

namespace mm {

// (L, n_consts) int32 rows of per-limb constants (ntt_matmul.py: MM_*):
//   [0, 8) the prime's shift-add REDC row (common.sa_table)
//   [8] mu = 2^(2p) // q  [9] p = bitlen(q)  [10] R mod q
//   [11, 18) 2^(8g) mod q, g = 0..6  [18, 18 + logn + 1) mont(psi^(2^j))
constexpr int MM_MU = 8;
constexpr int MM_P = 9;
constexpr int MM_R = 10;
constexpr int MM_C = 11;
constexpr int MM_PW = 18;

constexpr int NG = 7;                    // digit weights g = i + j
constexpr int TM = 64, TN = 64, TK = 32;  // block tile, K-slice
constexpr int TKW = TK / 4;              // packed words per slice
constexpr int UM = 2, UN = 4;            // thread micro-tile
constexpr int THREADS = (TM / UM) * (TN / UN);  // 512

enum { EPI_NONE = 0, EPI_T = 1, EPI_TINV = 2, EPI_UNTWIST = 3 };

struct Consts {
  rt::SaRedc sa;
  uint32_t mu, r1;
  int p;
  uint32_t c[NG];
};

RT_FN Consts load_consts(const int32_t *row) {
  Consts k;
  k.sa = rt::sa_redc(row);
  k.mu = (uint32_t)row[MM_MU];
  k.p = row[MM_P];
  k.r1 = (uint32_t)row[MM_R];
  for (int g = 0; g < NG; ++g) k.c[g] = (uint32_t)row[MM_C + g];
  return k;
}

// Barrett a*b mod q on words (modmul.mulmod_barrett_limb): t1 = T >>
// (p-1), m = (t1 mu) >> (p+1), r = T - m q (0, 1 or 2 q too large)
RT_FN uint32_t barrett(uint32_t a, uint32_t b, const Consts &k) {
  const uint32_t q = k.sa.q;
  const uint64_t t = (uint64_t)a * b;
  const uint32_t t1 = (uint32_t)(t >> (k.p - 1));
  const uint32_t m = (uint32_t)(((uint64_t)t1 * k.mu) >> (k.p + 1));
  const uint64_t d = t - (uint64_t)m * q;
  uint32_t r = (uint32_t)d;
  if ((uint32_t)(d >> 32) > 0u) r -= q;
  if (r >= q) r -= q;
  if (r >= q) r -= q;
  return r;
}

RT_FN int32_t dp4a(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDACC__)
  return __dp4a(a, b, c);
#else
  for (int t = 0; t < 4; ++t)
    c += (int32_t)(int8_t)(uint8_t)((uint32_t)a >> (8 * t)) *
         (int32_t)(int8_t)(uint8_t)((uint32_t)b >> (8 * t));
  return c;
#endif
}

// one modular matmul of the four-step transform: out = A F mod q over an
// (M, K) x (K, Nc) product, A[m, k] = src_row[k * a_sk + m] (times psi^idx
// when twist), out_row[m * o_sm + n * o_sn] (times T, T^-1 or psi^-idx per
// epi)
struct Stage {
  const uint32_t *src;
  uint32_t *dst;
  const int32_t *f;  // (L, 4, K/4, Nc): digit j, packed k, column
  int M, K, Nc;
  int a_sk, o_sm, o_sn;
  int twist, epi;
};

struct Geo {
  const int32_t *consts;  // (L, n_consts)
  const uint32_t *tab;    // (L, 2N) psi^k R mod q
  int rows, logn, n_consts;
};

struct Acc {
  int32_t g[UM][UN][NG];
};

// every loop over the accumulators is unrolled, so that they stay in
// registers (an index the compiler cannot resolve puts them on the stack)
RT_FN void zero(Acc &a) {
#pragma unroll
  for (int r = 0; r < UM; ++r)
#pragma unroll
    for (int c = 0; c < UN; ++c)
#pragma unroll
      for (int g = 0; g < NG; ++g) a.g[r][c][g] = 0;
}

// stage A tile [m0, m0+TM) x [k0, k0+TK) as packed digits As[i][kw][m], the
// table slice as Bs[j][kw][n]; zeros outside the matrices
RT_FN void load_slice(const Stage &st, const Geo &geo, const Consts &k,
                      int z, int m0, int n0, int k0, int32_t *As,
                      int32_t *Bs) {
  const int n = 1 << geo.logn;
  const int l = z / geo.rows;
  const uint32_t *src = st.src + (size_t)z * n;
  const uint32_t *tab = geo.tab + ((size_t)l << (geo.logn + 1));
  const int kwn = (st.K - k0 < TK ? st.K - k0 : TK) / 4;
  for (int it = RT_TID; it < TKW * TM; it += RT_NT) {
    const int m = it % TM, kw = it / TM;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (kw < kwn && m0 + m < st.M) {
      for (int t = 0; t < 4; ++t) {
        const int idx = (k0 + 4 * kw + t) * st.a_sk + m0 + m;
        uint32_t v = src[idx];
        if (st.twist) v = rt::redc(k.sa, v, tab[idx]);
        for (int i = 0; i < 4; ++i) {  // balanced base-256 digit i
          const uint32_t d = v & 255u;
          const uint32_t over = d >= 128u ? 1u : 0u;
          w[i] |= d << (8 * t);         // the digit's byte: d or d - 256
          v = (v >> 8) + over;
        }
      }
    }
    for (int i = 0; i < 4; ++i) As[(i * TKW + kw) * TM + m] = (int32_t)w[i];
  }
  const int32_t *f = st.f + (size_t)l * 4 * (st.K / 4) * st.Nc;
  for (int it = RT_TID; it < 4 * TKW * TN; it += RT_NT) {
    const int nn = it % TN, kw = (it / TN) % TKW, j = it / (TN * TKW);
    Bs[it] = (kw < kwn && n0 + nn < st.Nc)
                 ? f[((size_t)j * (st.K / 4) + k0 / 4 + kw) * st.Nc + n0 + nn]
                 : 0;
  }
}

// thread t's micro-tile: rows tm*UM + r, columns tn*UN + c of the tile
RT_FN void mma_slice(Acc &acc, const int32_t *As, const int32_t *Bs, int t,
                     int kwn) {
  const int tm = t / (TN / UN), tn = t % (TN / UN);
  for (int kw = 0; kw < kwn; ++kw) {
    int32_t a[UM][4], b[UN][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < UM; ++r)
        a[r][i] = As[(i * TKW + kw) * TM + tm * UM + r];
#pragma unroll
      for (int c = 0; c < UN; ++c)
        b[c][i] = Bs[(i * TKW + kw) * TN + tn * UN + c];
    }
#pragma unroll
    for (int r = 0; r < UM; ++r)
#pragma unroll
      for (int c = 0; c < UN; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc.g[r][c][i + j] = dp4a(a[r][i], b[c][j], acc.g[r][c][i + j]);
  }
}

RT_FN void epilogue(const Acc &acc, const Stage &st, const Geo &geo,
                    const Consts &k, int z, int m0, int n0, int t) {
  const int logn = geo.logn;
  const int l = z / geo.rows;
  const uint32_t q = k.sa.q;
  const uint32_t *tab = geo.tab + ((size_t)l << (logn + 1));
  const int mask = (2 << logn) - 1;  // exponents mod 2N
  uint32_t *dst = st.dst + ((size_t)z << logn);
  const int tm = t / (TN / UN), tn = t % (TN / UN);
#pragma unroll
  for (int r = 0; r < UM; ++r) {
#pragma unroll
    for (int c = 0; c < UN; ++c) {
      const int m = m0 + tm * UM + r, n = n0 + tn * UN + c;
      if (m >= st.M || n >= st.Nc) continue;
      uint32_t v = 0;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        // s_g + q in [q - 2^24, q + 2^24): a word below 2^31
        const uint32_t rg =
            barrett((uint32_t)acc.g[r][c][g] + q, k.c[g], k);
        v = g == 0 ? rg : rt::addmod(v, rg, q);
      }
      const int e = (2 * m * n) & mask;  // W^(mn) = psi^(2mn)
      if (st.epi == EPI_T) v = rt::redc(k.sa, v, tab[e]);
      if (st.epi == EPI_TINV) v = rt::redc(k.sa, v, tab[(mask + 1 - e) & mask]);
      const int o = m * st.o_sm + n * st.o_sn;
      if (st.epi == EPI_UNTWIST)
        v = rt::redc(k.sa, v, tab[(mask + 1 - o) & mask]);
      dst[o] = v;
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

__global__ void __launch_bounds__(mm::THREADS)
    mm_kernel(mm::Stage st, mm::Geo geo) {
  __shared__ int32_t As[4 * mm::TKW * mm::TM];
  __shared__ int32_t Bs[4 * mm::TKW * mm::TN];
  const int z = blockIdx.x;
  const int m0 = blockIdx.y * mm::TM, n0 = blockIdx.z * mm::TN;
  const mm::Consts k =
      mm::load_consts(geo.consts + (size_t)(z / geo.rows) * geo.n_consts);
  mm::Acc acc;
  mm::zero(acc);
  for (int k0 = 0; k0 < st.K; k0 += mm::TK) {
    mm::load_slice(st, geo, k, z, m0, n0, k0, As, Bs);
    __syncthreads();
    const int kwn = (st.K - k0 < mm::TK ? st.K - k0 : mm::TK) / 4;
    mm::mma_slice(acc, As, Bs, threadIdx.x, kwn);
    __syncthreads();
  }
  mm::epilogue(acc, st, geo, k, z, m0, n0, threadIdx.x);
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
  const int logn = logn1 + logn2;
  const mm::Geo geo = {consts, tab, rows, logn, n_consts};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  mm::Stage st[2];
  mm::make_stages(st, x, out, y, fa, fb, logn1, logn2, inverse != 0);
  for (int i = 0; i < 2; ++i) {
    const dim3 grid(n_limbs * rows, (st[i].M + mm::TM - 1) / mm::TM,
                    (st[i].Nc + mm::TN - 1) / mm::TN);
    mm_kernel<<<grid, mm::THREADS, 0, s>>>(st[i], geo);
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

extern "C" int ntt_mm_host(const uint32_t *x, uint32_t *out, uint32_t *y,
                           const uint32_t *tab, const int32_t *fa,
                           const int32_t *fb, const int32_t *consts,
                           int n_limbs, int rows, int logn1, int logn2,
                           int n_consts, int inverse) {
  const int logn = logn1 + logn2;
  const mm::Geo geo = {consts, tab, rows, logn, n_consts};
  mm::Stage st[2];
  mm::make_stages(st, x, out, y, fa, fb, logn1, logn2, inverse != 0);
  std::vector<int32_t> As(4 * mm::TKW * mm::TM), Bs(4 * mm::TKW * mm::TN);
  std::vector<mm::Acc> acc(mm::THREADS);
  for (int i = 0; i < 2; ++i) {
    for (int z = 0; z < n_limbs * rows; ++z) {
      const mm::Consts k = mm::load_consts(consts + (size_t)(z / rows) *
                                                        n_consts);
      for (int m0 = 0; m0 < st[i].M; m0 += mm::TM) {
        for (int n0 = 0; n0 < st[i].Nc; n0 += mm::TN) {
          for (auto &a : acc) mm::zero(a);
          for (int k0 = 0; k0 < st[i].K; k0 += mm::TK) {
            mm::load_slice(st[i], geo, k, z, m0, n0, k0, As.data(),
                           Bs.data());
            const int kwn =
                (st[i].K - k0 < mm::TK ? st[i].K - k0 : mm::TK) / 4;
            for (int t = 0; t < mm::THREADS; ++t)
              mm::mma_slice(acc[t], As.data(), Bs.data(), t, kwn);
          }
          for (int t = 0; t < mm::THREADS; ++t)
            mm::epilogue(acc[t], st[i], geo, k, z, m0, n0, t);
        }
      }
    }
  }
  return 0;
}

#endif
