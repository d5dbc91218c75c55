// Server-side CKKS op set for Hopper (sm_90a): K7, K8, K8b, K9, K10, K11a,
// K11b.
//
// Replaces the TPU kernels of src/repro/kernels/server_eval.py:
//   K7   _add_ct_kernel, _add_pt_kernel, _mul_pt_kernel  (server_pointwise)
//   K8   _rescale_kernel                                  (server_rescale)
//   K8b  _mul_pt_rescale_kernel                           (server_rescale)
//   K9   _mul_ct_relin_kernel                             (server_mul_ct)
//   K10  _rotate_kernel                                   (server_rotate)
//   K11a _ks_decompose_kernel                             (server_ks_decompose)
//   K11b _ks_apply_rot_kernel                             (server_ks_apply_rot)
// Output words are bit-identical to the plain versions in
// kernels/server_eval.py and to the JAX reference, on both of its
// datapaths: the stages that multiply run the reference's u64 REDC
// (rt::redc_u64, the 'f64' datapath's modmul.mulmod_montgomery_u64_t),
// which gives the words of the 'df32' datapath's uint32 REDC as well, so
// one kernel serves ServerEvaluator(datapath='df32') and ('f64').
//
// The Pallas bodies take a whole ciphertext row per grid step with the limb
// loop unrolled; at N = 2^16 one limb row is 256 KB, more than an SM's
// shared memory. So each op is a fixed sequence of launches on the caller's
// stream, with the intermediates in device memory (scratch the wrapper
// allocates). Every op that transforms starts with
//   heaps       grid-stride: the twiddle heaps of the table rows and
//               directions the op uses (rt::server::Heaps), once per call;
// then runs these stages:
//   lift        INTT rows: gather by perm and REDC by pm in the load,
//               N^-1 and the centring to int32 digits in the store (the
//               rescale's top limb, the key-switch digits, the mod-down's
//               special row)
//   extend      NTT rows (B, l+1, l): the digit's residue on row i in the
//               load: the digit-NTT stack h
//   mac         elementwise, grid (l+1, chunks, B): acc_i = sum_j
//               REDC(h_ij, ksk_j[i])
//   scale_down  NTT rows (B, 2, l_out): the centred row's residue in the
//               load; submod, REDC by q_drop^-1 or P^-1 and the addition
//               of the other half in the store
//   pointwise / tensor   elementwise, grid (l, chunks, B)
// Each transform stage is a stage type of ntt_tiled.cuh's transform block
// (stage_tile and its pass launchers, which K1 runs too), over
// one-dimensional grids of (row, tile): rows of logn <= kSinglePassLogn in
// one pass, a block per row (*_row_kernel); larger rows in two passes over
// 2^a x 2^b views of every row (*_cols_kernel / *_chunks_kernel: the column
// pass first for an NTT, the chunk pass first for an INTT), the transform
// between them in the row buffer the last pass reads (the digits, h, the
// output rows), tiles sized by plan_geo from the stage's rows.
//
// What bounds them on an H100: a key switch at level l runs l^2 + 4l + 2
// NTTs of N points (19 int32 operations per butterfly) and 2 l (l+1) N REDCs
// against 2 l (l+1) N key words read once: operations, not bytes, but for
// the multiply-accumulate of K11b, which reads the key and h once for a few
// operations a word. K7 is elementwise: bytes. The design keeps the
// butterflies near the int32 rate: a row crosses device memory twice per
// transform (each pass loads a tile once into shared memory, runs its
// stages two per barrier with four points a thread in registers, and stores
// it once), the elementwise work rides in those loads and stores, and the
// twiddles come from heaps made once per call. What it leaves: the digit-NTT
// stack h lands in device memory (157 MB per ciphertext at l = 24), and an
// op is up to 15 launches, whose latency is the time of the small grids at
// l = 6. Times against the bound: PERF.md §6.
#include "server_common.cuh"

namespace {

#if defined(__CUDACC__)
#define SE_HD __host__ __device__
#else
#define SE_HD inline
#endif

using rt::tiled::Geo;
using rt::tiled::Tiling;

constexpr int kThreads = 256;  // threads of an elementwise or heap block
// columns per elementwise block: K7's; the tensor product's and the
// multiply-accumulate's (a quarter, so that their grids fill the card at
// l = 6, B = 1)
constexpr int kChunk = 2048;
constexpr int kNarrowChunk = 512;

// The op's constants: the (l+1, ncols) server table of level l.
struct Consts {
  const uint32_t *table;
  int ncols, level, logn;
  RT_MEMBER const uint32_t *row(int i) const {
    return table + (size_t)i * ncols;
  }
  SE_HD size_t n() const { return (size_t)1 << logn; }
  // columns [chunk * width, cols_end(chunk, width)) of an elementwise block
  RT_MEMBER int cols_end(int chunk, int width) const {
    const size_t end = (size_t)(chunk + 1) * width;
    return (int)(end < n() ? end : n());
  }
};

// ---------------------------------------------------------------------------
// elementwise stages: block (x, y, z) of grid (rows, chunks, B)
// ---------------------------------------------------------------------------

// K7: mode 0 ct + ct, 1 ct + pt, 2 ct x pt (REDC by a Montgomery-form pt)
struct PointwiseStage {
  Consts g;
  int mode;
  const uint32_t *a0, *a1, *b0, *b1;  // b0: the pt (l, N) in modes 1, 2
  uint32_t *o0, *o1;
  RT_MEMBER void block(int j, int chunk, int b) const {
    const size_t n = g.n();
    const size_t row = ((size_t)b * g.level + j) * n;
    const uint32_t q = g.row(j)[rt::OFF_Q], qinv = g.row(j)[rt::OFF_QINV];
    const int c0 = chunk * kChunk, c1 = g.cols_end(chunk, kChunk);
    const uint32_t *pt = b0 + (size_t)j * n;
    for (int k = c0 + (int)RT_TID; k < c1; k += RT_NT) {
      const size_t e = row + k;
      if (mode == 0) {
        o0[e] = rt::addmod(a0[e], b0[e], q);
        o1[e] = rt::addmod(a1[e], b1[e], q);
      } else if (mode == 1) {
        o0[e] = rt::addmod(a0[e], pt[k], q);
        o1[e] = a1[e];
      } else {
        o0[e] = rt::redc_u64(a0[e], pt[k], q, qinv);
        o1[e] = rt::redc_u64(a1[e], pt[k], q, qinv);
      }
    }
  }
};

// K9's tensor product: b enters the Montgomery domain once (REDC by R^2),
// then d0 = a0 b0, d1 = a0 b1 + a1 b0, d2 = a1 b1
struct TensorStage {
  Consts g;
  int off_r2;
  const uint32_t *a0, *a1, *b0, *b1;
  uint32_t *d0, *d1, *d2;
  RT_MEMBER void block(int j, int chunk, int b) const {
    const size_t n = g.n();
    const size_t row = ((size_t)b * g.level + j) * n;
    const uint32_t *tr = g.row(j);
    const uint32_t q = tr[rt::OFF_Q], qinv = tr[rt::OFF_QINV];
    const uint32_t r2 = tr[off_r2];
    const int c0 = chunk * kNarrowChunk;
    const int c1 = g.cols_end(chunk, kNarrowChunk);
    for (int k = c0 + (int)RT_TID; k < c1; k += RT_NT) {
      const size_t e = row + k;
      const uint32_t b0m = rt::redc_u64(b0[e], r2, q, qinv);
      const uint32_t b1m = rt::redc_u64(b1[e], r2, q, qinv);
      d0[e] = rt::redc_u64(a0[e], b0m, q, qinv);
      d1[e] = rt::addmod(rt::redc_u64(a0[e], b1m, q, qinv),
                         rt::redc_u64(a1[e], b0m, q, qinv), q);
      d2[e] = rt::redc_u64(a1[e], b1m, q, qinv);
    }
  }
};

// acc[b][p][i] = sum_j REDC(h[b][i][j] (permuted), ksk_p[j][i])
struct MacStage {
  Consts g;
  const uint32_t *h;           // (B, l+1, l, N)
  const int32_t *perm;         // (N) or null
  const uint32_t *kb, *ka;     // (l, l+1, N)
  uint32_t *acc;               // (B, 2, l+1, N)
  RT_MEMBER void block(int i, int chunk, int b) const {
    const size_t n = g.n();
    const int l = g.level;
    const int c0 = chunk * kNarrowChunk;
    const int c1 = g.cols_end(chunk, kNarrowChunk);
    const uint32_t *tr = g.row(i);
    rt::mac_cols(h + ((size_t)b * (l + 1) + i) * l * n, perm,
                 kb + (size_t)i * n, ka + (size_t)i * n, (size_t)(l + 1) * n,
                 acc + ((size_t)b * 2 * (l + 1) + i) * n,
                 acc + (((size_t)b * 2 + 1) * (l + 1) + i) * n, l, g.logn,
                 c0, c1, tr[rt::OFF_Q], tr[rt::OFF_QINV]);
  }
};

// ---------------------------------------------------------------------------
// transform stages (rt::tiled::stage_tile): bind(row) -> the row's Row
// ---------------------------------------------------------------------------

// lift rows (INTT), row y * dst_rows + x, y the batch row: source row sx of
// poly src (or, with src1 given, of poly x of the pair (src, src1)),
// gathered by perm and REDC'd by the pm row sx when given, INTT with table
// row sx, centred into dst + (y * dst_rows + x) * N (also the row buffer
// between the passes). sx = x0 + x: the limb x of the key-switch digits
// (x0 = 0); sx = x0 for a pair: the top row of a rescale (x0 = l-1) or of a
// mod-down (x0 = l). src must not alias dst.
struct LiftStage {
  static constexpr bool kInverse = true;
  using Red = rt::MontRedc;
  RT_MEMBER Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
  Consts g;
  const uint32_t *src, *src1;
  int src_rows, x0;    // rows per batch entry of a source poly, first row
  const int32_t *perm;
  const uint32_t *pm;  // (l, N) or null
  int32_t *dst;
  int dst_rows;
  struct Row {
    int prime;
    uint32_t *mid;
    const uint32_t *src, *pm;
    const int32_t *perm;
    uint32_t q, qinv;
    RT_MEMBER uint32_t load(int p) const {
      const uint32_t v = src[perm ? perm[p] : p];
      return pm ? rt::redc_u64(v, pm[p], q, qinv) : v;
    }
    RT_MEMBER void store(int p, uint32_t v) const {
      reinterpret_cast<int32_t *>(mid)[p] = rt::ks_center(v, q);
    }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t n = g.n();
    const int y = (int)(row / dst_rows), x = (int)(row % dst_rows);
    const uint32_t *s = (src1 && x == 1) ? src1 : src;
    const int sx = src1 ? x0 : x0 + x;
    const uint32_t *tr = g.row(sx);
    return Row{sx,
               reinterpret_cast<uint32_t *>(dst + (size_t)row * n),
               s + ((size_t)y * src_rows + sx) * n,
               pm ? pm + (size_t)sx * n : nullptr,
               perm,
               tr[rt::OFF_Q],
               tr[rt::OFF_QINV]};
  }
};

// the digit-NTT stack (NTT), row (b (l+1) + i) l + j: h[b][i][j] =
// NTT_i(residue(D[b][j])), the residue taken in the load
struct ExtendStage {
  static constexpr bool kInverse = false;
  using Red = rt::MontRedc;
  RT_MEMBER Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
  Consts g;
  const int32_t *digits;  // (B, l, N)
  uint32_t *h;            // (B, l+1, l, N)
  struct Row {
    int prime;
    uint32_t *mid;
    const int32_t *w;
    uint32_t q;
    RT_MEMBER uint32_t load(int p) const { return rt::to_residue(w[p], q); }
    RT_MEMBER void store(int p, uint32_t v) const { mid[p] = v; }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t n = g.n();
    const int l = g.level;
    const int j = (int)(row % l);
    const long long bi = row / l;
    const int i = (int)(bi % (l + 1));
    const long long b = bi / (l + 1);
    return Row{i, h + (size_t)row * n, digits + ((size_t)b * l + j) * n,
               g.row(i)[rt::OFF_Q]};
  }
};

// scale-down rows (NTT), row (b 2 + p) l_out + i: y = NTT_i(residue(w))
// with w = w + (b * 2 + p) * N; then out_p + (b * l_out + i) * N (also the
// row buffer between the passes) = REDC(x' - y, c) with x' = x_p + (b *
// x_rows + i) * N, REDC'd by the pm row i when given, c the constant column
// off_c of table row i; then addmod(add_p[add_perm'], .) when add_p is
// given (add_p + (b * l_out + i) * N, gathered by add_perm: the
// key-switched ct's other half, sigma_g(c0) for a rotation, d0 / d1 for a
// relinearization). The order of scale_down in _rescale2 / _ks_moddown.
struct ScaleDownStage {
  static constexpr bool kInverse = false;
  using Red = rt::MontRedc;
  RT_MEMBER Red make_red(const uint32_t *trow) const {
    return rt::mont_redc(trow);
  }
  Consts g;
  const uint32_t *x0, *x1;
  int x_rows;
  const uint32_t *pm;
  const int32_t *w;        // (B, 2, N)
  const uint32_t *add0, *add1;
  const int32_t *add_perm;
  uint32_t *out0, *out1;
  int l_out, off_c;
  struct Row {
    int prime;
    uint32_t *mid;
    const int32_t *w;
    const uint32_t *x, *pm, *add;
    const int32_t *add_perm;
    uint32_t q, qinv, c;
    RT_MEMBER uint32_t load(int p) const { return rt::to_residue(w[p], q); }
    RT_MEMBER void store(int p, uint32_t y) const {
      uint32_t xv = x[p];
      if (pm) xv = rt::redc_u64(xv, pm[p], q, qinv);
      uint32_t r = rt::redc_u64(rt::submod(xv, y, q), c, q, qinv);
      if (add) r = rt::addmod(add[add_perm ? add_perm[p] : p], r, q);
      mid[p] = r;
    }
  };
  RT_MEMBER Row bind(long long row) const {
    const size_t n = g.n();
    const int i = (int)(row % l_out);
    const long long bp = row / l_out;
    const int p = (int)(bp % 2);
    const long long b = bp / 2;
    const uint32_t *add = p == 0 ? add0 : add1;
    const uint32_t *tr = g.row(i);
    return Row{i,
               (p == 0 ? out0 : out1) + ((size_t)b * l_out + i) * n,
               w + (size_t)bp * n,
               (p == 0 ? x0 : x1) + ((size_t)b * x_rows + i) * n,
               pm ? pm + (size_t)i * n : nullptr,
               add ? add + ((size_t)b * l_out + i) * n : nullptr,
               add_perm,
               tr[rt::OFF_Q],
               tr[rt::OFF_QINV],
               tr[off_c]};
  }
};

// The tile geometry of a transform stage of `rows` rows (ga, lc, lr < 0:
// the CUDA entries' plan: column tiles of 2^2 .. 2^5 columns, chunk tiles
// of 2^1 .. 2^3 chunks, shrunk towards those bounds until a pass has 264
// blocks where the rows allow (K1's plan, but that a stage of a few rows,
// the lift of a rescale's or a mod-down's top row, may take 16-byte runs);
// brev: the chunk tiles' order, 0 on the card).
Geo stage_geo(int logn, long long rows, int ga, int lc, int lr, int brev) {
  return rt::tiled::plan_geo(logn, ga, lc, lr, rt::tiled::kSinglePassLogn,
                             rows, rows, 2, 5, 1, 3, brev);
}

// ---------------------------------------------------------------------------
// the executor: CUDA launches on the caller's stream, or (host build) every
// block of each launch in order
// ---------------------------------------------------------------------------

// What the op's transform stages share: its table and its (2, l+1, N) heaps.
struct OpTables {
  const uint32_t *table;
  int ncols, heap_rows;
  const uint32_t *tw;
  // the tiling of stage S over `rows` rows of 2^logn points (the geometry
  // stage_geo's), with the heaps of S's direction
  template <class S>
  Tiling tiling(const S &, int logn, long long rows, int ga, int lc, int lr,
                int brev) const {
    return Tiling{stage_geo(logn, rows, ga, lc, lr, brev), table, ncols,
                  tw + (S::kInverse ? (size_t)heap_rows << logn : 0)};
  }
  rt::server::Heaps heaps(int logn, int f0, int f1, int i0, int i1) const {
    return {table, ncols, logn, heap_rows, const_cast<uint32_t *>(tw),
            f0, f1, i0, i1};
  }
};

#if defined(__CUDACC__)

__global__ void __launch_bounds__(kThreads)
    server_heaps_kernel(rt::server::Heaps h, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step)
    rt::server::heap_word(h, t);
}

// one kernel per elementwise stage, so that a profile shows each under its
// own name; K7 keeps a launch bound of 1024 (it launches 256 threads a
// block), the build its times in PERF.md were taken with
#define SE_EW_KERNEL(name, S, bound)                            \
  __global__ void __launch_bounds__(bound) name(S s) {          \
    s.block(blockIdx.x, blockIdx.y, blockIdx.z);                \
  }                                                             \
  inline void (*kernel_for(const S &))(S) { return name; }
SE_EW_KERNEL(pointwise_kernel, PointwiseStage, 1024)
SE_EW_KERNEL(tensor_kernel, TensorStage, kThreads)
SE_EW_KERNEL(mac_kernel, MacStage, kThreads)
#undef SE_EW_KERNEL

RT_STAGE_KERNELS(lift, LiftStage)
RT_STAGE_KERNELS(extend, ExtendStage)
RT_STAGE_KERNELS(scale_down, ScaleDownStage)

struct Exec {
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;
  OpTables op = {};

  explicit Exec(void *s) : stream((cudaStream_t)s) {}

  // an elementwise stage over grid (x, y, z)
  template <class S>
  void ew(const S &s, int x, int y, int z) {
    if (err != cudaSuccess) return;
    void (*kernel)(S) = kernel_for(s);
    kernel<<<dim3(x, y, z), kThreads, 0, stream>>>(s);
    err = cudaGetLastError();
  }

  // the op's heaps: forward rows [f0, f1), inverse rows [i0, i1) (a
  // grid-stride pass of at most 16 blocks per SM)
  void heaps(int logn, int f0, int f1, int i0, int i1) {
    if (err != cudaSuccess) return;
    const rt::server::Heaps h = op.heaps(logn, f0, f1, i0, i1);
    const long long total = rt::server::heap_words(h);
    const long long blocks = (total + kThreads - 1) / kThreads;
    server_heaps_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16),
                          kThreads, 0, stream>>>(h, total);
    err = cudaGetLastError();
  }

  // a transform stage of `rows` rows: one pass, or two
  template <class S>
  void ntt(const S &s, long long rows, int logn) {
    if (err != cudaSuccess) return;
    err = rt::tiled::launch_stage(stage_kernels(s), s,
                                  op.tiling(s, logn, rows, -1, -1, -1, 0),
                                  rows, stream);
  }
};

#else

struct Exec {
  int err = 0;
  OpTables op = {};
  int ga, lc, lr, brev;  // a forced tile geometry (< 0: the plan's)

  Exec(int ga_, int lc_, int lr_, int brev_)
      : ga(ga_), lc(lc_), lr(lr_), brev(brev_) {}

  template <class S>
  void ew(const S &s, int x, int y, int z) {
    for (int k = 0; k < z; ++k)
      for (int j = 0; j < y; ++j)
        for (int i = 0; i < x; ++i) s.block(i, j, k);
  }

  void heaps(int logn, int f0, int f1, int i0, int i1) {
    const rt::server::Heaps h = op.heaps(logn, f0, f1, i0, i1);
    for (long long i = 0; i < rt::server::heap_words(h); ++i)
      rt::server::heap_word(h, i);
  }

  template <class S>
  void ntt(const S &s, long long rows, int logn) {
    if (err == 0 &&
        !rt::tiled::run_stage_host(
            s, op.tiling(s, logn, rows, ga, lc, lr, brev), rows))
      err = 1;
  }
};

#endif

int chunks(const Consts &g, int width) {
  return (int)((g.n() + width - 1) / width);
}

// ---------------------------------------------------------------------------
// the ops, each a fixed sequence of stages (after the heaps of the rows and
// directions they transform with: the caller's)
// ---------------------------------------------------------------------------

// the op's table and heaps: table rows 0..l, heaps (2, l+1, N)
void bind_consts(Exec &ex, const Consts &g, const uint32_t *tw) {
  ex.op = {g.table, g.ncols, g.level + 1, tw};
}

void pointwise_op(Exec &ex, const Consts &g, int batch, int mode,
                  const uint32_t *a0, const uint32_t *a1, const uint32_t *b0,
                  const uint32_t *b1, uint32_t *o0, uint32_t *o1) {
  PointwiseStage s = {g, mode, a0, a1, b0, b1, o0, o1};
  ex.ew(s, g.level, chunks(g, kChunk), batch);
}

// drop limb l-1 of (x0, x1) (B, l, N) into (o0, o1) (B, l-1, N); pm: the
// fused ct x pt in front (K8b) or null (K8); w: (B, 2, N) int32 scratch.
// Heaps: inverse row l-1, forward rows 0..l-2.
void rescale_op(Exec &ex, const Consts &g, int batch, const uint32_t *x0,
                const uint32_t *x1, const uint32_t *pm, int32_t *w,
                uint32_t *o0, uint32_t *o1, int off_qdinv) {
  const int l = g.level;
  LiftStage lift = {g, x0, x1, l, l - 1, nullptr, pm, w, 2};
  ex.ntt(lift, 2LL * batch, g.logn);
  ScaleDownStage down = {g, x0, x1, l, pm, w, nullptr, nullptr, nullptr,
                         o0, o1, l - 1, off_qdinv};
  ex.ntt(down, 2LL * batch * (l - 1), g.logn);
}

// the digit-NTT stack of x (B, l, N), gathered by perm when given. Heaps:
// inverse rows 0..l-1, forward rows 0..l.
void decompose_op(Exec &ex, const Consts &g, int batch, const uint32_t *x,
                  const int32_t *perm, int32_t *digits, uint32_t *h) {
  const int l = g.level;
  LiftStage lift = {g, x, nullptr, l, 0, perm, nullptr, digits, l};
  ex.ntt(lift, (long long)batch * l, g.logn);
  ExtendStage ext = {g, digits, h};
  ex.ntt(ext, (long long)batch * (l + 1) * l, g.logn);
}

// multiply-accumulate against the key (h gathered by perm when given), then
// mod-down by P: out_p = [add_p +] (acc_p - lift(acc_p[l])) P^-1. Heaps:
// inverse row l, forward rows 0..l-1.
void apply_op(Exec &ex, const Consts &g, int batch, const uint32_t *h,
              const int32_t *perm, const uint32_t *kb, const uint32_t *ka,
              uint32_t *acc, int32_t *w, const uint32_t *add0,
              const uint32_t *add1, const int32_t *add_perm, uint32_t *out0,
              uint32_t *out1, int off_pinv) {
  const int l = g.level;
  const size_t n = g.n();
  MacStage mac = {g, h, perm, kb, ka, acc};
  ex.ew(mac, l + 1, chunks(g, kNarrowChunk), batch);
  LiftStage lift = {g, acc, acc + (size_t)(l + 1) * n, 2 * (l + 1), l,
                    nullptr, nullptr, w, 2};
  ex.ntt(lift, 2LL * batch, g.logn);
  ScaleDownStage down = {g, acc, acc + (size_t)(l + 1) * n, 2 * (l + 1),
                         nullptr, w, add0, add1, add_perm, out0, out1, l,
                         off_pinv};
  ex.ntt(down, 2LL * batch * l, g.logn);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: the CUDA launches (suffix _launch, last argument the
// stream) and the host build of the same stages (suffix _host; the ops that
// transform take a forced tile geometry (ga, lc, lr, brev) last instead,
// ga, lc, lr < 0 and brev 0 the CUDA entries' plan). tw: the op's (2, l+1,
// N) heap scratch.
// ---------------------------------------------------------------------------
#if defined(__CUDACC__)
#define SE_ENTRY(name) extern "C" int name##_launch
#define SE_TAIL , void *stream
#define SE_NTT_TAIL , void *stream
#define SE_EXEC Exec ex(stream)
#define SE_NTT_EXEC Exec ex(stream)
#else
#define SE_ENTRY(name) extern "C" int name##_host
#define SE_TAIL
#define SE_NTT_TAIL , int ga, int lc, int lr, int brev
#define SE_EXEC Exec ex(-1, -1, -1, 0)
#define SE_NTT_EXEC Exec ex(ga, lc, lr, brev)
#endif

SE_ENTRY(server_pointwise)(int mode, const uint32_t *a0, const uint32_t *a1,
                           const uint32_t *b0, const uint32_t *b1,
                           const uint32_t *table, uint32_t *o0, uint32_t *o1,
                           int batch, int level, int logn,
                           int ncols SE_TAIL) {
  SE_EXEC;
  Consts g = {table, ncols, level, logn};
  pointwise_op(ex, g, batch, mode, a0, a1, b0, b1, o0, o1);
  return (int)ex.err;
}

SE_ENTRY(server_rescale)(const uint32_t *c0, const uint32_t *c1,
                         const uint32_t *pm, const uint32_t *table,
                         uint32_t *tw, int32_t *w, uint32_t *o0, uint32_t *o1,
                         int batch, int level, int logn, int ncols,
                         int off_qdinv SE_NTT_TAIL) {
  SE_NTT_EXEC;
  Consts g = {table, ncols, level, logn};
  bind_consts(ex, g, tw);
  ex.heaps(logn, 0, level - 1, level - 1, level);
  rescale_op(ex, g, batch, c0, c1, pm, w, o0, o1, off_qdinv);
  return (int)ex.err;
}

SE_ENTRY(server_ks_decompose)(const uint32_t *c1, const uint32_t *table,
                              uint32_t *tw, int32_t *digits, uint32_t *h,
                              int batch, int level, int logn,
                              int ncols SE_NTT_TAIL) {
  SE_NTT_EXEC;
  Consts g = {table, ncols, level, logn};
  bind_consts(ex, g, tw);
  ex.heaps(logn, 0, level + 1, 0, level);
  decompose_op(ex, g, batch, c1, nullptr, digits, h);
  return (int)ex.err;
}

SE_ENTRY(server_ks_apply_rot)(const uint32_t *c0, const uint32_t *h,
                              const int32_t *perm, const uint32_t *kb,
                              const uint32_t *ka, const uint32_t *table,
                              uint32_t *tw, uint32_t *acc, int32_t *w,
                              uint32_t *o0, uint32_t *o1, int batch,
                              int level, int logn, int ncols,
                              int off_pinv SE_NTT_TAIL) {
  SE_NTT_EXEC;
  Consts g = {table, ncols, level, logn};
  bind_consts(ex, g, tw);
  ex.heaps(logn, 0, level, level, level + 1);
  apply_op(ex, g, batch, h, perm, kb, ka, acc, w, c0, nullptr, perm, o0, o1,
           off_pinv);
  return (int)ex.err;
}

SE_ENTRY(server_rotate)(const uint32_t *c0, const uint32_t *c1,
                        const int32_t *perm, const uint32_t *kb,
                        const uint32_t *ka, const uint32_t *table,
                        uint32_t *tw, int32_t *digits, uint32_t *h,
                        uint32_t *acc, int32_t *w, uint32_t *o0, uint32_t *o1,
                        int batch, int level, int logn, int ncols,
                        int off_pinv SE_NTT_TAIL) {
  SE_NTT_EXEC;
  Consts g = {table, ncols, level, logn};
  bind_consts(ex, g, tw);
  ex.heaps(logn, 0, level + 1, 0, level + 1);
  decompose_op(ex, g, batch, c1, perm, digits, h);
  apply_op(ex, g, batch, h, nullptr, kb, ka, acc, w, c0, nullptr, perm, o0,
           o1, off_pinv);
  return (int)ex.err;
}

SE_ENTRY(server_mul_ct)(const uint32_t *a0, const uint32_t *a1,
                        const uint32_t *b0, const uint32_t *b1,
                        const uint32_t *kb, const uint32_t *ka,
                        const uint32_t *table, uint32_t *tw, uint32_t *d0,
                        uint32_t *d1, uint32_t *d2, int32_t *digits,
                        uint32_t *h, uint32_t *acc, int32_t *w, uint32_t *t0,
                        uint32_t *t1, uint32_t *o0, uint32_t *o1, int batch,
                        int level, int logn, int ncols, int off_r2,
                        int off_pinv, int off_qdinv SE_NTT_TAIL) {
  SE_NTT_EXEC;
  Consts g = {table, ncols, level, logn};
  bind_consts(ex, g, tw);
  ex.heaps(logn, 0, level + 1, 0, level + 1);
  TensorStage tensor = {g, off_r2, a0, a1, b0, b1, d0, d1, d2};
  ex.ew(tensor, level, chunks(g, kNarrowChunk), batch);
  decompose_op(ex, g, batch, d2, nullptr, digits, h);
  apply_op(ex, g, batch, h, nullptr, kb, ka, acc, w, d0, d1, nullptr, t0, t1,
           off_pinv);
  rescale_op(ex, g, batch, t0, t1, nullptr, w, o0, o1, off_qdinv);
  return (int)ex.err;
}
