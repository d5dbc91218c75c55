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
// shared memory. So each op is a short sequence of launches over parallel
// grids on the caller's stream, with the intermediates in device memory
// (scratch the wrapper allocates):
//   lift       grid (rows, B):        gather / REDC, INTT, centre -> int32
//                                     digits (rescale top limb, key-switch
//                                     digits, mod-down special row)
//   extend     grid (l+1, l, B):      digit -> residue on row i, NTT: the
//                                     (B, l+1, l, N) digit-NTT stack h
//   mac        grid (l+1, chunks, B): acc_i = sum_j REDC(h_ij, ksk_j[i])
//   scale_down grid (rows, 2, B):     residue of the centred row, NTT,
//                                     submod, REDC by q_drop^-1 or P^-1,
//                                     add the other half
//   pointwise / tensor grid (l, chunks, B): the elementwise ops
// Every NTT / INTT block runs one row with 1024 threads and one stage's
// twiddles in dynamic shared memory (the stage loops of client_common.cuh).
//
// What bounds them on an H100: a key switch at level l runs l^2 + 4l + 2
// NTTs of N points (19 int32 operations per butterfly) and 2 l (l+1) N REDCs
// against 2 l (l+1) N key words read once: operations, not bytes. K7 is
// elementwise: bytes. This first version is simple rather than fast: the
// digit-NTT stack h lands in device memory (157 MB per ciphertext at
// l = 24) and each NTT block is one row, stage by stage through global
// memory.
#include "server_common.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

namespace {

#if defined(__CUDACC__)
#define SE_MEMBER __device__
#define SE_HD __host__ __device__
#else
#define SE_MEMBER inline
#define SE_HD inline
#endif

constexpr int kNttThreads = 1024;
constexpr int kEwThreads = 256;
constexpr int kChunk = 2048;  // columns per elementwise block

struct Geo {
  const uint32_t *table;  // (l+1, ncols) server constant table
  int ncols, level, logn;
  SE_MEMBER const uint32_t *row(int i) const {
    return table + (size_t)i * ncols;
  }
  SE_HD size_t n() const { return (size_t)1 << logn; }
  // columns [chunk * kChunk, cols_end(chunk)) of an elementwise block
  SE_MEMBER int cols_end(int chunk) const {
    const size_t end = (size_t)(chunk + 1) * kChunk;
    return (int)(end < n() ? end : n());
  }
};

// K7: mode 0 ct + ct, 1 ct + pt, 2 ct x pt (REDC by a Montgomery-form pt)
struct PointwiseStage {
  Geo g;
  int mode;
  const uint32_t *a0, *a1, *b0, *b1;  // b0: the pt (l, N) in modes 1, 2
  uint32_t *o0, *o1;
  SE_MEMBER void block(int j, int chunk, int b, uint32_t *) const {
    const size_t n = g.n();
    const size_t row = ((size_t)b * g.level + j) * n;
    const uint32_t q = g.row(j)[rt::OFF_Q], qinv = g.row(j)[rt::OFF_QINV];
    const int c0 = chunk * kChunk, c1 = g.cols_end(chunk);
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
  Geo g;
  int off_r2;
  const uint32_t *a0, *a1, *b0, *b1;
  uint32_t *d0, *d1, *d2;
  SE_MEMBER void block(int j, int chunk, int b, uint32_t *) const {
    const size_t n = g.n();
    const size_t row = ((size_t)b * g.level + j) * n;
    const uint32_t *tr = g.row(j);
    const uint32_t q = tr[rt::OFF_Q], qinv = tr[rt::OFF_QINV];
    const uint32_t r2 = tr[off_r2];
    const int c0 = chunk * kChunk, c1 = g.cols_end(chunk);
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

// lift rows, block (x, y), y the batch row: source row sx of poly
// src (or, with src1 given, of poly x of the pair (src, src1)),
// gathered by perm and REDC'd by the pm row sx when given, INTT with table
// row sx, centred into dst + (y * dst_rows + x) * N. sx = x0 + x: the limb
// x of the key-switch digits (x0 = 0); sx = x0 for a pair: the top row
// of a rescale (x0 = l-1) or of a mod-down (x0 = l).
struct LiftStage {
  Geo g;
  const uint32_t *src, *src1;
  int src_rows, x0;    // rows per batch entry of a source poly, first row
  const int32_t *perm;
  const uint32_t *pm;  // (l, N) or null
  int32_t *dst;
  int dst_rows;
  SE_MEMBER void block(int x, int y, int, uint32_t *tw) const {
    const size_t n = g.n();
    const uint32_t *s = (src1 && x == 1) ? src1 : src;
    const int sx = src1 ? x0 : x0 + x;
    rt::lift_row(s + ((size_t)y * src_rows + sx) * n, perm,
                 pm ? pm + (size_t)sx * n : nullptr,
                 dst + ((size_t)y * dst_rows + x) * n, g.logn, g.row(sx), tw);
  }
};

// the digit-NTT stack: h[b][i][j] = NTT_i(residue(D[b][j]))
struct ExtendStage {
  Geo g;
  const int32_t *digits;  // (B, l, N)
  uint32_t *h;            // (B, l+1, l, N)
  SE_MEMBER void block(int i, int j, int b, uint32_t *tw) const {
    const size_t n = g.n();
    const int l = g.level;
    rt::extend_row(digits + ((size_t)b * l + j) * n,
                   h + (((size_t)b * (l + 1) + i) * l + j) * n, g.logn,
                   g.row(i), tw);
  }
};

// acc[b][p][i] = sum_j REDC(h[b][i][j] (permuted), ksk_p[j][i])
struct MacStage {
  Geo g;
  const uint32_t *h;           // (B, l+1, l, N)
  const int32_t *perm;         // (N) or null
  const uint32_t *kb, *ka;     // (l, l+1, N)
  uint32_t *acc;               // (B, 2, l+1, N)
  SE_MEMBER void block(int i, int chunk, int b, uint32_t *) const {
    const size_t n = g.n();
    const int l = g.level;
    const int c0 = chunk * kChunk, c1 = g.cols_end(chunk);
    const uint32_t *tr = g.row(i);
    rt::mac_cols(h + ((size_t)b * (l + 1) + i) * l * n, perm,
                 kb + (size_t)i * n, ka + (size_t)i * n, (size_t)(l + 1) * n,
                 acc + ((size_t)b * 2 * (l + 1) + i) * n,
                 acc + (((size_t)b * 2 + 1) * (l + 1) + i) * n, l, g.logn,
                 c0, c1, tr[rt::OFF_Q], tr[rt::OFF_QINV]);
  }
};

// scale-down rows: block (i, p, b): x = x_p + (b * x_rows + i) * N (REDC'd
// by pm row i), w = w + (b * 2 + p) * N, constant column off_c of table row
// i, add_p + (b * l_out + i) * N (gathered by add_perm) when add_p is given;
// out_p + (b * l_out + i) * N.
struct ScaleDownStage {
  Geo g;
  const uint32_t *x0, *x1;
  int x_rows;
  const uint32_t *pm;
  const int32_t *w;        // (B, 2, N)
  const uint32_t *add0, *add1;
  const int32_t *add_perm;
  uint32_t *out0, *out1;
  int l_out, off_c;
  SE_MEMBER void block(int i, int p, int b, uint32_t *tw) const {
    const size_t n = g.n();
    const uint32_t *x = p == 0 ? x0 : x1;
    const uint32_t *add = p == 0 ? add0 : add1;
    uint32_t *out = p == 0 ? out0 : out1;
    const uint32_t *tr = g.row(i);
    rt::scale_down_row(x + ((size_t)b * x_rows + i) * n,
                       pm ? pm + (size_t)i * n : nullptr,
                       w + ((size_t)b * 2 + p) * n,
                       add ? add + ((size_t)b * l_out + i) * n : nullptr,
                       add_perm, out + ((size_t)b * l_out + i) * n,
                       tr[off_c], g.logn, tr, tw);
  }
};

struct Dims {
  int x, y, z, threads;
  bool ntt;  // needs one stage's twiddles in shared memory
};

// ---------------------------------------------------------------------------
// the executor: a CUDA launch per stage on the caller's stream, or (host
// build) the same blocks one after another
// ---------------------------------------------------------------------------
#if defined(__CUDACC__)

template <typename S>
__global__ void __launch_bounds__(1024) stage_kernel(S s) {
  extern __shared__ uint32_t tw_smem[];
  s.block(blockIdx.x, blockIdx.y, blockIdx.z, tw_smem);
}

struct Exec {
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;
  template <typename S>
  void run(const S &s, Dims d, int logn) {
    if (err != cudaSuccess) return;
    const size_t smem = d.ntt ? sizeof(uint32_t) << (logn - 1) : 0;
    static rt::SmemAllowance allowance;
    if (smem > 0) {
      err = rt::allow_dynamic_smem(stage_kernel<S>, smem, allowance);
      if (err != cudaSuccess) return;
    }
    stage_kernel<S><<<dim3(d.x, d.y, d.z), d.threads, smem, stream>>>(s);
    err = cudaGetLastError();
  }
};

#else

struct Exec {
  int err = 0;
  template <typename S>
  void run(const S &s, Dims d, int logn) {
    std::vector<uint32_t> tw((size_t)1 << (logn > 0 ? logn - 1 : 0));
    for (int z = 0; z < d.z; ++z)
      for (int y = 0; y < d.y; ++y)
        for (int x = 0; x < d.x; ++x) s.block(x, y, z, tw.data());
  }
};

#endif

int chunks(const Geo &g) { return (int)((g.n() + kChunk - 1) / kChunk); }

// ---------------------------------------------------------------------------
// the ops, each a fixed sequence of stages
// ---------------------------------------------------------------------------

void pointwise_op(Exec &ex, const Geo &g, int batch, int mode,
                  const uint32_t *a0, const uint32_t *a1, const uint32_t *b0,
                  const uint32_t *b1, uint32_t *o0, uint32_t *o1) {
  PointwiseStage s = {g, mode, a0, a1, b0, b1, o0, o1};
  ex.run(s, {g.level, chunks(g), batch, kEwThreads, false}, g.logn);
}

// drop limb l-1 of (x0, x1) (B, l, N) into (o0, o1) (B, l-1, N); pm: the
// fused ct x pt in front (K8b) or null (K8); w: (B, 2, N) int32 scratch
void rescale_op(Exec &ex, const Geo &g, int batch, const uint32_t *x0,
                const uint32_t *x1, const uint32_t *pm, int32_t *w,
                uint32_t *o0, uint32_t *o1, int off_qdinv) {
  const int l = g.level;
  LiftStage lift = {g, x0, x1, l, l - 1, nullptr, pm, w, 2};
  ex.run(lift, {2, batch, 1, kNttThreads, true}, g.logn);
  ScaleDownStage down = {g, x0, x1, l, pm, w, nullptr, nullptr, nullptr,
                         o0, o1, l - 1, off_qdinv};
  ex.run(down, {l - 1, 2, batch, kNttThreads, true}, g.logn);
}

// the digit-NTT stack of x (B, l, N), gathered by perm when given
void decompose_op(Exec &ex, const Geo &g, int batch, const uint32_t *x,
                  const int32_t *perm, int32_t *digits, uint32_t *h) {
  const int l = g.level;
  LiftStage lift = {g, x, nullptr, l, 0, perm, nullptr, digits, l};
  ex.run(lift, {l, batch, 1, kNttThreads, true}, g.logn);
  ExtendStage ext = {g, digits, h};
  ex.run(ext, {l + 1, l, batch, kNttThreads, true}, g.logn);
}

// multiply-accumulate against the key (h gathered by perm when given), then
// mod-down by P: out_p = [add_p +] (acc_p - lift(acc_p[l])) P^-1
void apply_op(Exec &ex, const Geo &g, int batch, const uint32_t *h,
              const int32_t *perm, const uint32_t *kb, const uint32_t *ka,
              uint32_t *acc, int32_t *w, const uint32_t *add0,
              const uint32_t *add1, const int32_t *add_perm, uint32_t *out0,
              uint32_t *out1, int off_pinv) {
  const int l = g.level;
  const size_t n = g.n();
  MacStage mac = {g, h, perm, kb, ka, acc};
  ex.run(mac, {l + 1, chunks(g), batch, kEwThreads, false}, g.logn);
  LiftStage lift = {g, acc, acc + (size_t)(l + 1) * n, 2 * (l + 1), l,
                    nullptr, nullptr, w, 2};
  ex.run(lift, {2, batch, 1, kNttThreads, true}, g.logn);
  ScaleDownStage down = {g, acc, acc + (size_t)(l + 1) * n, 2 * (l + 1),
                         nullptr, w, add0, add1, add_perm, out0, out1, l,
                         off_pinv};
  ex.run(down, {l, 2, batch, kNttThreads, true}, g.logn);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: the CUDA launches (suffix _launch, last argument the
// stream) and the host build of the same stages (suffix _host)
// ---------------------------------------------------------------------------
#if defined(__CUDACC__)
#define SE_ENTRY(name) extern "C" int name##_launch
#define SE_STREAM , void *stream
#define SE_EXEC \
  Exec ex;      \
  ex.stream = (cudaStream_t)stream
#else
#define SE_ENTRY(name) extern "C" int name##_host
#define SE_STREAM
#define SE_EXEC Exec ex
#endif

SE_ENTRY(server_pointwise)(int mode, const uint32_t *a0, const uint32_t *a1,
                           const uint32_t *b0, const uint32_t *b1,
                           const uint32_t *table, uint32_t *o0, uint32_t *o1,
                           int batch, int level, int logn,
                           int ncols SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  pointwise_op(ex, g, batch, mode, a0, a1, b0, b1, o0, o1);
  return (int)ex.err;
}

SE_ENTRY(server_rescale)(const uint32_t *c0, const uint32_t *c1,
                         const uint32_t *pm, const uint32_t *table,
                         int32_t *w, uint32_t *o0, uint32_t *o1, int batch,
                         int level, int logn, int ncols,
                         int off_qdinv SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  rescale_op(ex, g, batch, c0, c1, pm, w, o0, o1, off_qdinv);
  return (int)ex.err;
}

SE_ENTRY(server_ks_decompose)(const uint32_t *c1, const uint32_t *table,
                              int32_t *digits, uint32_t *h, int batch,
                              int level, int logn, int ncols SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  decompose_op(ex, g, batch, c1, nullptr, digits, h);
  return (int)ex.err;
}

SE_ENTRY(server_ks_apply_rot)(const uint32_t *c0, const uint32_t *h,
                              const int32_t *perm, const uint32_t *kb,
                              const uint32_t *ka, const uint32_t *table,
                              uint32_t *acc, int32_t *w, uint32_t *o0,
                              uint32_t *o1, int batch, int level, int logn,
                              int ncols, int off_pinv SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  apply_op(ex, g, batch, h, perm, kb, ka, acc, w, c0, nullptr, perm, o0, o1,
           off_pinv);
  return (int)ex.err;
}

SE_ENTRY(server_rotate)(const uint32_t *c0, const uint32_t *c1,
                        const int32_t *perm, const uint32_t *kb,
                        const uint32_t *ka, const uint32_t *table,
                        int32_t *digits, uint32_t *h, uint32_t *acc,
                        int32_t *w, uint32_t *o0, uint32_t *o1, int batch,
                        int level, int logn, int ncols,
                        int off_pinv SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  decompose_op(ex, g, batch, c1, perm, digits, h);
  apply_op(ex, g, batch, h, nullptr, kb, ka, acc, w, c0, nullptr, perm, o0,
           o1, off_pinv);
  return (int)ex.err;
}

SE_ENTRY(server_mul_ct)(const uint32_t *a0, const uint32_t *a1,
                        const uint32_t *b0, const uint32_t *b1,
                        const uint32_t *kb, const uint32_t *ka,
                        const uint32_t *table, uint32_t *d0, uint32_t *d1,
                        uint32_t *d2, int32_t *digits, uint32_t *h,
                        uint32_t *acc, int32_t *w, uint32_t *t0, uint32_t *t1,
                        uint32_t *o0, uint32_t *o1, int batch, int level,
                        int logn, int ncols, int off_r2, int off_pinv,
                        int off_qdinv SE_STREAM) {
  SE_EXEC;
  Geo g = {table, ncols, level, logn};
  TensorStage tensor = {g, off_r2, a0, a1, b0, b1, d0, d1, d2};
  ex.run(tensor, {level, chunks(g), batch, kEwThreads, false}, logn);
  decompose_op(ex, g, batch, d2, nullptr, digits, h);
  apply_op(ex, g, batch, h, nullptr, kb, ka, acc, w, d0, d1, nullptr, t0, t1,
           off_pinv);
  rescale_op(ex, g, batch, t0, t1, nullptr, w, o0, o1, off_qdinv);
  return (int)ex.err;
}
