// Single-prime negacyclic NTT / INTT with the shift-add REDC for Hopper
// (sm_90a): K12.
//
// Replaces the TPU kernels src/repro/kernels/ntt_butterfly.py:_kernel_fwd
// and :_kernel_inv (ntt_rows / intt_rows: one pallas_call over (rows, N)
// uint32 residues of one prime, its constants fixed at compile time, the
// stage loops common.ntt_stages / intt_stages with the NTT-friendly
// shift-add Montgomery REDC of paper eq. 9-11). Forward: natural order in,
// bit-reversed out. Inverse: bit-reversed in, natural order out, N^-1
// folded in. Output words are bit-identical to the plain version
// (ntt_butterfly.rows_plain), to K1 on that prime, and to the JAX
// reference.
//
// The reference bakes q and the k-terms into each compiled kernel. Here
// they are launch data: one row of common.sa_table (q, p_bw, n+1, up to
// three signed k-term exponents), so one build serves every prime, and the
// stage loop is the one-row loop of client_common.cuh (rt::ntt_fwd /
// rt::ntt_inv, as K3's) under the SaRedc policy instead of MontRedc.
// Grid (rows,): one block per row copies it into the output and transforms
// it in place; each stage's twiddles are doubled from the prime's
// seed-table row into dynamic shared memory (at most N/2 words: 128 KB at
// N = 2^16).
//
// What bounds it on an H100: logN * N/2 butterflies per row, each one
// shift-add REDC (one 32x32 product, the rest shifts and adds: more
// integer instructions than MontRedc's three products) plus addmod and
// submod, against 8 bytes of row traffic per coefficient: operations, not
// bytes. The loop keeps the 256 KB row in global memory, so every stage
// reads and writes it there with a block barrier between stages.
#include "client_common.cuh"

namespace {

struct RowsArgs {
  const uint32_t *x;      // (rows, N)
  uint32_t *out;          // (rows, N)
  const uint32_t *trow;   // (K,) seed-table row of the prime
  const int32_t *sa;      // (SA_COLS,) shift-add REDC row of the prime
  int logn;
  bool inverse;
};

RT_BODY void ntt_row(const RowsArgs &a, int r, uint32_t *tw) {
  const int n = 1 << a.logn;
  const uint32_t *x = a.x + (size_t)r * n;
  uint32_t *y = a.out + (size_t)r * n;
  for (int i = RT_TID; i < n; i += RT_NT) y[i] = x[i];
  RT_SYNC();
  const rt::SaRedc red = rt::sa_redc(a.sa);
  rt::Rows rows = {{y, y, y, y}};
  if (a.inverse)
    rt::ntt_inv(rows, 1, a.logn, a.trow, red, tw);
  else
    rt::ntt_fwd(rows, 1, a.logn, a.trow, red, tw);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) ntt_rows_kernel(RowsArgs a) {
  extern __shared__ uint32_t tw_smem[];
  ntt_row(a, blockIdx.x, tw_smem);
}

}  // namespace

extern "C" int ntt_rows_launch(const uint32_t *x, uint32_t *out,
                               const uint32_t *trow, const int32_t *sa,
                               int rows, int logn, int inverse,
                               void *stream) {
  RowsArgs a = {x, out, trow, sa, logn, inverse != 0};
  const size_t smem = sizeof(uint32_t) << (logn - 1);  // one stage's twiddles
  static rt::SmemAllowance allowance;
  cudaError_t err = rt::allow_dynamic_smem(ntt_rows_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  ntt_rows_kernel<<<rows, 1024, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block body (one thread per block)

#include <vector>

extern "C" int ntt_rows_host(const uint32_t *x, uint32_t *out,
                             const uint32_t *trow, const int32_t *sa,
                             int rows, int logn, int inverse) {
  RowsArgs a = {x, out, trow, sa, logn, inverse != 0};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int r = 0; r < rows; ++r) ntt_row(a, r, tw_smem.data());
  return 0;
}

#endif
