// Limb-folded negacyclic NTT / INTT for Hopper (sm_90a): K1.
//
// Replaces the TPU kernels src/repro/kernels/ntt_butterfly.py
// :_kernel_fwd_folded and :_kernel_inv_folded (one pallas_call over an
// (L, rows, N) uint32 residue stack, per-limb constants from the (L, K)
// seed table). Forward: merged-psi Cooley-Tukey DIT, natural order in,
// bit-reversed order out. Inverse: Gentleman-Sande, bit-reversed in,
// natural order out, N^-1 folded in. Output words are bit-identical to the
// plain version (ntt_butterfly.limb_rows_plain) and to the JAX reference.
//
// Grid (L, rows): one block per (limb, row) copies its input row into the
// output row and runs the stage loop of client_common.cuh (rt::ntt_fwd /
// rt::ntt_inv) on it in place. Each stage's twiddles are rebuilt by
// Montgomery doubling from the limb's seed-table row into dynamic shared
// memory (at most N/2 words: 128 KB at N = 2^16).
//
// What bounds it on an H100: per row and limb logN * N/2 butterflies of 19
// int32 operations against 8 bytes of row traffic per coefficient (read
// once, written once): operations, not bytes. This first version is
// simple rather than fast: a row (256 KB at N = 2^16) does not fit a
// block's 227 KB of shared memory, so every stage reads and writes the row
// in global memory (L2-resident as far as it goes) with a block barrier
// between stages.
#include "client_common.cuh"

namespace {

struct NttArgs {
  const uint32_t *x;     // (L, rows, N)
  uint32_t *out;         // (L, rows, N)
  const uint32_t *table; // (L, K) seed table
  int rows, logn, n_scalars;
  bool inverse;
};

RT_BODY void ntt_limb_row(const NttArgs &a, int l, int r, uint32_t *tw) {
  const int n = 1 << a.logn;
  const size_t off = ((size_t)l * a.rows + r) * n;
  const uint32_t *x = a.x + off;
  uint32_t *y = a.out + off;
  for (int i = RT_TID; i < n; i += RT_NT) y[i] = x[i];
  RT_SYNC();
  const uint32_t *trow = a.table + (size_t)l * a.n_scalars;
  rt::Rows rows = {{y, y, y, y}};
  if (a.inverse)
    rt::ntt_inv(rows, 1, a.logn, trow, tw);
  else
    rt::ntt_fwd(rows, 1, a.logn, trow, tw);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) ntt_limbs_kernel(NttArgs a) {
  extern __shared__ uint32_t tw_smem[];
  ntt_limb_row(a, blockIdx.x, blockIdx.y, tw_smem);
}

}  // namespace

extern "C" int ntt_limbs_launch(const uint32_t *x, uint32_t *out,
                                const uint32_t *table, int n_limbs, int rows,
                                int logn, int n_scalars, int inverse,
                                void *stream) {
  NttArgs a = {x, out, table, rows, logn, n_scalars, inverse != 0};
  const size_t smem = sizeof(uint32_t) << (logn - 1);  // one stage's twiddles
  static rt::SmemAllowance allowance;
  cudaError_t err = rt::allow_dynamic_smem(ntt_limbs_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  ntt_limbs_kernel<<<dim3(n_limbs, rows), 1024, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block body (one thread per block)

#include <vector>

extern "C" int ntt_limbs_host(const uint32_t *x, uint32_t *out,
                              const uint32_t *table, int n_limbs, int rows,
                              int logn, int n_scalars, int inverse) {
  NttArgs a = {x, out, table, rows, logn, n_scalars, inverse != 0};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int l = 0; l < n_limbs; ++l)
    for (int r = 0; r < rows; ++r) ntt_limb_row(a, l, r, tw_smem.data());
  return 0;
}

#endif
