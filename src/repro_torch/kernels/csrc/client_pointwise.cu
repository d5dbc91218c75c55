// Limb-folded encrypt (K2) and decrypt (K3), and the per-limb encrypt
// (K13a) and decrypt (K13b), for Hopper (sm_90a).
//
// K2 replaces the TPU kernel src/repro/kernels/client_pointwise.py
// :_encrypt_kernel_folded (encrypt_limbs): for every (limb, row) of a
// (B, L, N) NTT-domain plaintext, Philox (v, e0, e1) keyed by
// (seed, nonce0 + row) (the sum wraps mod 2^32), residues, one NTT stage
// loop over the three rows, c0 = (v*b + e0) + pt and c1 = v*a + e1.
// K3 replaces :_decrypt_kernel_folded (decrypt_limbs): m = INTT(c0 + c1*s)
// for every (limb, row) of a (B, L_dec, N) ciphertext view.
// Output words are bit-identical to the plain versions
// (client_pointwise.encrypt_limbs_plain / decrypt_limbs_plain) and to the
// JAX reference.
//
// Grids: K2 (L, B), K3 (L_dec, B); one block per (limb, row) runs the
// block body it shares with the megakernels (rt::encrypt_limb_block with
// K5, rt::decrypt_limb_block with K6). K2 transforms e0 and e1 in place in
// the c0 / c1 output rows and v in a (B, L, N) scratch. K3 reads rows of
// any stride (the 2-limb view of a (B, L, N) batch) and writes (B, L_dec,
// N). The reference's batch block (_batch_block) only bounds a TPU grid
// step's working set and changes no output; the grid here is always one
// block per (limb, row).
//
// K13a replaces :_encrypt_kernel (encrypt_limb) and K13b :_decrypt_kernel
// (decrypt_limb): the same block bodies for ONE limb of a (B, N) batch,
// grid (B,), one launch per limb as in the reference, with the shift-add
// REDC of paper eq. 9-11 (rt::SaRedc; the reference bakes the prime's
// k-terms into each compiled kernel, here they come from a row of
// common.sa_table). Row b encrypts under nonce0 + b (mod 2^32). Their words
// equal K2's / K3's on that limb and the plain versions
// (client_pointwise.encrypt_limb_plain / decrypt_limb_plain).
//
// What bounds them on an H100: K2 writes 8 bytes per (row, limb,
// coefficient) but needs three 16-stage NTTs and five Philox-10 words per
// coefficient; K3 one INTT per (row, limb): operations, not bytes. As in
// the megakernels, the NTT rows (256 KB at N = 2^16) stream through global
// memory with a barrier per stage; only a stage's twiddles sit in shared
// memory.
#include "client_common.cuh"

namespace {

struct EncArgs {
  const uint32_t *pt;          // (B, L, N) NTT domain
  const uint32_t *pk_b, *pk_a; // (>=L, N) Montgomery form
  const uint32_t *table;       // (L, K) seed table
  uint32_t *c0, *c1;           // (B, L, N)
  uint32_t *v;                 // (B, L, N) scratch
  int n_limbs, logn, n_scalars;
  rt::Seed seed;
  uint32_t nonce0;
};

RT_BODY void encrypt_limb(const EncArgs &a, int l, int b, uint32_t *tw) {
  const int n = 1 << a.logn;
  const size_t off = ((size_t)b * a.n_limbs + l) * n;
  rt::EncLimb e = {a.c0 + off, a.c1 + off, a.v + off,
                   const_cast<uint32_t *>(a.pt + off),  // read only
                   a.pk_b + (size_t)l * n, a.pk_a + (size_t)l * n,
                   a.table + (size_t)l * a.n_scalars, a.logn, false,
                   a.nonce0 + (uint32_t)b, a.seed};
  rt::encrypt_limb_block(e, tw);
}

struct DecArgs {
  const uint32_t *c0, *c1;  // (B, >=L, N), row stride `row_stride`
  long long row_stride;
  const uint32_t *s_mont;   // (>=L, N)
  const uint32_t *table;    // (L, K) seed table
  uint32_t *m;              // (B, L, N)
  int n_limbs, logn, n_scalars;
};

RT_BODY void decrypt_limb(const DecArgs &a, int l, int b, uint32_t *tw) {
  const int n = 1 << a.logn;
  const size_t row = (size_t)b * a.row_stride + (size_t)l * n;
  rt::decrypt_limb_block(a.c0 + row, a.c1 + row, a.s_mont + (size_t)l * n,
                         a.m + ((size_t)b * a.n_limbs + l) * n, a.logn,
                         a.table + (size_t)l * a.n_scalars, tw);
}

// K13: one limb of a (B, N) batch under the shift-add REDC
struct EncOneArgs {
  const uint32_t *pt;          // (B, N) NTT domain
  const uint32_t *pk_b, *pk_a; // (N) Montgomery form
  const uint32_t *trow;        // (K,) seed-table row of the limb's prime
  const int32_t *sa;           // (SA_COLS,) its shift-add REDC row
  uint32_t *c0, *c1;           // (B, N)
  uint32_t *v;                 // (B, N) scratch
  int logn;
  rt::Seed seed;
  uint32_t nonce0;
};

RT_BODY void encrypt_one_limb(const EncOneArgs &a, int b, uint32_t *tw) {
  const size_t off = (size_t)b << a.logn;
  rt::EncLimb e = {a.c0 + off, a.c1 + off, a.v + off,
                   const_cast<uint32_t *>(a.pt + off),  // read only
                   a.pk_b, a.pk_a, a.trow, a.logn, false,
                   a.nonce0 + (uint32_t)b, a.seed};
  rt::encrypt_limb_block(e, rt::sa_redc(a.sa), tw);
}

struct DecOneArgs {
  const uint32_t *c0, *c1;  // (B, N)
  const uint32_t *s_mont;   // (N)
  const uint32_t *trow;
  const int32_t *sa;
  uint32_t *m;              // (B, N)
  int logn;
};

RT_BODY void decrypt_one_limb(const DecOneArgs &a, int b, uint32_t *tw) {
  const size_t off = (size_t)b << a.logn;
  rt::decrypt_limb_block(a.c0 + off, a.c1 + off, a.s_mont, a.m + off, a.logn,
                         a.trow, rt::sa_redc(a.sa), tw);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void __launch_bounds__(1024) encrypt_folded_kernel(EncArgs a) {
  extern __shared__ uint32_t tw_smem[];
  encrypt_limb(a, blockIdx.x, blockIdx.y, tw_smem);
}

__global__ void __launch_bounds__(1024) decrypt_folded_kernel(DecArgs a) {
  extern __shared__ uint32_t tw_smem[];
  decrypt_limb(a, blockIdx.x, blockIdx.y, tw_smem);
}

__global__ void __launch_bounds__(1024) encrypt_limb_kernel(EncOneArgs a) {
  extern __shared__ uint32_t tw_smem[];
  encrypt_one_limb(a, blockIdx.x, tw_smem);
}

__global__ void __launch_bounds__(1024) decrypt_limb_kernel(DecOneArgs a) {
  extern __shared__ uint32_t tw_smem[];
  decrypt_one_limb(a, blockIdx.x, tw_smem);
}

}  // namespace

extern "C" int encrypt_limbs_launch(
    const uint32_t *pt, const uint32_t *pk_b, const uint32_t *pk_a,
    const uint32_t *table, uint32_t *c0, uint32_t *c1, uint32_t *v_scratch,
    int batch, int n_limbs, int logn, int n_scalars, uint32_t seed0,
    uint32_t seed1, uint32_t seed2, uint32_t seed3, uint32_t nonce0,
    void *stream) {
  EncArgs a = {pt, pk_b, pk_a, table, c0, c1, v_scratch, n_limbs, logn,
               n_scalars, {seed0, seed1, seed2, seed3}, nonce0};
  const size_t smem = sizeof(uint32_t) << (logn - 1);  // one stage's twiddles
  static rt::SmemAllowance allowance;
  cudaError_t err =
      rt::allow_dynamic_smem(encrypt_folded_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  encrypt_folded_kernel<<<dim3(n_limbs, batch), 1024, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int decrypt_limbs_launch(const uint32_t *c0, const uint32_t *c1,
                                    long long row_stride,
                                    const uint32_t *s_mont,
                                    const uint32_t *table, uint32_t *m,
                                    int batch, int n_limbs, int logn,
                                    int n_scalars, void *stream) {
  DecArgs a = {c0, c1, row_stride, s_mont, table, m, n_limbs, logn,
               n_scalars};
  const size_t smem = sizeof(uint32_t) << (logn - 1);
  static rt::SmemAllowance allowance;
  cudaError_t err =
      rt::allow_dynamic_smem(decrypt_folded_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  decrypt_folded_kernel<<<dim3(n_limbs, batch), 1024, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int encrypt_limb_launch(
    const uint32_t *pt, const uint32_t *pk_b, const uint32_t *pk_a,
    const uint32_t *trow, const int32_t *sa, uint32_t *c0, uint32_t *c1,
    uint32_t *v_scratch, int batch, int logn, uint32_t seed0, uint32_t seed1,
    uint32_t seed2, uint32_t seed3, uint32_t nonce0, void *stream) {
  EncOneArgs a = {pt, pk_b, pk_a, trow, sa, c0, c1, v_scratch, logn,
                  {seed0, seed1, seed2, seed3}, nonce0};
  const size_t smem = sizeof(uint32_t) << (logn - 1);
  static rt::SmemAllowance allowance;
  cudaError_t err =
      rt::allow_dynamic_smem(encrypt_limb_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  encrypt_limb_kernel<<<batch, 1024, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int decrypt_limb_launch(const uint32_t *c0, const uint32_t *c1,
                                   const uint32_t *s_mont,
                                   const uint32_t *trow, const int32_t *sa,
                                   uint32_t *m, int batch, int logn,
                                   void *stream) {
  DecOneArgs a = {c0, c1, s_mont, trow, sa, m, logn};
  const size_t smem = sizeof(uint32_t) << (logn - 1);
  static rt::SmemAllowance allowance;
  cudaError_t err =
      rt::allow_dynamic_smem(decrypt_limb_kernel, smem, allowance);
  if (err != cudaSuccess) return (int)err;
  decrypt_limb_kernel<<<batch, 1024, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else  // host build of the same block bodies (one thread per block)

#include <vector>

extern "C" int encrypt_limbs_host(
    const uint32_t *pt, const uint32_t *pk_b, const uint32_t *pk_a,
    const uint32_t *table, uint32_t *c0, uint32_t *c1, uint32_t *v_scratch,
    int batch, int n_limbs, int logn, int n_scalars, uint32_t seed0,
    uint32_t seed1, uint32_t seed2, uint32_t seed3, uint32_t nonce0) {
  EncArgs a = {pt, pk_b, pk_a, table, c0, c1, v_scratch, n_limbs, logn,
               n_scalars, {seed0, seed1, seed2, seed3}, nonce0};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < n_limbs; ++l) encrypt_limb(a, l, b, tw_smem.data());
  return 0;
}

extern "C" int decrypt_limbs_host(const uint32_t *c0, const uint32_t *c1,
                                  long long row_stride,
                                  const uint32_t *s_mont,
                                  const uint32_t *table, uint32_t *m,
                                  int batch, int n_limbs, int logn,
                                  int n_scalars) {
  DecArgs a = {c0, c1, row_stride, s_mont, table, m, n_limbs, logn,
               n_scalars};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b)
    for (int l = 0; l < n_limbs; ++l) decrypt_limb(a, l, b, tw_smem.data());
  return 0;
}

extern "C" int encrypt_limb_host(
    const uint32_t *pt, const uint32_t *pk_b, const uint32_t *pk_a,
    const uint32_t *trow, const int32_t *sa, uint32_t *c0, uint32_t *c1,
    uint32_t *v_scratch, int batch, int logn, uint32_t seed0, uint32_t seed1,
    uint32_t seed2, uint32_t seed3, uint32_t nonce0) {
  EncOneArgs a = {pt, pk_b, pk_a, trow, sa, c0, c1, v_scratch, logn,
                  {seed0, seed1, seed2, seed3}, nonce0};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b) encrypt_one_limb(a, b, tw_smem.data());
  return 0;
}

extern "C" int decrypt_limb_host(const uint32_t *c0, const uint32_t *c1,
                                 const uint32_t *s_mont, const uint32_t *trow,
                                 const int32_t *sa, uint32_t *m, int batch,
                                 int logn) {
  DecOneArgs a = {c0, c1, s_mont, trow, sa, m, logn};
  std::vector<uint32_t> tw_smem((size_t)1 << (logn - 1));
  for (int b = 0; b < batch; ++b) decrypt_one_limb(a, b, tw_smem.data());
  return 0;
}

#endif
