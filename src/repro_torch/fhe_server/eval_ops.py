"""ServerEvaluator: the server-side CKKS op set.

Port of ``repro.fhe_server.eval_ops``. Each op is one call of
``kernels.ops.server_*``: the CUDA kernel (``csrc/server_eval.cu``) for
tensors on the card, its plain PyTorch version on the CPU. The evaluator
owns:

  * the level and scale bookkeeping: additions require matching scales,
    multiplies combine scales in exact rational arithmetic
    (``ct.combined_scale``), rescales divide by the dropped prime;
  * the per-level key slices: evaluation keys are generated once at full L;
    at level l the kernels see rows [0:l] + the special row (a contiguous
    copy, made once per key and level);
  * the per-rotation NTT permutations, (1, N) int32 on the keys' device.

``datapath`` is the reference's label of the pointwise REDC engine of the
ops that multiply: ``'df32'`` (the default) the uint32 REDC, ``'f64'`` the
u64 REDC (``modmul.mulmod_montgomery_u64_t``). Both give the same words.
The plain versions (CPU tensors) run the engine it names; the kernels run
the u64 REDC on both.
"""

from __future__ import annotations

import torch

from repro_torch.core.context import CKKSContext
from repro_torch.fhe_server import keys as keysmod
from repro_torch.fhe_server.ct import (ServerCiphertext, ServerPlaintext,
                                       combined_scale)
from repro_torch.kernels import common as kcommon
from repro_torch.kernels import ops as kops



def _scales_match(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-9 * max(abs(a), abs(b))


class ServerEvaluator:
    """Evaluator bound to (context, evaluation keys). Ciphertexts, keys and
    plaintexts must lie on one device; the kernels run where they lie."""

    def __init__(self, ctx: CKKSContext,
                 eval_keys: "keysmod.EvaluationKeys | None" = None,
                 datapath: str = "df32"):
        kcommon.check_datapath(datapath)
        self.ctx = ctx
        self.keys = eval_keys
        self.datapath = datapath
        self._key_slices: dict = {}
        self._perms: dict = {}

    # -- caches -------------------------------------------------------------

    def _sliced_key(self, ksk: "keysmod.KeySwitchKey", level: int):
        """(L, L+1, N) full-L key -> (l, l+1, N) rows [0:l] + P."""
        ck = (id(ksk), level)
        if ck not in self._key_slices:
            L = self.ctx.params.n_limbs
            if level == L:
                self._key_slices[ck] = (ksk.b_mont, ksk.a_mont)
            else:
                idx = torch.tensor(list(range(level)) + [L],
                                   device=ksk.b_mont.device)
                self._key_slices[ck] = (
                    ksk.b_mont[:level].index_select(1, idx).contiguous(),
                    ksk.a_mont[:level].index_select(1, idx).contiguous())
        return self._key_slices[ck]

    def _perm(self, rn: int, device):
        key = (rn, str(device))
        if key not in self._perms:
            g = keysmod.galois_element(rn, self.ctx.n)
            perm = keysmod.galois_perm_ntt(g, self.ctx.n).reshape(1, -1)
            self._perms[key] = torch.from_numpy(perm).to(device)
        return self._perms[key]

    def _rot_key(self, rn: int, level: int):
        if self.keys is None or rn not in self.keys.rot:
            have = self.keys.rotations if self.keys else ()
            raise KeyError(f"no rotation key for r={rn} (have {have})")
        return self._sliced_key(self.keys.rot[rn], level)

    def _q_drop(self, level: int) -> int:
        return self.ctx.q_list[level - 1]

    # -- additions ----------------------------------------------------------

    def add_ct(self, x: ServerCiphertext, y: ServerCiphertext):
        lvl = min(x.level, y.level)
        x, y = x.drop_to(lvl), y.drop_to(lvl)
        assert _scales_match(x.scale, y.scale), (x.scale, y.scale)
        c0, c1 = kops.server_add_ct(x.c0, x.c1, y.c0, y.c1, self.ctx)
        return ServerCiphertext(c0, c1, lvl, x.scale)

    def add_pt(self, x: ServerCiphertext, pt: ServerPlaintext):
        assert pt.level == x.level and pt.data.ndim == 2
        assert _scales_match(x.scale, pt.scale), (x.scale, pt.scale)
        c0, c1 = kops.server_add_pt(x.c0, x.c1, pt.data, self.ctx)
        return ServerCiphertext(c0, c1, x.level, x.scale)

    # -- multiplies / rescale -----------------------------------------------

    def mul_pt(self, x: ServerCiphertext, pt: ServerPlaintext,
               rescale: bool = True):
        """ct x pt, fused with the rescale that follows unless `rescale` is
        False (accumulate products first, rescale once)."""
        assert pt.level == x.level and pt.data.ndim == 2
        c0, c1 = kops.server_mul_pt(x.c0, x.c1, pt.data_mont, self.ctx,
                                    rescale=rescale, datapath=self.datapath)
        if rescale:
            return ServerCiphertext(
                c0, c1, x.level - 1,
                combined_scale(x.scale, pt.scale,
                               divisor=self._q_drop(x.level)))
        return ServerCiphertext(c0, c1, x.level,
                                combined_scale(x.scale, pt.scale))

    def rescale(self, x: ServerCiphertext):
        assert x.level >= 3, "rescale below the 2-limb decrypt floor"
        c0, c1 = kops.server_rescale(x.c0, x.c1, self.ctx,
                                     datapath=self.datapath)
        return ServerCiphertext(
            c0, c1, x.level - 1,
            combined_scale(x.scale, divisor=self._q_drop(x.level)))

    def mul_ct(self, x: ServerCiphertext, y: ServerCiphertext):
        assert self.keys is not None and self.keys.relin is not None, \
            "ct x ct needs a relinearization key"
        lvl = min(x.level, y.level)
        x, y = x.drop_to(lvl), y.drop_to(lvl)
        kb, ka = self._sliced_key(self.keys.relin, lvl)
        c0, c1 = kops.server_mul_ct(x.c0, x.c1, y.c0, y.c1, kb, ka, self.ctx,
                                    datapath=self.datapath)
        scale = combined_scale(x.scale, y.scale, divisor=self._q_drop(lvl))
        return ServerCiphertext(c0, c1, lvl - 1, scale)

    # -- rotations ----------------------------------------------------------

    def rotate(self, x: ServerCiphertext, r: int):
        """Slot left-rotation by r (scale and level unchanged): the fused
        key switch (K10)."""
        rn = int(r) % self.ctx.params.n_slots
        if rn == 0:
            return x
        kb, ka = self._rot_key(rn, x.level)
        c0, c1 = kops.server_rotate(x.c0, x.c1, self._perm(rn, x.c0.device),
                                    kb, ka, self.ctx, datapath=self.datapath)
        return ServerCiphertext(c0, c1, x.level, x.scale)

    def hoisted_rotations(self, x: ServerCiphertext, rotations):
        """{r: rotate(x, r)} with the key-switch decomposition computed once
        (K11a) and applied per rotation (K11b)."""
        rns_ = [int(r) % self.ctx.params.n_slots for r in rotations]
        out = {}
        need = [rn for rn in dict.fromkeys(rns_) if rn != 0]
        if need:
            h = kops.server_ks_decompose(x.c1, self.ctx)
            for rn in need:
                kb, ka = self._rot_key(rn, x.level)
                c0, c1 = kops.server_ks_apply_rot(
                    x.c0, h, self._perm(rn, x.c0.device), kb, ka, self.ctx,
                    datapath=self.datapath)
                out[rn] = ServerCiphertext(c0, c1, x.level, x.scale)
        for r, rn in zip(rotations, rns_):
            out[r] = x if rn == 0 else out[rn]
        return out



