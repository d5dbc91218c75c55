"""Encrypted linear algebra on top of the op set: the workload layer.

Port of ``repro.fhe_server.inference``. ``encrypted_matvec`` is the
diagonal (Halevi-Shoup) method: y = sum_u diag_u(W) * rot_u(x). The input
vector is replicated across slot blocks (d must divide n_slots), so the
global slot rotation is the per-block rotation. All d-1 rotations share one
hoisted key-switch decomposition (K11a once, K11b per rotation); the d
products (K7) accumulate before the single rescale (K8), and the diagonals
are encoded at the dropped prime so the output scale returns to exactly the
input scale.

``encrypted_poly3`` evaluates c0 + c1 x + c2 x^2 + c3 x^3 by Horner: one
ct x pt with its fused rescale (K8b) and two ct x ct multiplies (K9), the
constants encoded at exactly the running scale. With the matvec it takes 4
levels: the encrypted-inference block ``fhe_server.encrypted_inference``
runs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.fhe_server import encoding
from repro_torch.fhe_server.ct import ServerCiphertext
from repro_torch.fhe_server.eval_ops import ServerEvaluator


def replicate_slots(x: np.ndarray, n_slots: int) -> np.ndarray:
    """(d,) real vector -> (n_slots,) block-replicated complex slots."""
    d = x.shape[-1]
    assert n_slots % d == 0, (d, n_slots)
    return np.tile(np.asarray(x, np.float64),
                   n_slots // d).astype(np.complex128)


def matvec_rotations(d: int) -> list:
    return list(range(1, d))


def encrypted_matvec(ev: ServerEvaluator, ct: ServerCiphertext,
                     w: np.ndarray, bias: np.ndarray | None = None
                     ) -> ServerCiphertext:
    """W @ x (+ bias) on a block-replicated ciphertext. Takes 1 level; the
    output scale equals the input scale exactly."""
    d = w.shape[0]
    assert w.shape == (d, d)
    ns = ev.ctx.params.n_slots
    assert ns % d == 0, f"d={d} must divide n_slots={ns}"
    q_drop = float(ev.ctx.q_list[ct.level - 1])
    idx = np.arange(ns)
    dev = ct.c0.device

    rotated = ev.hoisted_rotations(ct, matvec_rotations(d))
    acc = None
    for u in range(d):
        diag = w[idx % d, (idx + u) % d].astype(np.complex128)
        pt = encoding.encode_plaintext(diag, ev.ctx, ct.level, q_drop,
                                       device=dev)
        term = ev.mul_pt(ct if u == 0 else rotated[u], pt, rescale=False)
        acc = term if acc is None else ev.add_ct(acc, term)
    acc = ev.rescale(acc)
    if bias is not None:
        bt = np.asarray(bias, np.float64)[idx % d].astype(np.complex128)
        acc = ev.add_pt(acc, encoding.encode_plaintext(
            bt, ev.ctx, acc.level, acc.scale, device=dev))
    return acc


def encrypted_poly3(ev: ServerEvaluator, ct: ServerCiphertext,
                    coeffs) -> ServerCiphertext:
    """c0 + c1 x + c2 x^2 + c3 x^3 by Horner; takes 3 levels."""
    c0, c1, c2, c3 = (float(c) for c in coeffs)
    q_drop = float(ev.ctx.q_list[ct.level - 1])
    dev = ct.c0.device
    t = ev.mul_pt(ct, encoding.encode_scalar(c3, ev.ctx, ct.level, q_drop,
                                             device=dev))
    t = ev.add_pt(t, encoding.encode_scalar(c2, ev.ctx, t.level, t.scale,
                                            device=dev))
    t = ev.mul_ct(t, ct.drop_to(t.level))
    t = ev.add_pt(t, encoding.encode_scalar(c1, ev.ctx, t.level, t.scale,
                                            device=dev))
    t = ev.mul_ct(t, ct.drop_to(t.level))
    t = ev.add_pt(t, encoding.encode_scalar(c0, ev.ctx, t.level, t.scale,
                                            device=dev))
    return t


def encrypted_linear_poly3(ev: ServerEvaluator, ct: ServerCiphertext,
                           w: np.ndarray, bias: np.ndarray,
                           poly) -> ServerCiphertext:
    """poly3(W @ x + b), the encrypted inference block (4 levels)."""
    return encrypted_poly3(ev, encrypted_matvec(ev, ct, w, bias), poly)


def reference_linear_poly3(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                           poly) -> np.ndarray:
    """The plaintext model the encrypted path must match."""
    c0, c1, c2, c3 = (float(c) for c in poly)
    y = w @ np.asarray(x, np.float64) + np.asarray(bias, np.float64)
    return c0 + c1 * y + c2 * y ** 2 + c3 * y ** 3
