"""Level- and scale-tracking server-side ciphertext and plaintext containers.

Port of ``repro.fhe_server.ct``. Server-side evaluation needs exact level
and scale accounting: every rescale divides the scale by the dropped prime
and every multiply multiplies scales. ``ServerCiphertext`` pins both and the
evaluator asserts the bookkeeping (``eval_ops``). The scale is stored as a
float, but every update goes through exact ``Fraction`` arithmetic and is
rounded once (``combined_scale``), so a matvec whose diagonals are encoded
at the dropped prime returns to exactly the input scale.

``drop_to`` is the free RNS mod-switch: keeping the first l' limbs is exact
(Q_l' divides Q_l; the scale is unchanged). Tensors are int32 holding the
uint32 words, (B, level, N), NTT domain.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch

from repro_torch.core.encryptor import CiphertextBatch


def combined_scale(*factors, divisor: int = 1) -> float:
    """prod(factors) / divisor in Fractions (a float is an exact rational),
    rounded to float once at the end."""
    acc = Fraction(1)
    for f in factors:
        acc *= Fraction(f)
    return float(acc / divisor)


@dataclasses.dataclass(frozen=True)
class ServerCiphertext:
    """(B, level, N) NTT-domain RLWE pair with its level and scale."""

    c0: torch.Tensor
    c1: torch.Tensor
    level: int                 # live limb count (rescale drops the last)
    scale: float

    def __post_init__(self):
        assert self.c0.ndim == 3 and self.c0.shape == self.c1.shape
        assert self.c0.shape[1] == self.level, \
            f"limb axis {self.c0.shape[1]} != level {self.level}"

    @property
    def batch(self) -> int:
        return int(self.c0.shape[0])

    @property
    def n(self) -> int:
        return int(self.c0.shape[2])

    @classmethod
    def from_batch(cls, cb: CiphertextBatch) -> "ServerCiphertext":
        return cls(c0=cb.c0, c1=cb.c1, level=cb.n_limbs, scale=cb.scale)

    def to_batch(self) -> CiphertextBatch:
        return CiphertextBatch(c0=self.c0, c1=self.c1, n_limbs=self.level,
                               scale=self.scale)

    def drop_to(self, level: int) -> "ServerCiphertext":
        """Exact mod-switch by limb truncation (scale unchanged); a view."""
        assert 2 <= level <= self.level, (level, self.level)
        if level == self.level:
            return self
        return ServerCiphertext(c0=self.c0[:, :level], c1=self.c1[:, :level],
                                level=level, scale=self.scale)


@dataclasses.dataclass(frozen=True)
class ServerPlaintext:
    """Server-side encoded plaintext at any scale and level: ``data``
    (level, N) plain NTT residues (ct + pt), ``data_mont`` its Montgomery
    form (ct x pt: one REDC per product); int32 tensors."""

    data: torch.Tensor
    data_mont: torch.Tensor
    level: int
    scale: float

    def __post_init__(self):
        assert self.data.shape[-2] == self.level
