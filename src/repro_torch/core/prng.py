"""Counter-based Philox-4x32-10 and the CKKS samplers, as plain PyTorch.

Port of ``repro.core.prng``. Every draw is a pure function of
``(seed, stream, word)`` and the element index, with the reference's
counter layout ``(index, stream, word ^ seed[2], seed[3])`` keyed by
``(seed[0], seed[1])`` — the port draws the reference's words exactly, on
any device. No ``torch.Generator`` is involved. Values are int64 tensors
holding uint32 words; the reference's mod-2^32 wraps are masked here.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul
from repro_torch.core.modmul import MASK32, MontgomeryConstants

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def seed_words(seed128: int) -> tuple[int, int, int, int]:
    """128-bit seed -> its four uint32 words, least significant first."""
    return tuple((seed128 >> (32 * i)) & MASK32 for i in range(4))


def philox_4x32(counter, key, rounds: int = 10):
    """counter: four int64 tensors (uint32 words); key: two Python ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = modmul.mul32x32(PHILOX_M0, c0)
        hi1, lo1 = modmul.mul32x32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def random_u32_rows(seed128: int, stream: torch.Tensor, n: int,
                    word: int) -> torch.Tensor:
    """(rows, n) uint32 draw (int64) of word `word`; `stream` is an int64
    (rows, 1) column of uint32 stream ids (one stream per row)."""
    parts = seed_words(seed128)
    idx = torch.arange(n, dtype=torch.int64, device=stream.device)
    z = torch.zeros((stream.shape[0], n), dtype=torch.int64,
                    device=stream.device)
    ctr = (z + idx, z + stream, z + (word ^ parts[2]), z + parts[3])
    return philox_4x32(ctr, (parts[0], parts[1]))[0]


def random_u32(seed128: int, stream: int, n: int, words: int = 1,
               device=None):
    """`words` independent uint32 arrays of length n for one stream id."""
    col = torch.full((1, 1), stream & MASK32, dtype=torch.int64,
                     device=device)
    outs = [random_u32_rows(seed128, col, n, w)[0] for w in range(words)]
    return outs if words > 1 else outs[0]


def _barrett_c(q: int) -> MontgomeryConstants:
    mu = (1 << (2 * q.bit_length())) // q
    return MontgomeryConstants(q=q, qinv_neg=0, r2=0, r1=0, mu=mu, p_bw=0,
                               n_plus_1=1, k_terms=())


def uniform_mod_q(seed128: int, stream: int, n: int, q: int, device=None):
    """~64 random bits reduced mod q, the reference's Barrett sequence."""
    hi, lo = random_u32(seed128, stream, n, words=2, device=device)
    c = _barrett_c(q)
    hi_red = modmul.mulmod_barrett_limb(hi, 1, c)
    t = modmul.mulmod_barrett_limb(hi_red, (1 << 32) % q, c)
    lo_red = modmul.mulmod_barrett_limb(lo, 1, c)
    return modmul.addmod(t, lo_red, q)


def uniform_mod_q_rows(seed128: int, streams, n: int, q_list,
                       device=None) -> torch.Tensor:
    """(rows, n) ``uniform_mod_q`` draws at once: row i draws stream
    streams[i] reduced mod q_list[i], the same words row by row."""
    rows = len(q_list)

    def col(values):
        return torch.tensor([int(v) for v in values], dtype=torch.int64,
                            device=device).reshape(rows, 1)

    stream = col(s & MASK32 for s in streams)
    q = col(q_list)
    mu = col((1 << (2 * int(qi).bit_length())) // int(qi) for qi in q_list)
    p = col(int(qi).bit_length() for qi in q_list)
    r_mod = col((1 << 32) % int(qi) for qi in q_list)
    hi = random_u32_rows(seed128, stream, n, 0)
    lo = random_u32_rows(seed128, stream, n, 1)
    hi_red = modmul.mulmod_barrett_t(hi, 1, q, mu, p)
    t = modmul.mulmod_barrett_t(hi_red, r_mod, q, mu, p)
    lo_red = modmul.mulmod_barrett_t(lo, 1, q, mu, p)
    return modmul.addmod(t, lo_red, q)


def ternary(seed128: int, stream: int, n: int, device=None):
    """Uniform {-1, 0, +1} secret (density 2/3), int32."""
    u = random_u32(seed128, stream, n, device=device)
    third = 0x55555555
    one = torch.ones_like(u)
    return torch.where(u < third, one, torch.where(
        u < 2 * third, -one, 0 * one)).to(torch.int32)


def zo_from_u32(u: torch.Tensor) -> torch.Tensor:
    """ZO(0.5) from one uint32 word: P(+1) = P(-1) = 1/4."""
    one = torch.ones_like(u)
    return torch.where(u < 1 << 30, one, torch.where(
        u < 1 << 31, -one, 0 * one)).to(torch.int32)


def zo(seed128: int, stream: int, n: int, device=None):
    return zo_from_u32(random_u32(seed128, stream, n, device=device))


def popcount21(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 21 bits (the reference's SWAR sequence; its
    final multiply wraps modulo 2^32)."""
    x = x & ((1 << 21) - 1)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def cbd_from_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Centered binomial (eta = 21) from two uint32 words, int32."""
    return (popcount21(a) - popcount21(b)).to(torch.int32)


def cbd(seed128: int, stream: int, n: int, eta: int = 21, device=None):
    """Centered binomial error: popcount(eta bits) - popcount(eta bits);
    the draw always takes 21 bits a word, as the reference's does."""
    assert eta <= 21
    a, b = random_u32(seed128, stream, n, words=2, device=device)
    return cbd_from_u32(a, b)


def signed_to_residue(x: torch.Tensor, q) -> torch.Tensor:
    """Signed int in (-q, q) -> int64 residue in [0, q); `q` a scalar or a
    broadcastable int64 tensor."""
    x = x.to(torch.int64)
    return (x % q + q) % q
