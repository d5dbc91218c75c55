"""Dispatch seam between the CUDA kernels and their plain versions.

A CUDA tensor goes to the CUDA kernel, a CPU tensor to the plain PyTorch
version; any other device raises. There is no fall-back: a CUDA input whose
kernel cannot be built or launched raises.
"""

from __future__ import annotations

from repro_torch.core.context import CKKSContext
from repro_torch.kernels import client_stream


def _route(device) -> str:
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {device}")


def encode_encrypt_stream(planes, pk_b_mont, pk_a_mont, ctx: CKKSContext,
                          seed: int, nonce0: int):
    """Four (B, n_slots) float32 slot planes -> (c0, c1) (B, L, N) int32."""
    if _route(planes[0].device) == "cuda":
        return client_stream.encode_encrypt_stream_cuda(
            planes, pk_b_mont, pk_a_mont, ctx, seed, nonce0)
    return client_stream.encode_encrypt_stream_plain(
        planes, pk_b_mont, pk_a_mont, ctx, seed, nonce0)


def decrypt_decode_stream(c0, c1, s_mont, ctx: CKKSContext, scale):
    """(B, >=2, N) int32 ciphertext stacks -> four (B, n_slots) planes."""
    if _route(c0.device) == "cuda":
        return client_stream.decrypt_decode_stream_cuda(c0, c1, s_mont, ctx,
                                                        scale)
    return client_stream.decrypt_decode_stream_plain(c0, c1, s_mont, ctx,
                                                     scale)
