"""Host constants and exact arithmetic of the CKKS client, as plain PyTorch.

Residues travel as ``torch.int64`` tensors holding uint32 values (torch on
the CPU has no uint32 add, sub, shift or compare); every place where the
JAX reference wraps modulo 2^32 masks with ``MASK32`` explicitly. At module
boundaries that a CUDA kernel also sees, residues are ``torch.int32`` tensors
holding the uint32 bit pattern (``u32_to_i64`` / ``i64_to_u32``).

The package exports the reference's names (``repro.core``).
"""

from repro_torch.core.context import CKKSContext, CKKSParams, PROFILES, get_context
from repro_torch.core.encoder import (
    Plaintext,
    PlaintextBatch,
    decode,
    decode_coeff,
    encode,
    encode_batch,
    boot_precision_bits,
)
from repro_torch.core.encryptor import (
    Ciphertext,
    CiphertextBatch,
    PublicKey,
    SecretKey,
    decrypt,
    encrypt,
    encrypt_symmetric_seeded,
    expand_seeded,
    keygen,
)

__all__ = [
    "CKKSContext", "CKKSParams", "PROFILES", "get_context",
    "Plaintext", "PlaintextBatch", "decode", "decode_coeff", "encode",
    "encode_batch", "boot_precision_bits",
    "Ciphertext", "CiphertextBatch", "PublicKey", "SecretKey",
    "decrypt", "encrypt", "encrypt_symmetric_seeded", "expand_seeded", "keygen",
]
