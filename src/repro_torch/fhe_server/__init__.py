"""Server-side CKKS evaluator: additions, ct x pt and ct x ct with
rescale, rotations by hybrid key switching (hoisted where a rotation set
allows), the client's evaluation-key generation, plaintext encoding, and
the encrypted linear layer + degree-3 polynomial. The package exports the
reference's names (``repro.fhe_server``)."""

from repro_torch.fhe_server.ct import (ServerCiphertext, ServerPlaintext,
                                       combined_scale)
from repro_torch.fhe_server.encoding import encode_plaintext, encode_scalar
from repro_torch.fhe_server.eval_ops import ServerEvaluator
from repro_torch.fhe_server.keys import (EvaluationKeys, KeySwitchKey,
                                        galois_element, galois_perm_ntt,
                                        make_evaluation_keys)

__all__ = [
    "ServerCiphertext", "ServerPlaintext", "ServerEvaluator",
    "EvaluationKeys", "KeySwitchKey", "combined_scale",
    "encode_plaintext", "encode_scalar",
    "galois_element", "galois_perm_ntt", "make_evaluation_keys",
]
