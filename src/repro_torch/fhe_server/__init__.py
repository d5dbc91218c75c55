"""Server-side CKKS evaluator: additions, ct x pt and ct x ct with
rescale, rotations by hybrid key switching (hoisted where a rotation set
allows), the client's evaluation-key generation, plaintext encoding, and
the encrypted linear layer + degree-3 polynomial."""
