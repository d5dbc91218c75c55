"""The client / server boundary of the port: the wire format
(``service.wire``), a byte-for-byte port of
``repro.fhe_client.service.wire``. The reference's batcher, scheduler and
runtime are not ported here."""

from repro_torch.fhe_client.service import wire

__all__ = ["wire"]
