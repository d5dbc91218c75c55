"""Private inference: the FHE client wrapping an LM server (paper Fig. 1).

Port of the model half of ``examples/secure_inference.py`` (its default
and ``--direct`` modes; ``--encrypted`` is
``repro_torch.fhe_server.encrypted_inference``):

    PYTHONPATH=src python -m repro_torch.fhe_client.private_inference \
        [--direct] [--device cpu]

The client boundary runs through the client SERVICE by default: prompt
embeddings are submitted as per-message requests, the coalescing batcher
forms bucketed jobs, the scheduler runs them (K5 / K6 on the card), and
ciphertexts and results cross the trust boundary as wire payloads.
``--direct`` calls the ``FHEClient`` batched entry points directly. The
server boundary is simulated (decrypt, run the LM, re-encrypt): the stand-in
server is one ``prefill`` of the port's model over the decrypted
embeddings, with M-RoPE positions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.fhe_client.client import (FHEClient,
                                           simulate_private_inference)
from repro_torch.fhe_client.service import ClientService, wire
from repro_torch.models import model as M
from repro_torch.models.archs import get_arch, reduced_config

ROUNDTRIP_BOUND = 1e-4      # the reference's assert on the input round trip


def simulate_private_inference_service(service: ClientService, serve_fn,
                                       x: np.ndarray, out_features: int):
    """The ``simulate_private_inference`` loop routed through the service:
    per-message submit -> coalesced/bucketed jobs -> wire payloads across
    the trust boundary -> decrypt requests for the returned results."""
    client = service.client
    msgs = client.pack(x)
    cts = service.encrypt_many(msgs)
    payload = wire.serialize_ciphertext_batch(cts)     # client -> server

    # --- server boundary (simulated; see module docstring) -----------------
    dev = client.device
    server_cts = wire.deserialize_ciphertext_batch(payload,
                                                   device=dev).truncated(2)
    served_inputs = service.decrypt_many(server_cts)
    x_rec = client.unpack(served_inputs, x.shape[1])
    y = serve_fn(x_rec.astype(np.float32))
    y_cts = service.encrypt_many(client.pack(y.astype(np.float64)))
    returned = wire.serialize_ciphertext_batch(y_cts.truncated(2))
    # ------------------------------------------------------------------------

    y_dec = service.decrypt_many(wire.deserialize_ciphertext_batch(
        returned, device=dev))
    return client.unpack(y_dec, out_features), {
        "roundtrip_err": float(np.max(np.abs(x_rec - x))),
        "upload_bytes": len(payload),
        "download_bytes": len(returned),
    }


def make_serve_fn(params, cfg, batch: int, seq: int, device, timings=None):
    """Stand-in server: embeds -> one LM forward -> the last position's
    first d_model logits / 10. ``timings`` (a list) gets each call's
    seconds, host clock ending in a device synchronize."""
    dev = torch.device(device)
    mrope = torch.arange(seq, device=dev)[None, :, None].expand(
        batch, seq, 3).to(torch.int32)

    def serve_fn(x_rows: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        embeds = torch.as_tensor(
            x_rows.reshape(batch, seq, cfg.d_model), dtype=torch.float32,
            device=dev)
        lg, _ = M.prefill(params, {"embeds": embeds, "mrope_pos": mrope},
                          cfg, cache_len=seq, q_chunk=16, kv_chunk=16)
        out = lg.float()[:, 0, : cfg.d_model].cpu().numpy()
        if timings is not None:
            timings.append(time.perf_counter() - t0)
        return out.reshape(batch, cfg.d_model) / 10.0

    return serve_fn


def run(arch_cfg, profile, *, direct: bool = False, batch: int = 2,
        seq: int = 16, seed: int = 0, device=None, client=None):
    """The private-inference loop on ``device`` (the card when None):
    random params from ``seed``, inputs x (batch, seq * d_model) from
    ``seed + 1``, an ``FHEClient(profile)`` (or ``client``), through the
    service with buckets (1, 2, 4, 8) or, with ``direct``, the client's
    batched path. Returns (y, stats): the reference's stats
    (``roundtrip_err``; through the service also the wire bytes up and
    down, the service's jobs by kind) and the seconds of the loop and of
    each server call."""
    dev = M.resolve_device(device, "private_inference.run")
    params = M.init_params(arch_cfg, torch.Generator(device=dev)
                           .manual_seed(seed), device=dev)
    if client is None:
        client = FHEClient(profile, device=dev)
    serve_s: list = []
    serve_fn = make_serve_fn(params, arch_cfg, batch, seq, dev, serve_s)
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, seq * arch_cfg.d_model)) * 0.1
    t0 = time.perf_counter()
    if direct:
        y, stats = simulate_private_inference(client, serve_fn, x,
                                              out_features=arch_cfg.d_model)
    else:
        service = ClientService(client=client, buckets=(1, 2, 4, 8))
        y, stats = simulate_private_inference_service(
            service, serve_fn, x, out_features=arch_cfg.d_model)
        stats["service"] = service.stats()
        stats["jobs"] = {kind: sum(rec.kind == kind
                                   for rec in service.dispatch_log)
                         for kind in ("enc", "dec")}
    stats["loop_s"] = time.perf_counter() - t0
    stats["serve_s"] = serve_s
    return y, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--direct", action="store_true",
                    help="call the FHEClient batched path directly instead "
                         "of going through the client service")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = reduced_config(get_arch("qwen2-vl-2b"))
    client = FHEClient("test", device=M.resolve_device(args.device,
                                                        "private_inference"))
    print(f"model: {cfg.name}  d_model={cfg.d_model}")
    print(f"CKKS: N=2^{client.ctx.params.logn}, "
          f"{client.ctx.params.n_limbs} limbs")
    batch = 2
    y, stats = run(cfg, "test", direct=args.direct, batch=batch,
                   device=args.device, client=client)
    if args.direct:
        print("client boundary: direct FHEClient batched path")
    else:
        st = stats["service"]
        print(f"client boundary: service ({st['n_streams']} stream(s), "
              f"{st['shards_per_stream']} shard(s)/stream, "
              f"buckets {st['buckets']})")
        print(f"service dispatched {st['jobs_dispatched']} jobs over "
              f"{st['rounds']} rounds; modes: {','.join(st['modes'][:8])}"
              f"{'...' if len(st['modes']) > 8 else ''}")
        print(f"wire payloads: {stats['upload_bytes'] / 1e3:.1f} KB up, "
              f"{stats['download_bytes'] / 1e3:.1f} KB down")
    rep = client.upload_report(batch)
    print(f"client->server ciphertext: {rep['ct_bytes'] / 1e3:.1f} KB "
          f"({rep['ct_bytes_seeded'] / 1e3:.1f} KB seeded, "
          f"{rep['compression']:.2f}x compression)")
    print(f"input round-trip error through FHE: {stats['roundtrip_err']:.2e}")
    print(f"served output shape: {y.shape}")
    if not stats["roundtrip_err"] < ROUNDTRIP_BOUND:
        raise SystemExit(f"round-trip error {stats['roundtrip_err']} >= "
                         f"{ROUNDTRIP_BOUND}")
    print("OK — private-inference loop verified")
    return y, stats


if __name__ == "__main__":
    main()
