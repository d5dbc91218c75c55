"""FHE client service: request-coalescing batcher + dual-stream scheduler.

Port of ``repro.fhe_client.service``, the multi-process mesh included. The
servable engine over the batched client pipeline — per-message requests
coalesce into bucketed batch jobs, which the dual-stream scheduler executes on CUDA streams with
``core.scheduler``'s RSC mode policy (2xENC / 2xDEC / ENC+DEC), splitting
each job's rows across its stream's devices. ``ClientService.start()``
turns it always-on: a background dispatch loop (``service.runtime``) with
per-request max-wait deadlines, bounded-queue backpressure, and a
fault-injected failure story (``service.faults``: stream death -> bounded
retry on survivors under the same nonce lease -> graceful single-stream
degradation, all recorded in a structured event log). The wire format
(``service.wire``) is the reference's, byte for byte. ``MeshRouter``
(``service.mesh``) spreads the same service over worker processes
(``service.worker``), one ``ClientService`` each, behind a router that
leases every chunk's nonces centrally and speaks that wire format over
localhost TCP.
"""

from repro_torch.fhe_client.service import wire
from repro_torch.fhe_client.service.batcher import (CoalescingBatcher,
                                                    DEFAULT_BUCKETS, DecJob,
                                                    EncJob, Request)
from repro_torch.fhe_client.service.faults import (AllStreamsFailed,
                                                   EventLog, FaultInjector,
                                                   FaultSpec, RequestFailed,
                                                   ServiceEvent, StreamFault)
from repro_torch.fhe_client.service.scheduler import (DispatchRecord,
                                                      DualStreamScheduler,
                                                      StreamExecutor)
from repro_torch.fhe_client.service.service import (ClientService,
                                                    QueueFull,
                                                    lane_fingerprint)
from repro_torch.fhe_client.service.mesh import (ANON_LANE_ID,
                                                 AllWorkersFailed,
                                                 DEFAULT_LANE_ID, MeshError,
                                                 MeshRequestError,
                                                 MeshRouter,
                                                 RESERVED_LANE_IDS,
                                                 lane_wire_identity)
from repro_torch.fhe_client.tenancy import (KeyContextRegistry, NonceLease,
                                            NonceLedger, TenantSession,
                                            params_fingerprint, tenant_seed)
from repro_torch.telemetry import MeshTelemetry, ServiceTelemetry

__all__ = [
    "ANON_LANE_ID", "AllStreamsFailed", "AllWorkersFailed",
    "ClientService", "CoalescingBatcher", "DEFAULT_BUCKETS",
    "DEFAULT_LANE_ID", "DecJob", "DispatchRecord", "DualStreamScheduler",
    "EncJob", "EventLog", "FaultInjector", "FaultSpec",
    "KeyContextRegistry", "MeshError", "MeshRequestError", "MeshRouter",
    "MeshTelemetry", "NonceLease", "NonceLedger", "QueueFull",
    "RESERVED_LANE_IDS", "Request", "RequestFailed", "ServiceEvent",
    "ServiceTelemetry", "StreamFault", "StreamExecutor", "TenantSession",
    "lane_fingerprint", "lane_wire_identity", "params_fingerprint",
    "tenant_seed", "wire",
]
