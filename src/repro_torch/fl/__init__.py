"""repro_torch.fl — the event-driven asynchronous federated runtime of
the port (``repro/fl`` without ``cohorts``, which needs the sharded
trainer).

Layout:
    events.py       deterministic virtual-time event queue (a copy)
    latency.py      per-client latency models and Poisson availability
                    windows (a copy)
    staleness.py    staleness-weight policies and hop composition (a copy)
    server.py       AsyncDashaServer: buffered first-K, staleness-aware
                    DASHA-PP whose commit runs the buffered-commit kernel
    client_store.py out-of-core per-client tracker store, chunked by edge
                    (a copy: numpy / memmap backends)
    tree.py         HierarchicalFleet: the edge-aggregator tree over the
                    dense workload
"""
from repro_torch.fl.client_store import BACKENDS, ClientStore, edge_partition
from repro_torch.fl.events import (ARRIVAL, DROP, REJOIN, TIER_ARRIVAL, Event,
                                   EventQueue)
from repro_torch.fl.latency import (ConstantLatency, JobTiming, LatencyModel,
                                    LognormalLatency, PoissonAvailability,
                                    make_latency)
from repro_torch.fl.server import AsyncConfig, AsyncDashaServer, AsyncRunResult
from repro_torch.fl.staleness import (STALENESS_POLICIES, AdaptiveStaleness,
                                      PowerLawStaleness, StalenessPolicy,
                                      compose_hops, make_staleness)
from repro_torch.fl.tree import (CommitRecord, DenseProblemWorkload,
                                 FleetConfig, FleetDispatch, FleetRunResult,
                                 FleetState, FleetWorkload, HierarchicalFleet,
                                 MessageRecord, TierConfig, payload_bits)

__all__ = [
    "ARRIVAL", "DROP", "REJOIN", "TIER_ARRIVAL", "Event", "EventQueue",
    "ConstantLatency", "JobTiming", "LatencyModel", "LognormalLatency",
    "PoissonAvailability", "make_latency",
    "AsyncConfig", "AsyncDashaServer", "AsyncRunResult",
    "STALENESS_POLICIES", "AdaptiveStaleness", "PowerLawStaleness",
    "StalenessPolicy", "compose_hops", "make_staleness",
    "BACKENDS", "ClientStore", "edge_partition",
    "CommitRecord", "DenseProblemWorkload", "FleetConfig",
    "FleetDispatch", "FleetRunResult", "FleetState", "FleetWorkload",
    "HierarchicalFleet", "MessageRecord", "TierConfig", "payload_bits",
]
