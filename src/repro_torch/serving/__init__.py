"""Request-level serving (port of `repro/serving/`): continuous batching and
SLA-aware scheduling over the SiDA hash-ahead pipeline (request lifecycle,
admission queue, lane batcher, request server, telemetry), behind one
consolidated config object (`ServingConfig`).

The reference's names, less the multi-tenant front door's `TenantAdmission`
and `WFQScheduler`, which come with ROADMAP A13(b) (`TenantConfig` and
`parse_tenants` parse already; the server refuses tenants until then).
"""
from repro_torch.serving.config import (
    BatchingConfig,
    FaultToleranceConfig,
    ParallelServeConfig,
    PrefetchServeConfig,
    QuantServeConfig,
    ServingConfig,
    ServingConfigError,
    SpecServeConfig,
    TenantConfig,
    add_serving_args,
    parse_tenants,
)
from repro_torch.serving.request import Request, RequestState, poisson_requests
from repro_torch.serving.scheduler import (
    DEFAULT_BUCKETS,
    AdmissionController,
    LaneTable,
    Scheduler,
    bucket_len,
)
from repro_torch.serving.server import RequestServer
from repro_torch.serving.telemetry import Telemetry

__all__ = [
    # request lifecycle
    "Request",
    "RequestState",
    "poisson_requests",
    # scheduling
    "DEFAULT_BUCKETS",
    "AdmissionController",
    "LaneTable",
    "Scheduler",
    "bucket_len",
    # configuration
    "BatchingConfig",
    "FaultToleranceConfig",
    "ParallelServeConfig",
    "PrefetchServeConfig",
    "QuantServeConfig",
    "ServingConfig",
    "ServingConfigError",
    "SpecServeConfig",
    "TenantConfig",
    "add_serving_args",
    "parse_tenants",
    # server + telemetry
    "RequestServer",
    "Telemetry",
]
