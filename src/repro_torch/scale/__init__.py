"""Million-user serving at simulation scale.

Three pieces on top of the serve/tenancy stack: trace-driven open-loop
arrival generation (``arrivals``), an SLO tenant fleet sharing one
FabricRuntime (``fleet``), and TTFT-attainment-driven decode
autoscaling (``autoscale``).
"""
from repro_torch.scale.arrivals import (ArrivalGenerator, Burst, LengthSpec,
                                        TraceSpec, burst_trace)
from repro_torch.scale.autoscale import (AutoscaleConfig, Autoscaler, ReplicaPool,
                                         ttft_attainment)
from repro_torch.scale.fleet import (FleetReport, FleetTenantSpec, ServeFleet,
                                     TenantReport, fleet_fabric, headline_fleet,
                                     headline_specs, replica_paths_of)

__all__ = [
    "ArrivalGenerator", "Burst", "LengthSpec", "TraceSpec", "burst_trace",
    "AutoscaleConfig", "Autoscaler", "ReplicaPool", "ttft_attainment",
    "FleetReport", "FleetTenantSpec", "ServeFleet", "TenantReport",
    "fleet_fabric", "headline_fleet", "headline_specs", "replica_paths_of",
]
