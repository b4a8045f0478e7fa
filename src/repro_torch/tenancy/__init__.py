"""Multi-tenant colocation: QoS-weighted fabric sharing, the serve+train
interference harness, and SLO-driven admission control (paper §6)."""
from repro_torch.tenancy.admission import (AdmissionConfig, AdmissionController,
                                           AdmittedTenant,
                                           FleetAdmissionController, percentile)
from repro_torch.tenancy.colocation import (Colocation, InterferenceReport,
                                            colocation_fabric,
                                            colocation_time_model,
                                            occupancy_ledger, serve_metrics,
                                            solo_serve, solo_train)
from repro_torch.tenancy.qos import (LATENCY, SERVE, THROUGHPUT, TRAIN, QoSPolicy,
                                     Tenant)

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmittedTenant", "Colocation",
    "FleetAdmissionController", "InterferenceReport", "LATENCY", "QoSPolicy",
    "SERVE", "THROUGHPUT", "TRAIN", "Tenant", "colocation_fabric",
    "colocation_time_model", "occupancy_ledger", "percentile",
    "serve_metrics", "solo_serve", "solo_train",
]
