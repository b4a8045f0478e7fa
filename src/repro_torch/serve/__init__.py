from repro_torch.serve.engine import (Request, ServeEngine, ServeTimeModel,  # noqa: F401
                                      StagedServeEngine)
from repro_torch.serve.disagg import (DisaggKV, KVStoreParams, PathCosts,  # noqa: F401
                                      PlacementPlan, kv_alternatives, kv_fabric,
                                      kv_serve_time_model, plan_decode_placement)
