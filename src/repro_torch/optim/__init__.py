from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import lr_at  # noqa: F401
