"""AdamW, LR schedules and int8 error-feedback gradient compression
(``optim.compression``), counterpart of ``repro.optim``."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
