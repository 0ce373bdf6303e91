"""AdamW and LR schedules, counterpart of ``repro.optim``.  Gradient
compression (``repro.optim.compression``, ``int8_ef``) is not ported."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
