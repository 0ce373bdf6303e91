"""Training: loss, train step, trainer — counterpart of ``repro.train``."""
from repro_torch.train.step import (  # noqa: F401
    batch_specs,
    init_train_state,
    make_loss_fn,
    make_train_step,
    train_state_specs,
    value_and_grad,
)
