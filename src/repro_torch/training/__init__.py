"""Training: AdamW, the train step, synthetic data, checkpoints."""
from repro_torch.training.checkpoint import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import (
    DataConfig,
    lm_batch,
    lm_batches,
    recall_batch,
    recall_batches,
    recall_example,
)
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    global_norm,
    init_adamw,
    lr_schedule,
)
from repro_torch.training.train_step import (
    batch_to_device,
    cross_entropy,
    loss_fn,
    make_train_step,
    train_step,
    value_and_grad,
)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_update", "global_norm", "init_adamw",
    "lr_schedule", "batch_to_device", "cross_entropy", "loss_fn",
    "make_train_step", "train_step", "value_and_grad", "DataConfig",
    "lm_batch", "lm_batches", "recall_batch", "recall_batches",
    "recall_example", "latest_step", "load_checkpoint", "save_checkpoint",
]
