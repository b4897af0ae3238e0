"""Stage-1 one-shot tuning: the trainable subset, the optimizer and train
step, and checkpoints."""

from videop2p_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from videop2p_tpu_torch.train.masking import (
    DEFAULT_TRAINABLE,
    count_params,
    merge_params,
    partition_params,
    trainable_mask,
)
from videop2p_tpu_torch.train.tuner import (
    ClippedAdamW,
    TrainState,
    TuneConfig,
    make_lr_schedule,
    make_optimizer,
    step_generator,
    train_step,
    train_steps,
)

__all__ = ["DEFAULT_TRAINABLE", "count_params", "merge_params", "partition_params",
           "trainable_mask", "ClippedAdamW", "TrainState", "TuneConfig",
           "make_lr_schedule", "make_optimizer", "step_generator", "train_step",
           "train_steps", "latest_checkpoint", "restore_checkpoint", "save_checkpoint"]
