"""Training of the port: losses, schedules and the partitioned AdamW,
augmentations, the trainer (steps and epochs), verified checkpoints, and the
per-stage recipes with ``train_stage``."""
from av1tpu_torch.train.augment import get_augmentation, tta_views  # noqa: F401
from av1tpu_torch.train.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
    transplant_backbone,
)
from av1tpu_torch.train.losses import get_loss_function  # noqa: F401
from av1tpu_torch.train.schedules import (  # noqa: F401
    adamw,
    cosine_schedule,
    onecycle_schedule,
    partitioned_optimizer,
    ulmfit_phase1,
    ulmfit_phase2,
)
from av1tpu_torch.train.stages import StageRecipe, train_stage  # noqa: F401
from av1tpu_torch.train.trainer import (  # noqa: F401
    EpochResult,
    StepConfig,
    TrainState,
    make_eval_step,
    make_train_step,
)
