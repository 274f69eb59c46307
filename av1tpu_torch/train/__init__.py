"""Training of the port: losses, schedules and the partitioned AdamW,
augmentations, the trainer (steps and epochs), verified checkpoints, the
per-stage recipes with ``train_stage`` and the FGVC composite step. The
unified multi-task recipe is ``train.unified`` (it imports ``eval``, which
imports this package)."""
from av1tpu_torch.train.augment import get_augmentation, tta_views  # noqa: F401
from av1tpu_torch.train.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
    transplant_backbone,
)
from av1tpu_torch.train.fgvc_step import (  # noqa: F401
    create_fgvc_state,
    make_fgvc_eval_step,
    make_fgvc_train_step,
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
from av1tpu_torch.train.stages import (  # noqa: F401
    StageRecipe,
    flatten_recipe,
    stage1_recipe,
    stage2_recipe,
    stage3_ab_ensemble_recipe,
    stage3_ab_fgvc_recipe,
    stage3_rect_recipe,
    train_stage,
    v5_stage3_recipe,
)
from av1tpu_torch.train.trainer import (  # noqa: F401
    EpochResult,
    StepConfig,
    TrainState,
    make_eval_step,
    make_train_step,
)
