from .losses import (TEXT_PROMPT_ROWS, TextProjector, cross_entropy_loss,
                     kd_kl_per_slide, kd_loss, l2_normalize, project_text,
                     survival_nll_loss)
from .state import (TrainOptimizer, freeze_backbone, make_optimizer,
                    warmup_cosine_epoch_schedule)
from .train_step import (batch_to_device, make_embed_step, make_eval_step,
                         make_grad_step, make_train_step, multitask_logits,
                         tile_tasks)

__all__ = [
    "TEXT_PROMPT_ROWS", "TextProjector", "TrainOptimizer", "batch_to_device",
    "cross_entropy_loss", "freeze_backbone", "kd_kl_per_slide", "kd_loss",
    "l2_normalize", "make_embed_step", "make_eval_step", "make_grad_step", "make_optimizer",
    "make_train_step", "multitask_logits", "project_text",
    "survival_nll_loss", "tile_tasks",
    "warmup_cosine_epoch_schedule",
]
