from .train_step import (batch_to_device, make_embed_step, multitask_logits,
                         tile_tasks)

__all__ = ["batch_to_device", "make_embed_step", "multitask_logits",
           "tile_tasks"]
