"""ModalTune in PyTorch for one NVIDIA H100: the port of ``modaltune_tpu``.

The JAX package stays the reference; this package computes the same
functions with ``torch`` and hand-written CUDA kernels (``csrc/``) where
the JAX package has Pallas kernels. It imports nothing of the JAX
package and never ``jax``: ``configs``, ``data`` and
``utils.params_io`` are its own copies of the JAX package's
framework-free layers (the data layer without its file readers so
far). Its entry points (``create_aggregator``,
``train.batch_to_device``) work on the GPU unless the caller asks for
the CPU.

So far it runs ModalTune-GigaPath (``longnetvit_gene_adapter`` and its
clinical variant) and ModalTune-TITAN (``titan_gene_adapter`` and its
clinical variant): the embed step, and the train step (KD loss, AdamW on
the Modal Adapter, gradients through the frozen backbone), with the eval
and grad steps beside it.
"""

from .models import (ModalTuneModel, TitanModalTuneModel, create_aggregator,
                     dropout_generator, init_weights)
from .train import (TextProjector, freeze_backbone, kd_loss, make_embed_step,
                    make_eval_step, make_grad_step, make_optimizer,
                    make_train_step, multitask_logits, project_text,
                    tile_tasks)
from .utils import params_from_jax, projector_from_jax

__version__ = "0.3.0"

__all__ = ["ModalTuneModel", "TextProjector", "TitanModalTuneModel",
           "create_aggregator", "dropout_generator", "freeze_backbone",
           "init_weights", "kd_loss", "make_embed_step", "make_eval_step",
           "make_grad_step", "make_optimizer", "make_train_step",
           "multitask_logits", "params_from_jax", "project_text",
           "projector_from_jax", "tile_tasks"]
