"""ModalTune in PyTorch for one NVIDIA H100: the port of ``modaltune_tpu``.

The JAX package stays the reference; this package computes the same
functions with ``torch`` and hand-written CUDA kernels (``csrc/``) where
the JAX package has Pallas kernels. It imports nothing of the JAX
package and never ``jax``, nor sklearn or pandas: ``configs``, ``data``,
``eval.readout`` and ``utils`` are its own copies of the JAX package's
framework-free layers (the readout's fits and metrics rebuilt on numpy).
Its entry points (``create_aggregator``, ``train.batch_to_device``,
``ModalTuneTrainer``, ``python -m modaltune_tpu_torch.tools.train``) work
on the GPU unless the caller asks for the CPU.

It runs ModalTune-GigaPath (``longnetvit_gene_adapter`` and its clinical
variant) and ModalTune-TITAN (``titan_gene_adapter`` and its clinical
variant), single-site and pan-cancer: the file readers of the reference's
formats, the embed, train, eval and grad steps, the trainers (KD training,
in-loop LogReg/CoxPH readout, per site for pan-cancer, best weights,
checkpoint and resume, deploy, k-fold) and the train CLI; and the
supervised baselines (ABMIL, TransMIL and the gene-only model, in
classifier or survival mode, with the gene mixer's "(cat)" fusion) with
their trainers.
"""

from .data import (FeatureBagDataset, load_embedding_dict, load_feature_bag,
                   load_gene_csv, load_split_json, pathway_gene_groups)
from .eval.readout import (CoxPH, classification_metrics, concordance_index,
                           fit_logreg, perform_testing, roc_curve_points)
from .models import (ModalTuneModel, TitanModalTuneModel, create_aggregator,
                     dropout_generator, init_weights)
from .train import (TextProjector, freeze_backbone, kd_loss, make_embed_step,
                    make_eval_step, make_grad_step, make_optimizer,
                    make_train_step, multitask_logits, project_text,
                    tile_tasks)
from .train.trainer import ModalTuneTrainer, run_kfold
from .utils import params_from_jax, projector_from_jax

__version__ = "0.4.0"

__all__ = ["CoxPH", "FeatureBagDataset", "ModalTuneModel",
           "ModalTuneTrainer", "TextProjector", "TitanModalTuneModel",
           "classification_metrics", "concordance_index",
           "create_aggregator", "dropout_generator", "fit_logreg",
           "freeze_backbone", "init_weights", "kd_loss",
           "load_embedding_dict", "load_feature_bag", "load_gene_csv",
           "load_split_json", "make_embed_step", "make_eval_step",
           "make_grad_step", "make_optimizer", "make_train_step",
           "multitask_logits", "params_from_jax", "pathway_gene_groups",
           "perform_testing", "project_text", "projector_from_jax",
           "roc_curve_points", "run_kfold", "tile_tasks"]
