"""ModalTune in PyTorch for one NVIDIA H100: the port of ``modaltune_tpu``.

The JAX package stays the reference; this package computes the same
functions with ``torch`` and hand-written CUDA kernels (``csrc/``) where
the JAX package has Pallas kernels. It takes the JAX package's
framework-free layers (its configs and numpy data loader, through
``configs`` and ``data`` here; ``params_io`` in ``utils.convert``) and
never imports ``jax``.

So far it runs the forward-only embed step of ModalTune-GigaPath
(``longnetvit_gene_adapter`` and its clinical variant).
"""

from .models import ModalTuneModel, create_aggregator, init_weights
from .train import make_embed_step, multitask_logits, tile_tasks
from .utils import params_from_jax

__version__ = "0.1.0"

__all__ = ["ModalTuneModel", "create_aggregator", "init_weights",
           "make_embed_step", "multitask_logits", "params_from_jax",
           "tile_tasks"]
