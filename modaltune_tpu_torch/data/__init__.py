"""The port's host-side numpy data layer: its own copy of the JAX
package's ``data/pathways.py`` and of ``data/datasets.py`` without the
file readers (``FeatureBagDataset``, ``load_*``, ``bagcache``), which wait
for the trainer. Batches reach the card through :func:`device_put`
(``BucketedLoader(device_prefetch=True)`` or
:func:`modaltune_tpu_torch.train.batch_to_device`)."""

from .pathways import GenePacker, pathway_gene_groups, synthetic_pathways
from .datasets import (Batch, BucketedLoader, DEFAULT_BUCKETS, Example,
                       SubsetDataset, TitanGridDataset,
                       SyntheticSlideDataset, choose_bucket, collate,
                       device_put, kfold_splits, pad_bag)

__all__ = [
    "GenePacker", "pathway_gene_groups", "synthetic_pathways", "Batch",
    "BucketedLoader", "DEFAULT_BUCKETS", "Example",
    "SyntheticSlideDataset", "choose_bucket", "collate", "device_put",
    "pad_bag", "SubsetDataset", "TitanGridDataset", "kfold_splits",
]
