"""The port's host-side numpy data layer: its own copy of the JAX
package's ``data/pathways.py``, ``data/datasets.py`` and
``data/bagcache.py``, file readers included (CSV tables through the
``csv`` module, no pandas). Batches reach the card through
:func:`device_put` (``BucketedLoader(device_prefetch=True)`` or
:func:`modaltune_tpu_torch.train.batch_to_device`)."""

from .pathways import GenePacker, pathway_gene_groups, synthetic_pathways
from .datasets import (Batch, BucketedLoader, DEFAULT_BUCKETS, Example,
                       FeatureBagDataset, SubsetDataset, TitanGridDataset,
                       SyntheticSlideDataset, choose_bucket, collate,
                       device_put, kfold_splits, load_embedding_dict,
                       load_feature_bag, load_gene_csv, load_split_json,
                       pad_bag)

__all__ = [
    "GenePacker", "pathway_gene_groups", "synthetic_pathways", "Batch",
    "BucketedLoader", "DEFAULT_BUCKETS", "Example", "FeatureBagDataset",
    "SyntheticSlideDataset", "choose_bucket", "collate", "device_put",
    "load_embedding_dict", "load_feature_bag", "load_gene_csv",
    "load_split_json", "pad_bag", "SubsetDataset", "TitanGridDataset",
    "kfold_splits",
]
