"""The port's host-side numpy data layer: its own copy of the JAX
package's ``data/pathways.py``, ``data/datasets.py``,
``data/bagcache.py`` and ``data/extract.py``, file readers included (CSV
tables through the ``csv`` module, no pandas), and the dataset
preparation of ``data/pipeline.py`` rebuilt without pandas and sklearn. Batches reach the card through
:func:`device_put` (``BucketedLoader(device_prefetch=True)`` or
:func:`modaltune_tpu_torch.train.batch_to_device`)."""

from .pathways import GenePacker, pathway_gene_groups, synthetic_pathways
from .datasets import (Batch, BucketedLoader, DEFAULT_BUCKETS, Example,
                       FeatureBagDataset, SubsetDataset, TitanGridDataset,
                       SyntheticSlideDataset, choose_bucket, collate,
                       device_put, kfold_splits, load_embedding_dict,
                       load_feature_bag, load_gene_csv, load_split_json,
                       pad_bag)
from .extract import (array_slide_reader, extract_slide_features,
                      extract_slide_features_titan, plan_patches,
                      tissue_mask)
from .pipeline import (frame_records, generate_prompts, load_labelset,
                       make_splits, make_text_embeddings,
                       prepare_clinical_features, process_gene_matrix,
                       read_table)

__all__ = [
    "GenePacker", "pathway_gene_groups", "synthetic_pathways", "Batch",
    "BucketedLoader", "DEFAULT_BUCKETS", "Example", "FeatureBagDataset",
    "SyntheticSlideDataset", "choose_bucket", "collate", "device_put",
    "load_embedding_dict", "load_feature_bag", "load_gene_csv",
    "load_split_json", "pad_bag", "SubsetDataset", "TitanGridDataset",
    "kfold_splits", "array_slide_reader", "extract_slide_features",
    "extract_slide_features_titan", "plan_patches", "tissue_mask",
    "frame_records", "generate_prompts", "load_labelset", "make_splits",
    "make_text_embeddings", "prepare_clinical_features",
    "process_gene_matrix", "read_table",
]
