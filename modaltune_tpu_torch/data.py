"""The host-side data layer the port reads slides through.

It is the JAX package's own numpy loader: ``modaltune_tpu.data`` imports
no JAX unless ``BucketedLoader`` is asked to prefetch to a device, which
the port never does (``device_prefetch=False``; batches go to the card
through :func:`modaltune_tpu_torch.train.batch_to_device`). This module is
the one place the port takes it from.
"""

from modaltune_tpu.data import (Batch, BucketedLoader, GenePacker,
                                SyntheticSlideDataset, synthetic_pathways)

__all__ = ["Batch", "BucketedLoader", "GenePacker", "SyntheticSlideDataset",
           "synthetic_pathways"]
