"""The model and training configurations the port reads.

They are the JAX package's own dataclasses: ``modaltune_tpu.configs``
imports only the standard library, so both packages read the same
configs. This module is the one place the port takes them from.
"""

from modaltune_tpu.configs import (AdapterConfig, GeneEncoderConfig,
                                   LongNetConfig, ModalTuneConfig,
                                   SlideEncoderConfig, TrainConfig,
                                   gigapath_modaltune_config,
                                   tiny_test_config)

__all__ = [
    "AdapterConfig", "GeneEncoderConfig", "LongNetConfig", "ModalTuneConfig",
    "SlideEncoderConfig", "TrainConfig", "gigapath_modaltune_config",
    "tiny_test_config",
]
