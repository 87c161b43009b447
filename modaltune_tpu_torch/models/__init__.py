from .adapter import Extractor, InteractionBlock, Injector
from .extras import (LoraDilatedSelfAttention, MoeFeedForward,
                     RelativePositionBias, apply_xpos, top1_gating,
                     top2_gating)
from .gene import (ChannelFeedForward, GeneMixerEncoder, GeneOnlyModel,
                   TokenFeedForward)
from .heads import classifier_logits, survival_from_logits
from .layers import (AlphaDropout, CrossAttentionLayer, Dense, DropPath,
                     Dropout, FFNLayer, SelfAttentionLayer, TorchMHA,
                     dropout_generator, fill_normal_, init_weights,
                     mask_to_bias)
from .longnet import (DilatedSelfAttention, FeedForwardNetwork,
                      LongNetEncoder, LongNetEncoderLayer)
from .mil import (AbmilModel, GatedAttentionPool, NystromSelfAttention, PPEG,
                  TransMilModel)
from .modaltune import ModalTuneModel
from .registry import AGGREGATORS, create_aggregator
from .slide_encoder import LongNetViT, PatchEmbed, coords_pos_embed, sincos_1d
from .titan import (AttentionalPooler, BiasedMHA, TitanBlock,
                    TitanModalTuneModel, TitanViT, alibi_bias, alibi_slopes,
                    grid_scatter_bag)

__all__ = [
    "AGGREGATORS", "AbmilModel", "AlphaDropout", "GatedAttentionPool",
    "GeneOnlyModel", "NystromSelfAttention", "PPEG", "TransMilModel",
    "classifier_logits", "survival_from_logits", "AttentionalPooler",
    "BiasedMHA",
    "TitanBlock", "TitanModalTuneModel", "TitanViT", "alibi_bias",
    "alibi_slopes", "fill_normal_", "grid_scatter_bag", "ChannelFeedForward", "CrossAttentionLayer",
    "Dense", "DilatedSelfAttention", "DropPath", "Dropout", "Extractor",
    "FFNLayer",
    "FeedForwardNetwork", "GeneMixerEncoder", "Injector", "InteractionBlock",
    "LongNetEncoder", "LongNetEncoderLayer", "LongNetViT", "ModalTuneModel",
    "PatchEmbed", "SelfAttentionLayer", "TokenFeedForward", "TorchMHA",
    "coords_pos_embed", "create_aggregator", "dropout_generator",
    "init_weights", "mask_to_bias",
    "sincos_1d", "LoraDilatedSelfAttention", "MoeFeedForward",
    "RelativePositionBias", "apply_xpos", "top1_gating", "top2_gating",
]
