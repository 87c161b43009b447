from .activations import gelu_exact
from .alibi_flash import alibi_attention_reference, alibi_flash_attention
from .dilated import dense_to_sparse, dilated_attention, sparse_to_dense
from .dilated_fused import fused_dilated_attention
from .dilated_mega import mega_dilated_attention
from .flash_attention import NEG_INF, flash_attention, flash_attention_reference
from .gelu_ln import gelu_ln

__all__ = [
    "NEG_INF", "alibi_attention_reference", "alibi_flash_attention", "dense_to_sparse", "dilated_attention", "flash_attention",
    "flash_attention_reference", "fused_dilated_attention", "gelu_exact",
    "gelu_ln", "mega_dilated_attention",
    "sparse_to_dense",
]
