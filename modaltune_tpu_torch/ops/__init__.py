from .activations import gelu_exact
from .alibi_flash import alibi_attention_reference, alibi_flash_attention
from .dilated import dense_to_sparse, dilated_attention, sparse_to_dense
from .dilated_mega import mega_dilated_attention
from .flash_attention import NEG_INF, flash_attention, flash_attention_reference

__all__ = [
    "NEG_INF", "alibi_attention_reference", "alibi_flash_attention", "dense_to_sparse", "dilated_attention", "flash_attention",
    "flash_attention_reference", "gelu_exact", "mega_dilated_attention",
    "sparse_to_dense",
]
