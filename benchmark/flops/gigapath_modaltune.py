"""Model FLOPs of a ModalTune-GigaPath step over one slide of ``length``
valid tiles: every product over the valid tokens (and the cls token),
the dilated attention over its unmasked (query, key) pairs
(``roofline.dilated_pairs``), all times the tasks tiled in the step. The
train step adds the backward: dX through the frozen LongNet layers (five
attention products for two), dX and dW of the trainable parts; neither
the remat's recompute nor elementwise work counts."""

from __future__ import annotations

from ..harness.roofline import dilated_pairs
from .adapter import mm, trainable


def _layers(config: dict, bucket: int, length: int):
    """-> (products, attention pairs x head dim) of the LongNet layers for
    one row."""
    c = config["longnet"]
    n, d, f = length + 1, c["embed_dim"], c["ffn_dim"]
    pairs = dilated_pairs(bucket + 1, n, tuple(c["segment_lengths"]),
                          tuple(c["dilated_ratios"]), c["num_heads"],
                          (0, n))
    per = mm(n, d, 4 * d) + mm(n, d, f) + mm(n, f, d)
    return c["num_layers"] * per, c["num_layers"] * pairs * (d //
                                                            c["num_heads"])


def forward(config: dict, bucket: int, length: int) -> float:
    b = config["model"]["backbone"]
    gemm, attn = _layers(config, bucket, length)
    row = (mm(length, b["in_chans"], b["embed_dim"]) + gemm + 4 * attn
           + trainable(config, length))
    return float(config["train"]["num_tasks"] * row)


def train(config: dict, bucket: int, length: int) -> float:
    gemm, attn = _layers(config, bucket, length)
    back = gemm + 10 * attn + 2 * trainable(config, length)
    return forward(config, bucket, length) + float(
        config["train"]["num_tasks"] * back)
