"""Typed configuration objects for ModalTune-TPU.

These replace the reference's three-tier config system (argparse defaults,
model-config JSONs, and the kwargs-popping ``EncoderConfig`` with its
``eval()``-based postprocessing — see reference
``torchscale/architecture/config.py:5-89`` and
``model_configs/modaltune_gigapath_config.json``) with plain frozen
dataclasses that are hashable, serializable, and safe to close over in
``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Optional, Sequence, Tuple


def _freeze(seq) -> Tuple:
    return tuple(tuple(s) if isinstance(s, (list, tuple)) else s for s in seq)


def optimal_segment_lengths(max_wsi_size: int = 262144, tile_size: int = 256,
                            n: int = 5) -> Tuple[int, ...]:
    """Log-spaced LongNet segment schedule derived from the max WSI size.

    Mirrors the schedule the reference derives in
    ``gigapath/slide_encoder.py:163-182`` (log2-linspace from 1024 to the
    max token count), computed here without numpy so configs stay
    import-light.
    """
    max_seq_len = (max_wsi_size // tile_size) ** 2
    lo, hi = math.log2(1024), float(int(math.log2(max_seq_len)))
    if n == 1:
        return (1024,)
    step = (hi - lo) / (n - 1)
    return tuple(int(2 ** (lo + i * step)) for i in range(n))


@dataclasses.dataclass(frozen=True)
class LongNetConfig:
    """LongNet dilated-attention encoder architecture.

    Matches the reference's ``LongNet_12_layers_768_dim`` arch dict
    (``torchscale/model/LongNetConfig.py:166-179``) plus the EncoderConfig
    defaults that matter for the forward pass
    (``torchscale/architecture/config.py:5-89``).
    """

    num_layers: int = 12
    embed_dim: int = 768
    ffn_dim: int = 3072
    num_heads: int = 16
    segment_lengths: Tuple[int, ...] = dataclasses.field(
        default_factory=lambda: optimal_segment_lengths())
    dilated_ratios: Tuple[int, ...] = (1, 2, 4, 8, 16)
    dropout: float = 0.25
    drop_path_rate: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layernorm_eps: float = 1e-5
    subln: bool = True              # sub-LayerNorm (inner attn LN + FFN LN)
    normalize_before: bool = True   # pre-norm (forced true by subln)
    normalize_output: bool = True   # final encoder LayerNorm exists
    activation: str = "gelu"        # exact (erf) gelu, like torch F.gelu
    # TPU-specific knobs (no reference equivalent):
    mask_padding: bool = True       # mask padded keys inside attention
    remat: bool = True              # per-layer activation rematerialization
    # remat policy: "flash" keeps the flash-attention kernel outputs
    # (out + LSE, checkpoint_name-tagged in ops/) as residuals so the
    # backward pass never re-runs the forward kernels (~30% step time at
    # ~30MB/layer for a 10k-token bag); "full" recomputes everything.
    remat_policy: str = "flash"
    # fused dilated attention (single-pass Pallas kernels per branch +
    # LSE-mix kernel, ops/dilated_fused.py); used when the shapes are
    # eligible and the backend is TPU, else falls back to ops/dilated.py
    fused_attention: bool = True
    # single-kernel mega attention (all branches + online mix in one
    # pallas_call over one comb-resident copy of q/k/v,
    # ops/dilated_mega.py); preferred over the per-branch fused kernels
    # when eligible — deletes the per-branch relayout copies that
    # dominate the fused path's step time. Gated under fused_attention.
    mega_attention: bool = True
    # sequence parallelism for the fused path: (batch_axis, seq_axis)
    # mesh-axis names; when the ambient mesh (jax.set_mesh) carries
    # them, dilated attention runs as a shard_map island — all-gather
    # K/V over `seq`, device-local mega kernel on the shard's query
    # rows (ops/dilated_sp.py; the reference gather_kv equivalent,
    # dilated_attention.py:61-80). None = GSPMD/XLA handles sequence
    # sharding (requires the XLA attention path).
    seq_axes: Optional[Tuple[str, str]] = None
    # LoRA-adapter encoder variant: per-modality (img/gene/task) LoRA
    # deltas on q/k/v (LongNetLoraAdapterEncoder, LongNet.py:85-177;
    # selected by ``lora_adapter`` at slide_encoder.py:101)
    lora_adapter: bool = False
    lora_alpha: float = 32.0
    img_lora_dim: int = 4
    mm_lora_dim: int = 8
    lora_dropout: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "segment_lengths", tuple(self.segment_lengths))
        object.__setattr__(self, "dilated_ratios", tuple(self.dilated_ratios))
        assert len(self.segment_lengths) == len(self.dilated_ratios)
        assert self.embed_dim % self.num_heads == 0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class SlideEncoderConfig:
    """LongNetViT slide encoder (frozen GigaPath backbone).

    Mirrors ``gigapath/slide_encoder.py:87-142`` /
    ``model_configs/modaltune_gigapath_config.json``.
    """

    in_chans: int = 1536
    embed_dim: int = 768
    depth: int = 12
    slide_ngrids: int = 1000
    tile_size: int = 256
    max_wsi_size: int = 262144
    mlp_ratio: float = 4.0
    global_pool: bool = False
    dropout: float = 0.25
    drop_path_rate: float = 0.1
    norm_eps: float = 1e-6          # the ViT-level output LayerNorm
    fused_attention: bool = True    # forwarded into LongNetConfig
    seq_axes: Optional[Tuple[str, str]] = None  # forwarded (seq-parallel)
    remat: bool = True              # forwarded: per-layer remat on/off
    remat_policy: str = "flash"     # forwarded: see longnet.remat_policy

    def longnet(self, **overrides) -> LongNetConfig:
        base = dict(
            num_layers=self.depth,
            embed_dim=self.embed_dim,
            ffn_dim=int(self.embed_dim * self.mlp_ratio),
            num_heads=16,
            fused_attention=self.fused_attention,
            seq_axes=self.seq_axes,
            remat=self.remat,
            remat_policy=self.remat_policy,
            segment_lengths=optimal_segment_lengths(self.max_wsi_size,
                                                    self.tile_size),
            dropout=self.dropout,
            drop_path_rate=self.drop_path_rate,
        )
        base.update(overrides)
        return LongNetConfig(**base)


@dataclasses.dataclass(frozen=True)
class TitanConfig:
    """TITAN slide-encoder ViT (MahmoodLab TITAN; the reference builds it
    from an external HF snapshot at ``titan_adapter.py:88-104``; this
    config mirrors its ``TitanConfig().vision_config`` surface).

    The encoder consumes CONCH v1.5 patch features scattered onto a 2-D
    grid (``patch_size_lv0`` level-0 pixels per cell) with 2-D ALiBi
    attention bias and a background mask; output via attentional pooling.
    """

    in_dim: int = 768               # CONCH v1.5 patch feature dim
    embed_dim: int = 768
    depth: int = 6
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    mlp_patch_embed_dim: int = 768  # hidden dim of the MLP patch embed
    pos_encode_type: str = "alibi"
    attn_pooler_queries: int = 128
    attn_pooler_heads: int = 12
    patch_size_lv0: int = 1024
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class GeneEncoderConfig:
    """Pathway-grouped gene encoder (S-MLP + Gene-Mixer).

    Mirrors ``model_configs/other_configs.py:12-24`` +
    ``models/genomic_utils/gene_encoder.py:97-165``.
    """

    latent_dim: int = 256
    depth: int = 3                  # mixer depth
    expansion_groups: float = 0.5
    expansion_dim: float = 0.5
    dropout: float = 0.25
    cls_token: bool = False
    final_groups: int = 64          # pathway_compression output tokens
    output_dim: int = 768           # set to backbone embed_dim


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Modal Adapter (Injector/Extractor interaction blocks + fusion head).

    Mirrors ``model_configs/modaltune_gigapath_config.json`` +
    ``models/aggregators/longvit_adapter.py:35-182``.
    """

    num_heads: int = 12
    output_dim: int = 256
    init_values: float = 0.0        # injector gamma init
    interaction_indexes: Tuple[Tuple[int, int], ...] = ((0, 3), (4, 7), (8, 11))
    with_cffn: bool = True
    cffn_ratio: float = 0.25
    add_prompt_feature: bool = True
    use_extra_extractor: bool = True
    freeze_vit: bool = True
    use_prompt_sa: bool = True
    prompt_dropout: float = 0.0
    prompt_agg: str = "avg"         # "avg" | "cls"
    token_agg: str = "sum"          # "sum" | "cat"
    multi_task: int = 3
    clinfeat_dim: int = 0           # >0 enables the clinical token branch
    drop_path_rate: float = 0.1

    def __post_init__(self):
        object.__setattr__(self, "interaction_indexes",
                           _freeze(self.interaction_indexes))

    @property
    def is_multi(self) -> bool:
        return self.multi_task > 1

    @property
    def with_clinical(self) -> bool:
        return self.clinfeat_dim > 0


@dataclasses.dataclass(frozen=True)
class ModalTuneConfig:
    """Full ModalTune model = frozen slide encoder + trainable adapter."""

    backbone: SlideEncoderConfig = dataclasses.field(
        default_factory=SlideEncoderConfig)
    adapter: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    gene: GeneEncoderConfig = dataclasses.field(
        default_factory=GeneEncoderConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "ModalTuneConfig":
        """Rebuild from a ``dataclasses.asdict`` dump — the eval-only /
        OOD-deploy config round-trip (``train_modaltune.py:563-586``
        reloads the run's saved config.json the same way)."""
        return cls(backbone=SlideEncoderConfig(**d.get("backbone", {})),
                   adapter=AdapterConfig(**d.get("adapter", {})),
                   gene=GeneEncoderConfig(**d.get("gene", {})))


@dataclasses.dataclass(frozen=True)
class TitanModalTuneConfig:
    """ModalTune over the TITAN backbone
    (``model_configs/modaltune_titan_config.json``: token_agg 'cat',
    drop_path 0.2, interaction spans over 6 ViT blocks)."""

    backbone: TitanConfig = dataclasses.field(default_factory=TitanConfig)
    adapter: AdapterConfig = dataclasses.field(
        default_factory=lambda: AdapterConfig(
            interaction_indexes=((0, 1), (2, 3), (4, 5)),
            token_agg="cat", drop_path_rate=0.2))
    gene: GeneEncoderConfig = dataclasses.field(
        default_factory=GeneEncoderConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "TitanModalTuneConfig":
        return cls(backbone=TitanConfig(**d.get("backbone", {})),
                   adapter=AdapterConfig(**d.get("adapter", {})),
                   gene=GeneEncoderConfig(**d.get("gene", {})))


def model_config_from_dict(d: dict):
    """Dispatch a saved model-config dict to the right config class.

    TITAN backbones are recognized by their distinctive fields
    (``attn_pooler_queries``); everything else is a GigaPath
    ``ModalTuneConfig``.
    """
    if "attn_pooler_queries" in d.get("backbone", {}):
        return TitanModalTuneConfig.from_dict(d)
    return ModalTuneConfig.from_dict(d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters.

    Defaults mirror the reference argparse defaults
    (``utils/defaut_args.py``) and trainer constants
    (``train_modaltune.py:64-65,107,151-154``).
    """

    lr: float = 1e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    num_epochs: int = 20
    warmup_epochs: int = 10          # WARMUP_EP
    warmup_factor: float = 20.0      # WARMUP_FACTOR (start lr = lr / factor)
    temperature: float = 1.0         # KD temperature
    kd_loss_scale: float = 10.0      # KL * T^2 * 10
    num_tasks: int = 3
    threshold: int = 25000           # max patches per bag
    seed: int = 0
    eval_interval: int = 1
    # interval full-state checkpoints (params + optimizer) every N epochs
    # with auto-resume at run() start; 0 disables. The reference saves
    # weights-only ``model_weights_epoch_N.pt`` (base_trainer.py:320-340)
    # and cannot resume optimizer state.
    save_interval: int = 0
    # gradient accumulation: the reference PARSES --gc but never uses it
    # (train_modaltune.py:619, SURVEY.md §7 quirks) — here it is honored
    # (optax.MultiSteps), implementing the intended behavior
    grad_accum: int = 1
    # reference quirk: train_modaltune.py:196-197 caps every epoch at 6
    # iterations. Off by default; enable for strict parity runs.
    reference_quirks: bool = False
    steps_per_epoch_cap: int = 0     # 0 = full epoch


def gigapath_modaltune_config(clinical: bool = False,
                              **overrides) -> ModalTuneConfig:
    """The ``modaltune_gigapath_config.json`` preset."""
    adapter = AdapterConfig(clinfeat_dim=5 if clinical else 0,
                            **overrides.pop("adapter", {}))
    return ModalTuneConfig(backbone=SlideEncoderConfig(), adapter=adapter,
                           gene=GeneEncoderConfig(output_dim=768))


def tiny_test_config(depth: int = 2, embed_dim: int = 128,
                     clinical: bool = False) -> ModalTuneConfig:
    """Small config for unit tests / CI, analogous to the reference's
    ``LongNet_test`` arch (``LongNetConfig.py:321-334``)."""
    backbone = SlideEncoderConfig(in_chans=64, embed_dim=embed_dim,
                                  depth=depth, max_wsi_size=16384,
                                  dropout=0.0, drop_path_rate=0.0)
    n_int = max(1, depth // 2)
    idx = []
    span = depth // n_int
    for i in range(n_int):
        idx.append((i * span, min(depth, (i + 1) * span) - 1))
    adapter = AdapterConfig(num_heads=4,
                            interaction_indexes=tuple(idx),
                            clinfeat_dim=5 if clinical else 0,
                            drop_path_rate=0.0)
    gene = GeneEncoderConfig(latent_dim=32, depth=2, final_groups=8,
                             output_dim=embed_dim, dropout=0.0)
    return ModalTuneConfig(backbone=backbone, adapter=adapter, gene=gene)


# ---------------------------------------------------------------------------
# Named LongNet architecture table
# ---------------------------------------------------------------------------

# (layers, dim, ffn, heads, mlp_suffix) per named entry of the reference
# table ``torchscale/model/LongNetConfig.py`` (SURVEY.md §2.3). Vanilla
# variants run a single full-attention branch (segment >> any WSI bag,
# ratio 1 — ``LongNetConfig.py:276-319``).
_LONGNET_ARCHS = {
    "LongNet_12_layers_1536_dim": (12, 1536, 6144, 16),
    "LongNet_12_layers_256_dim": (12, 256, 1024, 16),
    "LongNet_12_layers_256_dim_mlp2": (12, 256, 512, 16),
    "LongNet_12_layers_384_dim": (12, 384, 1536, 16),
    "LongNet_12_layers_512_dim": (12, 512, 1024, 8),
    "LongNet_12_layers_768_dim": (12, 768, 3072, 16),
    "LongNet_24_layers_1024_dim": (24, 1024, 4096, 16),
    "LongNet_3_layers_1536_dim": (3, 1536, 6144, 16),
    "LongNet_3_layers_384_dim": (3, 384, 1536, 16),
    "LongNet_3_layers_768_dim": (3, 768, 3072, 16),
    "LongNet_6_layers_1536_dim": (6, 1536, 6144, 16),
    "LongNet_6_layers_384_dim": (6, 384, 1536, 16),
    "LongNet_6_layers_768_dim": (6, 768, 3072, 16),
    "LongNet_8_layers_1024_dim": (8, 1024, 4096, 16),
    "LongNet_8_layers_1536_dim": (8, 1536, 6144, 16),
    "LongNet_8_layers_256_dim": (8, 256, 1024, 16),
    "LongNet_8_layers_256_dim_mlp2": (8, 256, 512, 16),
    "LongNet_8_layers_768_dim": (8, 768, 3072, 16),
    "LongNet_Vanilla_12_layers_256_dim": (12, 256, 512, 8),
    "LongNet_Vanilla_6_layers_1536_dim": (6, 1536, 6144, 16),
    "LongNet_Vanilla_6_layers_768_dim": (6, 768, 3072, 16),
    "LongNet_test": (1, 192, 192, 8),
}


def longnet_config_by_name(name: str,
                           segment_lengths=None,
                           dilated_ratios=None,
                           dropout: float = 0.1,
                           drop_path_rate: float = 0.1,
                           **overrides) -> "LongNetConfig":
    """Build a :class:`LongNetConfig` from a reference table name — the
    equivalent of ``make_longnet_from_name``
    (``torchscale/model/LongNet.py:196-249``), which looks the name up
    in the arch table and overlays segment/ratio/dropout arguments.
    """
    if name not in _LONGNET_ARCHS:
        raise KeyError(
            f"unknown LongNet arch {name!r}; known: "
            f"{sorted(_LONGNET_ARCHS)}")
    layers, dim, ffn, heads = _LONGNET_ARCHS[name]
    if "Vanilla" in name:
        segment_lengths = segment_lengths or (10_000_000,)
        dilated_ratios = dilated_ratios or (1,)
    else:
        segment_lengths = segment_lengths or optimal_segment_lengths()
        dilated_ratios = dilated_ratios or (1, 2, 4, 8, 16)
    base = dict(num_layers=layers, embed_dim=dim, ffn_dim=ffn,
                num_heads=heads, segment_lengths=tuple(segment_lengths),
                dilated_ratios=tuple(dilated_ratios), dropout=dropout,
                drop_path_rate=drop_path_rate)
    base.update(overrides)
    return LongNetConfig(**base)
