"""Train ModalTune with the PyTorch port — CLI entry point.

The port's counterpart of the JAX package's ``tools/train.py``, with the
same flags and defaults plus ``--device``: loads split JSONs, gene CSV,
pathway CSV, text embeddings and optional clinical features (or makes
synthetic data), builds the model from the aggregator registry, runs
:class:`~modaltune_tpu_torch.train.trainer.ModalTuneTrainer`, or
:class:`~modaltune_tpu_torch.train.pancancer_trainer.PanCancerTrainer`
with ``--pancancer 1`` (or an eval-only deploy with ``--eval_only``), and
handles ``--multi_seed`` triplets and ``--num_folds``. ``--mil_name
gene_mixer_group``, ``abmil`` or ``transmil`` trains a supervised baseline
instead (``--mode``, ``--num_classes``, ``--fusion cat``). It runs on the
GPU unless given ``--device cpu``; without a GPU it stops and says so.

Example (synthetic smoke on the CPU):
  python -m modaltune_tpu_torch.tools.train --tiny 1 --synthetic 1 \\
    --device cpu --num_epochs 2 --output_path results

Real data on the GPU:
  python -m modaltune_tpu_torch.tools.train \\
    --train_json dataset/json_splits/tcga_brca/train_brca_cls_feat.json \\
    --val_json ... --test_json ... \\
    --genomics_csv_path data/tcga_brca_genes.csv \\
    --text_location data/brca_textemb.pt \\
    --pathway_csv dataset/gene_pathway_processed_v2.csv \\
    --mil_name longnetvit_gene_adapter \\
    --backbone_weights gigapath_backbone.npz

Several GPUs, one process each (the JAX package drives every chip from one
process; the port keeps PyTorch's idiom):

* ``--dp N`` (``auto``: every local GPU when there is more than one)
  spawns N workers on this host, one per GPU (``--device cpu``: N CPU
  workers over gloo). Every worker draws the same global batches and the
  steps split their rows over the ``data`` axis of a mesh
  (``parallel/mesh.py``); ``--batch_size`` is rounded up to a multiple of
  N.
* ``--distributed 1`` bootstraps from the environment (torchrun's
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK``,
  or SLURM's): each process trains on its case-modulo shard with the
  gradients averaged across processes (``parallel/multihost.py``)::

    torchrun --nproc_per_node 8 -m modaltune_tpu_torch.tools.train \\
      --distributed 1 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # setup (defaut_args.py)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--multi_seed", default=0, type=int,
                   help="1 = run seeds s, s+1, s+2")
    # training
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--beta2", default=0.999, type=float)
    p.add_argument("--num_epochs", default=20, type=int)
    p.add_argument("--eval_interval", default=1, type=int)
    p.add_argument("--labelset", default="primary_class", type=str)
    # data
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--train_json", default="./train.json", type=str)
    p.add_argument("--val_json", default="./val.json", type=str)
    p.add_argument("--test_json", default="./test.json", type=str)
    p.add_argument("--genomics_csv_path", default="", type=str)
    p.add_argument("--text_location", default="", type=str)
    p.add_argument("--clinical_location", default="", type=str)
    p.add_argument("--pathway_csv", default="", type=str)
    p.add_argument("--threshold", default=25000, type=int)
    p.add_argument("--buckets", default="4095,8191,16383,25599", type=str)
    # model
    p.add_argument("--mil_name", default="longnetvit_gene_adapter",
                   choices=["longnetvit_gene_adapter",
                            "longnetvit_gene_clinical_adapter",
                            "titan_gene_adapter",
                            "titan_gene_clinical_adapter",
                            "gene_mixer_group", "abmil", "transmil"])
    p.add_argument("--fusion", default="none", choices=["none", "cat"],
                   help="'cat' adds the gene-mixer late-fusion branch to "
                        "the abmil/transmil baselines (the paper's "
                        "'(cat)' rows)")
    p.add_argument("--num_tasks", default=3, type=int)
    p.add_argument("--num_classes", default=2, type=int,
                   help="classifier/survival head width of the "
                        "baselines (gene_mixer_group, abmil, transmil)")
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "survival"],
                   help="output head of the baselines (the adapter "
                        "models always run in 'feature' mode, like "
                        "train_modaltune.py:80)")
    p.add_argument("--backbone_weights", default="", type=str,
                   help="converted backbone .npz (tools/convert_gigapath)")
    p.add_argument("--pancancer", default=0, type=int)
    p.add_argument("--bf16", default=1, type=int)
    # output / eval
    p.add_argument("--output_path", default="./results", type=str)
    p.add_argument("--save_embeddings", action="store_true", default=False)
    p.add_argument("--eval_only", default=0, type=int)
    p.add_argument("--eval_weights", default="", type=str)
    p.add_argument("--reference_quirks", default=0, type=int,
                   help="reproduce the 6-iteration epoch cap")
    p.add_argument("--num_folds", default=0, type=int,
                   help=">1 runs case-level k-fold cross-validation over "
                        "the train split")
    # synthetic smoke mode (no external data needed)
    p.add_argument("--synthetic", default=0, type=int)
    p.add_argument("--learnable", default=0, type=int,
                   help="synthetic labels derived from the gene vector "
                        "(learnability smoke: val bal-acc must rise "
                        "above chance)")
    p.add_argument("--tiny", default=0, type=int,
                   help="tiny test model + small synthetic bags (CI "
                        "smoke; implies --synthetic geometry, like the "
                        "reference's LongNet_test config)")
    p.add_argument("--gc", "--grad_accum", dest="grad_accum", default=1,
                   type=int,
                   help="gradient accumulation steps (the reference "
                        "parses --gc but never uses it; here honored)")
    p.add_argument("--fused_attention", default=1, type=int,
                   help="0 runs the dilated attention branch by branch "
                        "on the flash-attention kernels (K2) instead of "
                        "the dilated kernels (K1 or K3)")
    p.add_argument("--distributed", default=0, type=int,
                   help="bootstrap torch.distributed from SLURM/torchrun "
                        "env for multi-host data parallelism")
    p.add_argument("--dp", default="auto", type=str,
                   help="single-host multi-GPU data parallelism, one "
                        "process per GPU: 'auto' uses every local device "
                        "when >1, '0'/'1' disables, N uses N devices "
                        "(batch size is rounded up to a multiple of N)")
    p.add_argument("--save_interval", default=0, type=int,
                   help="full-state (params+optimizer) checkpoint every "
                        "N epochs, with auto-resume at start; 0 = off")
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (the default: the GPU, required) or "
                        "'cpu'")
    return p


def check_supported(args) -> torch.device:
    """-> the device to run on; stops with the reason on ``cuda`` without
    a GPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; the port trains on "
                         "the GPU (pass --device cpu to run on the CPU)")
    return device


def data_parallel_size(args, device: torch.device) -> int:
    """The workers of ``--dp``: 'auto' every local GPU, N at most the
    GPUs (on the CPU, N), '0'/'1' one."""
    if args.dp in ("0", "1"):
        return 1
    if device.type != "cuda":
        return 1 if args.dp == "auto" else int(args.dp)
    n_gpus = torch.cuda.device_count()
    return n_gpus if args.dp == "auto" else min(int(args.dp), n_gpus)


def _dp_worker(rank: int, args, n: int, init_file: str, device_type: str,
               results) -> None:
    """One ``--dp`` worker: rank ``rank`` of an ``n``-process group on GPU
    ``rank`` (or the CPU), a data mesh over the group, the run."""
    import torch.distributed as dist
    from ..parallel.mesh import make_mesh
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank,
                            world_size=n)
    try:
        result = train_one_seed(args, device, mesh=make_mesh(n_data=n))
        if rank == 0:
            results.put(result)
    finally:
        dist.destroy_process_group()


def spawn_data_parallel(args, n: int, device: torch.device):
    """``--dp n``: ``n`` spawned workers, one per GPU, on the same global
    batches (``batch_size`` rounded up to a multiple of ``n``, with the JAX
    CLI's messages); returns rank 0's result."""
    import tempfile
    import torch.multiprocessing as mp
    print(f"--dp: data-parallel over {n} devices")
    if args.batch_size % n:
        args.batch_size = n * ((args.batch_size + n - 1) // n)
        print(f"--dp: batch_size rounded up to {args.batch_size} "
              f"(multiple of the {n}-device data mesh)")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dp_worker, args=(args, n, os.path.join(tmp, "init"),
                                   device.type, results), nprocs=n)
    return results.get()


def load_real_datasets(args):
    from ..data import (FeatureBagDataset, GenePacker, load_embedding_dict,
                        load_gene_csv, load_split_json, pathway_gene_groups)
    from ..utils.constants import SITE_LABEL
    matrix, case_ids, gene_names = load_gene_csv(args.genomics_csv_path)
    groups = pathway_gene_groups(args.pathway_csv)
    packer = GenePacker.build(groups, gene_names)

    text = load_embedding_dict(args.text_location)
    clinical = load_embedding_dict(args.clinical_location) \
        if args.clinical_location else None
    datasets = {}
    for name, path in (("train", args.train_json), ("val", args.val_json),
                       ("test", args.test_json)):
        rows = load_split_json(path)
        if isinstance(rows, dict):
            rows = rows["data"]
        datasets[name] = FeatureBagDataset(
            rows, matrix, case_ids, packer, text, clinical=clinical,
            labelset=args.labelset, threshold=args.threshold,
            site_label=SITE_LABEL if args.pancancer else None)
    return datasets, packer


def load_synthetic_datasets(args, in_chans: int = 1536,
                            bag_range=(256, 1024)):
    from ..data import SyntheticSlideDataset
    packer = SyntheticSlideDataset(n_cases=1).packer
    clin = 5 if "clinical" in args.mil_name else 0
    learnable = bool(getattr(args, "learnable", 0))
    n_cases = 24 if learnable else 8
    datasets = {
        name: SyntheticSlideDataset(
            n_cases=n_cases, in_chans=in_chans, bag_range=bag_range,
            packer=packer, clinical_dim=clin, threshold=args.threshold,
            seed=i, n_sites=4 if args.pancancer else 1,
            learnable=learnable)
        for i, name in enumerate(("train", "val", "test"))}
    return datasets, packer


def model_config(args):
    """The model configuration of ``--mil_name`` / ``--tiny``; with
    ``--eval_only`` and ``--eval_weights``, the one of the ``config.json``
    beside the weights (and its buckets), so drifted flags cannot build a
    model that mismatches the checkpoint (train_modaltune.py:563-586)."""
    from ..configs import (TitanModalTuneConfig, gigapath_modaltune_config,
                           model_config_from_dict, tiny_test_config)
    clinical = "clinical" in args.mil_name
    if args.mil_name.startswith("titan"):
        model_cfg = TitanModalTuneConfig()
    elif args.tiny:
        model_cfg = tiny_test_config(clinical=clinical)
    else:
        model_cfg = gigapath_modaltune_config(clinical=clinical)
    if args.eval_only and args.eval_weights:
        cfg_path = Path(args.eval_weights).parent / "config.json"
        if cfg_path.exists():
            with open(cfg_path) as f:
                saved = json.load(f)
            if saved.get("model"):
                model_cfg = model_config_from_dict(saved["model"])
                print(f"eval_only: model config reloaded from {cfg_path}")
            if saved.get("buckets"):
                args.buckets = ",".join(str(b) for b in saved["buckets"])
        else:
            print(f"eval_only: WARNING no config.json next to "
                  f"{args.eval_weights}; building from CLI flags")
    if not args.fused_attention and hasattr(model_cfg, "backbone") and \
            hasattr(model_cfg.backbone, "fused_attention"):
        model_cfg = dataclasses.replace(
            model_cfg, backbone=dataclasses.replace(model_cfg.backbone,
                                                    fused_attention=False))
    return model_cfg


def initial_params(model, args) -> dict:
    """Random parameters from ``--seed`` (a CPU generator), the backbone's
    from ``--backbone_weights`` where given: a JAX-layout ``.npz`` of the
    backbone alone (``tools/convert_gigapath.py``) or of a whole model,
    every backbone tensor set, no other key, no shape changed."""
    from ..models import init_weights
    from ..utils.convert import params_from_jax
    from ..utils.params_io import load_params_npz
    init_weights(model, torch.Generator().manual_seed(args.seed))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if args.backbone_weights:
        loaded = load_params_npz(args.backbone_weights)
        tree = {"backbone": loaded.get("backbone", loaded)}
        params.update(params_from_jax(tree, model, subtree="backbone"))
        print(f"loaded backbone weights from {args.backbone_weights}")
    return params


def baseline_train_config(args):
    from ..configs import TrainConfig
    return TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                       beta1=args.beta1, beta2=args.beta2,
                       num_epochs=args.num_epochs, seed=args.seed,
                       eval_interval=args.eval_interval)


def run_gene_baseline(args, datasets, packer, device):
    """Genomics-only baseline: ``gene_mixer_group`` with a classifier or
    survival head (BASELINE.md's Gene-Mixer rows), batches of at least 8."""
    from ..configs import GeneEncoderConfig
    from ..models import create_aggregator
    from ..train.gene_trainer import GeneBaselineTrainer
    model = create_aggregator(
        "gene_mixer_group", device=device, cfg=GeneEncoderConfig(),
        n_gene_groups=packer.n_groups, max_group_len=packer.max_group_len,
        n_classes=args.num_classes, mode=args.mode)
    out_dir = Path(args.output_path) / f"seed_{args.seed}"
    trainer = GeneBaselineTrainer(model, baseline_train_config(args),
                                  datasets, str(out_dir),
                                  batch_size=max(args.batch_size, 8))
    best = trainer.run(initial_params(model, args))
    print(f"seed {args.seed}: best val metric = {best:.4f}")
    return best


def run_mil_baseline(args, datasets, packer, device):
    """Supervised ABMIL / TransMIL over cached feature bags (BASELINE.json
    target configs #1-#2), with ``--fusion cat`` the gene mixer's late
    fusion; batches of at least 4."""
    from ..configs import GeneEncoderConfig
    from ..models import create_aggregator
    from ..train.mil_trainer import MilBaselineTrainer
    ex = datasets["train"].get(0, np.random.RandomState(0))
    kwargs = dict(in_dim=ex.bag.shape[1], n_classes=args.num_classes,
                  mode=args.mode)
    if args.fusion == "cat":
        kwargs.update(gene_cfg=GeneEncoderConfig(),
                      n_gene_groups=packer.n_groups,
                      max_group_len=packer.max_group_len)
    model = create_aggregator(args.mil_name, device=device, **kwargs)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    out_dir = Path(args.output_path) / f"seed_{args.seed}"
    trainer = MilBaselineTrainer(model, baseline_train_config(args),
                                 datasets, str(out_dir),
                                 batch_size=max(args.batch_size, 4),
                                 buckets=buckets)
    best = trainer.run(initial_params(model, args))
    print(f"seed {args.seed}: best val metric = {best:.4f}")
    return best


def run_one_seed(args):
    """One seed's run: on this process, over the processes of the
    environment (``--distributed 1``), or in ``--dp`` spawned workers."""
    from ..parallel.multihost import init_distributed
    device = check_supported(args)
    baseline = args.mil_name in ("gene_mixer_group", "abmil", "transmil")
    if args.distributed and not baseline:
        rank, world = init_distributed(device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return train_one_seed(args, device, process_shard=(
            (rank, world) if world > 1 else None))
    n_data = 1 if baseline else data_parallel_size(args, device)
    if n_data > 1:
        return spawn_data_parallel(args, n_data, device)
    return train_one_seed(args, device)


def train_one_seed(args, device: torch.device, mesh=None,
                   process_shard=None):
    from ..configs import TrainConfig, tiny_test_config
    from ..models import create_aggregator
    from ..train.pancancer_trainer import PanCancerTrainer
    from ..train.trainer import ModalTuneTrainer

    if args.tiny:
        tiny_chans = tiny_test_config().backbone.in_chans
        if not args.synthetic and Path(args.train_json).exists():
            # tiny MODEL on REAL artifacts: the reference's on-disk formats
            # (.pt feature/text/clinical dicts, split JSONs, gene CSV) run
            # train->eval->deploy end-to-end at CI-sized geometry
            datasets, packer = load_real_datasets(args)
        else:
            datasets, packer = load_synthetic_datasets(
                args, in_chans=tiny_chans, bag_range=(40, 80))
        if args.buckets == "4095,8191,16383,25599":
            args.buckets = "96"
    elif args.synthetic:
        datasets, packer = load_synthetic_datasets(args)
    else:
        datasets, packer = load_real_datasets(args)

    if args.mil_name == "gene_mixer_group":
        return run_gene_baseline(args, datasets, packer, device)
    if args.mil_name in ("abmil", "transmil"):
        return run_mil_baseline(args, datasets, packer, device)

    if args.mil_name.startswith("titan"):
        # TITAN consumes grid-scattered cells, not raw patch bags
        from ..data import TitanGridDataset
        datasets = {k: TitanGridDataset(v) for k, v in datasets.items()}

    model_cfg = model_config(args)
    model = create_aggregator(args.mil_name, device=device, cfg=model_cfg,
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    dtype = torch.bfloat16 if args.bf16 else None

    tcfg = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                       beta1=args.beta1, beta2=args.beta2,
                       num_epochs=args.num_epochs, seed=args.seed,
                       eval_interval=args.eval_interval,
                       num_tasks=args.num_tasks,
                       threshold=args.threshold,
                       grad_accum=args.grad_accum,
                       reference_quirks=bool(args.reference_quirks),
                       save_interval=args.save_interval)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    out_dir = Path(args.output_path) / f"seed_{args.seed}"
    params = initial_params(model, args)
    cls = PanCancerTrainer if args.pancancer else ModalTuneTrainer

    parallel = dict(mesh=mesh, process_shard=process_shard)
    if args.eval_only:
        trainer = cls(model, tcfg, datasets, str(out_dir), buckets=buckets,
                      batch_size=args.batch_size, model_cfg=model_cfg,
                      **parallel)
        trainer.init_state(params, frozen_dtype=dtype)
        return trainer.deploy(weights_path=args.eval_weights or None)

    if args.num_folds > 1:
        from ..data import kfold_splits
        fold_metrics = []
        for k, (tr, va) in enumerate(kfold_splits(datasets["train"],
                                                  args.num_folds,
                                                  seed=args.seed)):
            fold_sets = dict(datasets)
            fold_sets["train"], fold_sets["val"] = tr, va
            fold_trainer = cls(model, tcfg, fold_sets,
                               str(out_dir / f"fold_{k}"), buckets=buckets,
                               batch_size=args.batch_size,
                               model_cfg=model_cfg)
            fold_metrics.append(fold_trainer.run(params,
                                                 frozen_dtype=dtype))
        print(f"k-fold metrics: {fold_metrics} "
              f"mean={np.mean(fold_metrics):.4f}")
        return float(np.mean(fold_metrics))

    trainer = cls(model, tcfg, datasets, str(out_dir), buckets=buckets,
                  batch_size=args.batch_size, model_cfg=model_cfg,
                  **parallel)
    best = trainer.run(params, frozen_dtype=dtype)
    if trainer.is_main:
        print(f"seed {args.seed}: best val metric = {best:.4f}")
    if args.save_embeddings:
        trainer.deploy(weights_path=str(out_dir / "best_model_weights.pt"))
    return best


def main(argv=None):
    args = build_parser().parse_args(argv)
    seeds = [args.seed, args.seed + 1, args.seed + 2] if args.multi_seed \
        else [args.seed]
    results = []
    for seed in seeds:
        args.seed = seed
        results.append(run_one_seed(args))
    if len(results) > 1 and all(isinstance(r, float) for r in results):
        print(f"multi-seed mean={np.mean(results):.4f} "
              f"std={np.std(results):.4f}")
    import torch.distributed as dist
    if dist.is_initialized():       # --distributed 1
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
