"""Multi-process runs of the port on the CPU for the parallel tests.

:func:`run_ranks` starts ``n`` processes (``spawn``), joins them in one
gloo process group initialised through a file under the test's
``tmp_path`` (never a fixed port), runs a worker function of this module in
each and returns every rank's result. A run that outlasts its time limit
fails with every rank's output; it is never skipped.

The workers import only the port (no JAX), so a rank starts in seconds;
the tests compare what they return with the JAX package in the parent.
"""

import dataclasses
import os
import pickle
import sys
import time
import traceback
import uuid

import numpy as np
import torch

SEQ_AXES = ("data", "seq")
N_GENES = 60


def run_ranks(fn, n, tmp_path, payload=None, timeout=180):
    """``[fn(rank, n, payload) for rank in range(n)]``, each in its own
    process of an ``n``-rank gloo group; raises AssertionError with the
    ranks' output when a rank fails or the run takes over ``timeout``
    seconds."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    run = tmp_path / f"ranks_{uuid.uuid4().hex[:8]}"
    run.mkdir()
    procs = [ctx.Process(target=_entry, args=(fn, rank, n, str(run),
                                              payload))
             for rank in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()

    def logs():
        return "\n".join(f"--- rank {r} ---\n" + (run / f"{r}.log").read_text(
            errors="replace")[-3000:] for r in range(n)
            if (run / f"{r}.log").exists())
    if late:
        raise AssertionError(f"ranks {late} still ran after {timeout} s\n"
                             + logs())
    out = []
    for r in range(n):
        path = run / f"{r}.pkl"
        if not path.exists():
            raise AssertionError(f"rank {r} ended without a result\n"
                                 + logs())
        status, value = pickle.loads(path.read_bytes())
        if status != "ok":
            raise AssertionError(f"rank {r} failed:\n{value}\n" + logs())
        out.append(value)
    return out


def _entry(fn, rank, n, run, payload):
    log = os.open(os.path.join(run, f"{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = sys.stdout
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{run}/init",
                                rank=rank, world_size=n)
        result = ("ok", fn(rank, n, payload))
    except BaseException:   # the parent reports it with the logs
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(run, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the tiny model, its data and its parameters (shared with the parents)
# ---------------------------------------------------------------------------

def tiny_config(seq_axes=None, depth=2, remat_policy="flash"):
    """``tiny_test_config`` (16 heads of 8 over 128 wide) with
    ``seq_axes`` and ``remat_policy``: at 255 patches + the cls token every
    branch clamps to 256 tokens with R = 16, which 2 and 4 shards of 128
    and 64 take."""
    from modaltune_tpu_torch.configs import tiny_test_config
    cfg = tiny_test_config(depth=depth)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, seq_axes=seq_axes, remat_policy=remat_policy))


def tiny_data(n_rows, seed=1, bag_range=(150, 250), bucket=255):
    """``(packer, batch, text)``: one batch of ``n_rows`` synthetic slides
    in one bucket as numpy arrays, and seeded (B, 3, 512) text features."""
    from modaltune_tpu_torch.data import (BucketedLoader, GenePacker,
                                          SyntheticSlideDataset,
                                          synthetic_pathways)
    groups = synthetic_pathways(n_genes=N_GENES, n_groups=12, max_size=7,
                                seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(N_GENES)])
    ds = SyntheticSlideDataset(n_cases=n_rows, in_chans=64,
                               bag_range=bag_range, packer=packer,
                               n_genes=N_GENES, seed=seed)
    (b,) = list(BucketedLoader(ds, buckets=(bucket,), batch_size=n_rows,
                               shuffle=False, prefetch=0,
                               device_prefetch=False))
    batch = dict(bag=b.bag, coords=b.coords, mask=b.mask, genes=b.genes,
                 clinical=None)
    return packer, batch, b.text


def port_model(cfg, packer, state=None):
    """The port's model on the CPU, ``state`` loaded when given (else
    seeded weights), the backbone frozen."""
    from modaltune_tpu_torch import create_aggregator, init_weights
    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=cfg, n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    if state is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: _t(v) for k, v in state.items()})
    return model


def text_targets(text):
    """The projected text targets of ``text`` (B, 3, 512) by a seeded
    projector, (B, 3, D)."""
    from modaltune_tpu_torch import init_weights, project_text
    from modaltune_tpu_torch.train.losses import TextProjector
    proj = init_weights(TextProjector(), torch.Generator().manual_seed(5))
    with torch.no_grad():
        return project_text(proj, _t(text))


def trainable(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def island_worker(rank, n, p):
    """The island on a (1, n) mesh over this rank's tokens of p's q/k/v:
    (declined without a mesh, out, sum(sin(out)), dq, dk, dv)."""
    from modaltune_tpu_torch.ops.dilated_sp import (sp_island_attention,
                                                    use_mesh)
    from modaltune_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n_data=1, n_seq=n)
    s = p["q"].shape[1] // n
    rows = slice(rank * s, (rank + 1) * s)
    q, k, v = (_t(p[x][:, rows]).requires_grad_() for x in "qkv")
    mask = _t(p["mask"][:, rows])
    kw = dict(segment_lengths=p["segs"], dilated_ratios=p["ratios"],
              batch_axis="data", seq_axis="seq")
    declined = sp_island_attention(q, k, v, mask, **kw) is None
    with use_mesh(mesh):
        out = sp_island_attention(q, k, v, mask, **kw)
    loss = torch.sin(out).sum()
    loss.backward()
    return _np((declined, out, loss, q.grad, k.grad, v.grad))


def _tiny_setup(p, seq_axes):
    from modaltune_tpu_torch import freeze_backbone
    from modaltune_tpu_torch.configs import TrainConfig
    packer, batch, text = tiny_data(p["rows"])
    model = port_model(tiny_config(seq_axes, p.get("depth", 2),
                                   p.get("remat_policy", "flash")),
                       packer, p["state"])
    freeze_backbone(model)
    tcfg = TrainConfig(**p.get("tcfg", {}))
    targets = _t(p["targets"]) if "targets" in p else text_targets(text)
    return model, tcfg, {k: _t(v) for k, v in batch.items()}, targets


def sp_grad_worker(rank, n, p):
    """The tiny model with ``seq_axes`` under a (1, n) mesh: the loss and
    the trainable gradients of ``make_grad_step``, and how many spans ran
    on a token shard."""
    import modaltune_tpu_torch.models.longnet as longnet
    from modaltune_tpu_torch import make_grad_step
    from modaltune_tpu_torch.parallel.mesh import make_mesh, use_mesh
    model, tcfg, batch, text = _tiny_setup(p, SEQ_AXES)
    mesh = make_mesh(n_data=1, n_seq=n)
    shards, enter = [], longnet.enter_span

    def counting(x, shard):
        shards.append(shard.n)
        return enter(x, shard)
    longnet.enter_span = counting
    with use_mesh(mesh):
        loss, grads = make_grad_step(model, tcfg)(
            batch, text, torch.Generator().manual_seed(0))
    return _np((loss, grads, shards))


def mesh_step(p, n, seq):
    """``p["steps"]`` steps of ``make_dp_train_step`` (``seq`` 1) or of
    ``make_spmd_train_step`` with the model's ``seq_axes`` set, on an
    (n / seq, seq) mesh: the losses and the trainable parameters after
    them."""
    from modaltune_tpu_torch import make_optimizer
    from modaltune_tpu_torch.parallel.mesh import (data_generator,
                                                   make_dp_train_step,
                                                   make_mesh,
                                                   make_spmd_train_step)
    model, tcfg, batch, text = _tiny_setup(p, SEQ_AXES if seq > 1 else None)
    mesh = make_mesh(n_data=n // seq, n_seq=seq)
    opt = make_optimizer(tcfg, [q for q in model.parameters()
                                if q.requires_grad], p["spe"])
    make = make_spmd_train_step if seq > 1 else make_dp_train_step
    step = make(model, tcfg, opt, mesh)
    gen = data_generator(0, mesh, "cpu")
    losses = [float(step(batch, text, gen)) for _ in range(p["steps"])]
    return _np((losses, trainable(model)))


def mesh_eval(p, n):
    """The eval step (all rows valid, then the last three masked) and the
    embed step under an (n, 1) mesh."""
    from modaltune_tpu_torch import make_eval_step
    from modaltune_tpu_torch.parallel.mesh import make_mesh
    from modaltune_tpu_torch.train.train_step import make_embed_step
    model, tcfg, batch, text = _tiny_setup(p, None)
    mesh = make_mesh(n_data=n)
    rows = text.shape[0]
    ev = make_eval_step(model, tcfg, mesh=mesh)
    logits, loss = ev(batch, text, torch.ones(rows))
    rv = torch.ones(rows)
    rv[-3:] = 0.0
    _, loss_pad = ev(batch, text, rv)
    emb = make_embed_step(model, tcfg, mesh=mesh)(batch)
    return _np((logits, loss, loss_pad, emb))


def mesh_worker(rank, n, p):
    """The jobs of ``p["jobs"]`` in order, each ``("dp", payload)``,
    ``("spmd", payload)`` (a (n / 2, 2) mesh), ``("eval", payload)`` or
    ``("rows", row counts)`` (the rank's ``data_rows`` of each on an (n, 1)
    mesh); -> their results."""
    from modaltune_tpu_torch.parallel.mesh import data_rows, make_mesh
    out = []
    for kind, job in p["jobs"]:
        if kind == "eval":
            out.append(mesh_eval(job, n))
        elif kind == "rows":
            mesh = make_mesh(n_data=n)
            out.append([(data_rows(k, mesh).start, data_rows(k, mesh).stop)
                        for k in job])
        else:
            out.append(mesh_step(job, n, 2 if kind == "spmd" else 1))
    return out


def collectives_worker(rank, n, p):
    """The multi-process helpers on uneven inputs: the gathered embeddings
    and ids, process_sum, global_steps_min, and one DdpGradSync step."""
    from modaltune_tpu_torch.configs import TrainConfig
    from modaltune_tpu_torch.parallel import multihost as mh
    from modaltune_tpu_torch.train.state import TrainOptimizer
    n_local = 3 if rank == 0 else 2
    x = np.full((n_local, 4), float(rank), np.float32) + \
        np.arange(n_local, dtype=np.float32)[:, None]
    ids = [f"case{rank}_{i}" + "x" * rank for i in range(n_local)]
    gathered = mh.allgather_embeddings(x, ids)
    sums = mh.process_sum(np.asarray([1.5 * (rank + 1), rank]))
    steps = mh.global_steps_min(5 - rank)
    # DdpGradSync: rank-dependent gradients of two parameters
    torch.manual_seed(0)
    params = {"a": torch.nn.Parameter(torch.randn(3, 4)),
              "b": torch.nn.Parameter(torch.randn(5))}
    opt = TrainOptimizer(TrainConfig(lr=0.1), params.values(), 1)
    g = torch.Generator().manual_seed(100 + rank)
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    loss = torch.tensor(0.25 * (rank + 1))
    mloss = mh.DdpGradSync(opt, params).step(grads, loss)
    # the mesh over every rank and this rank's rows of a global batch
    mesh = mh.global_mesh()
    rows = mh.global_batch_to_devices(
        {"bag": np.arange(8.0).reshape(4, 2), "clinical": None}, mesh, "cpu")
    return _np((gathered, sums, steps, grads, loss, mloss,
                {k: v.detach() for k, v in params.items()},
                mh.process_datalist(list(range(7))),
                (tuple(mesh.mesh.shape), rows)))


def build_trainer(out_dir, process_shard=None, mesh=None, n_cases=5,
                  pancancer=False, batch_size=1):
    """The tiny DDP / mesh trainer (the JAX package's
    ``tests/_mh_common.py`` on the port), deterministic across calls;
    -> (trainer, initial state dict)."""
    from modaltune_tpu_torch import create_aggregator, init_weights
    from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
    from modaltune_tpu_torch.data import SyntheticSlideDataset
    from modaltune_tpu_torch.train.pancancer_trainer import PanCancerTrainer
    from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
    cfg = tiny_test_config()
    packer = SyntheticSlideDataset(n_cases=1).packer
    sizes = n_cases if isinstance(n_cases, tuple) else (n_cases,) * 3
    datasets = {
        name: SyntheticSlideDataset(
            n_cases=sizes[i], in_chans=cfg.backbone.in_chans,
            bag_range=(40, 80), packer=packer, seed=i + 1,
            n_sites=4 if pancancer else 1)
        for i, name in enumerate(("train", "val", "test"))}
    if pancancer:
        datasets = {k: _FourSites(v) for k, v in datasets.items()}
    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=cfg, n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    init_weights(model, torch.Generator().manual_seed(0))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tcfg = TrainConfig(lr=1e-2 if pancancer else 1e-3,
                       num_epochs=2 if pancancer else 1, warmup_epochs=1,
                       seed=0)
    cls = PanCancerTrainer if pancancer else ModalTuneTrainer
    trainer = cls(model, tcfg, datasets, str(out_dir), buckets=(96,),
                  batch_size=batch_size, process_shard=process_shard,
                  mesh=mesh, device="cpu")
    return trainer, state


class _FourSites:
    """A dataset whose cases are spread over four TCGA projects (the
    synthetic ids name no site)."""
    PROJECTS = ("TCGA-BRCA", "TCGA-GBM", "TCGA-LUAD", "TCGA-KIRC")

    def __init__(self, inner):
        self.inner = inner
        self.packer = inner.packer
        self.case_ids = inner.case_ids

    def __len__(self):
        return len(self.inner)

    def metadata(self):
        return [dict(m, project_id=self.PROJECTS[i % 4])
                for i, m in enumerate(self.inner.metadata())]

    def get(self, i, rng):
        return self.inner.get(i, rng)


def ddp_trainer_worker(rank, n, p):
    """The 2-process DDP trainer (``process_shard``), each rank in its own
    run directory, rank 1's holding a stale ``best_model_weights.pt``:
    the val metrics before training, whether rank 1 wrote eval files, the
    step cap, and after ``run()`` the trainable tensors and rank 0's best
    weights file."""
    from pathlib import Path
    out = Path(p["dirs"][rank])
    trainer, state = build_trainer(out, process_shard=(rank, n))
    if rank == 1:
        out.mkdir(parents=True, exist_ok=True)
        torch.save({k: torch.zeros_like(v) for k, v in state.items()},
                   out / "best_model_weights.pt")
    trainer.init_state(state)
    trainer.fit_readout_heads()
    metrics = trainer.evaluate("val")
    wrote = (out / "confusion_val.json").exists()
    cap = trainer._steps_cap
    trainer.run(state)
    best = torch.load(Path(p["dirs"][0]) / "best_model_weights.pt",
                      weights_only=True)
    return _np((metrics, wrote, cap, trainer.model.state_dict(), best))


def mesh_pancancer_worker(rank, n, p):
    """PanCancerTrainer under an (n, 1) mesh, batch 4 over 14 train cases
    (the last batch wrap-padded), given trained parameters: the val
    metrics."""
    from modaltune_tpu_torch.parallel.mesh import make_mesh
    trainer, _ = build_trainer(p["dir"] + f"/{rank}", mesh=make_mesh(n),
                               n_cases=(14, 10, 10), pancancer=True,
                               batch_size=4)
    trainer.init_state({k: _t(v) for k, v in p["state"].items()})
    trainer.fit_readout_heads()
    return trainer.evaluate("val")


def moe_worker(rank, n, p):
    """Expert parallelism over the group, for each gate type of
    ``p["gate_types"]``: this rank's token rows of ``p["x"]`` through
    ``MoeFeedForward(group=WORLD)`` holding its share of the experts of
    ``p["state"]``, loss ``sum(sin(out))``: (out, its gradient to x, to
    the local w1/b1/w2/b2 and the gate); then ``all_to_all_dim`` alone on
    dims 0 and 1 and its gradient."""
    import torch.distributed as dist
    from modaltune_tpu_torch.models.extras import MoeFeedForward
    from modaltune_tpu_torch.parallel.collectives import all_to_all_dim
    state = {k: _t(v) for k, v in p["state"].items()}
    e, d, f = p["experts"], state["w1"].shape[1], state["w1"].shape[2]
    local = e // n
    s = p["x"].shape[1] // n
    runs = {}
    for gate_type in p["gate_types"]:
        moe = MoeFeedForward(d, f, e, capacity_factor=p["capacity_factor"],
                             gate_type=gate_type,
                             group=dist.group.WORLD).eval()
        moe.load_state_dict({k: v if k == "gate.weight"
                             else v[rank * local:(rank + 1) * local]
                             for k, v in state.items()})
        x = _t(p["x"][:, rank * s:(rank + 1) * s]).requires_grad_()
        out, _ = moe(x)
        torch.sin(out).sum().backward()
        runs[gate_type] = (out, x.grad, {k: v.grad for k, v in
                                         moe.named_parameters()})

    a = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6) + 100 * rank
    b = (torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n * 3)
         + 100 * rank).requires_grad_()
    ex_a = all_to_all_dim(a, 0)
    ex_b = all_to_all_dim(b, 1)
    (ex_b * (rank + 1)).sum().backward()
    return _np((runs, ex_a, ex_b, b.grad))
