"""The two sides of ``test_torch_multiepoch.py``: the cohort, the schedule
and the three cases they share, and one run of a case by the JAX package's
``ModalTuneTrainer`` or by the port's, each with the record the test holds.

The test runs each JAX run in a process of its own:

    python tests/_multiepoch.py CASE INIT_PICKLE OUT_DIR

The ``DRAWS_INIT`` case draws the initial parameters and the text projector
(``initial_params``) into ``INIT_PICKLE``, the others wait for them there;
each writes its run's directory (``run_metrics.jsonl`` among its files) and
``record.pkl`` (the run's record) into ``OUT_DIR``.
"""

import pickle
import sys
import time
from pathlib import Path

import numpy as np

EPOCHS = 14
SCHEDULE = dict(lr=5e-4, weight_decay=0.01, num_epochs=EPOCHS,
                warmup_epochs=10, warmup_factor=20.0, temperature=1.0)
# run: the whole ``run()`` (eval every epoch, the test stage with the best
# weights); else ``init_state`` and ``train_one_epoch`` EPOCHS times
CASES = {
    "default": dict(train={}, n_train=6, run=True),
    "grad_accum2": dict(train=dict(grad_accum=2), n_train=6, run=False),
    "quirks8": dict(train=dict(reference_quirks=True), n_train=8, run=False),
}
SPLIT_SEEDS = {"train": 0, "val": 1, "test": 2}
BAG_RANGE = (20, 40)
BUCKETS = (48,)
INIT_TIMEOUT = 300
# the JAX run that draws the initial parameters for every run: the longest,
# which would otherwise wait for them
DRAWS_INIT = "default"


def splits(synthetic, n_train):
    """The cohort, from either package's ``SyntheticSlideDataset``."""
    packer = synthetic(n_cases=1).packer
    sizes = {"train": n_train, "val": 12, "test": 12}
    return {name: synthetic(n_cases=sizes[name], in_chans=64,
                            bag_range=BAG_RANGE, packer=packer, seed=seed,
                            learnable=True)
            for name, seed in SPLIT_SEEDS.items()}, packer


def jax_model():
    from modaltune_tpu.configs import tiny_test_config
    from modaltune_tpu.data import SyntheticSlideDataset
    from modaltune_tpu.models import ModalTuneModel
    cfg = tiny_test_config()
    packer = SyntheticSlideDataset(n_cases=1).packer
    return ModalTuneModel(cfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len), cfg


def initial_params():
    """The JAX model's parameters, the Injector gammas perturbed (they are
    identities at init), and the text projector's parameters that the JAX
    trainer draws."""
    import jax
    import jax.numpy as jnp
    from modaltune_tpu.data import SyntheticSlideDataset
    from modaltune_tpu.train.losses import TextProjector
    model, _ = jax_model()
    datasets, _ = splits(SyntheticSlideDataset, 6)
    ex = datasets["train"].get(0, np.random.RandomState(0))
    params = jax.jit(lambda key: model.init(
        key, jnp.asarray(ex.bag[None]), jnp.asarray(ex.coords[None]),
        jnp.asarray(ex.genes[None]), task_token=jnp.eye(3)[:1])["params"])(
            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    # the trainer's projector: ModalTuneTrainer.__init__ at seed 0
    proj = TextProjector().init(jax.random.PRNGKey(0 + 12345),
                                jnp.zeros((1, 4, 512)))["params"]
    return params, jax.tree_util.tree_map(np.asarray, jax.device_get(proj))


def _recorder(trainer, record: dict, trainable):
    """Wrap ``trainer``'s ``save_weights`` and ``load_weights`` to record
    the epochs that saved the best weights and the trainable parameters
    after the last epoch (before ``run()`` loads the best weights)."""
    save_weights, load_weights = trainer.save_weights, trainer.load_weights

    def recorded_save_weights(name):
        record["best"].append(trainer.current_epoch)
        save_weights(name)

    def recorded_load_weights(path, strict=True):
        record["final"] = trainable()
        load_weights(path, strict)

    trainer.save_weights = recorded_save_weights
    trainer.load_weights = recorded_load_weights


def _drive(trainer, params, case: str, record: dict, trainable) -> dict:
    if CASES[case]["run"]:
        trainer.run(params)
    else:
        trainer.init_state(params)
        record["losses"] = [trainer.train_one_epoch() for _ in range(EPOCHS)]
    if record["final"] is None:
        record["final"] = trainable()
    return record


def _schedule_count(opt_state) -> int:
    """Applied updates so far: the count of optax's schedule state, which
    ``optax.MultiSteps`` advances only on an applied update."""
    import jax
    import optax
    is_state = lambda s: isinstance(s, optax.ScaleByScheduleState)  # noqa
    (state,) = [s for s in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=is_state)
                if is_state(s)]
    return int(state.count)


def jax_run(case: str, params: dict, out_dir: Path) -> dict:
    """One JAX trainer run of ``case`` from ``params`` -> its record: the
    epochs' mean losses (``None`` after ``run()``: they are in
    ``run_metrics.jsonl``), the learning rate of every applied update (the
    optax schedule at the update count), the epochs that saved the best
    weights, the parameters after the last epoch (a JAX tree) and the text
    projector the trainer drew itself (the test holds the one the port is
    given equal to it)."""
    import jax
    import modaltune_tpu.train.trainer as trainer_module
    from modaltune_tpu.configs import TrainConfig
    from modaltune_tpu.data import SyntheticSlideDataset
    from modaltune_tpu.train.state import warmup_cosine_epoch_schedule
    model, cfg = jax_model()
    datasets, _ = splits(SyntheticSlideDataset, CASES[case]["n_train"])
    trainer = trainer_module.ModalTuneTrainer(
        model, TrainConfig(**SCHEDULE, **CASES[case]["train"]), datasets,
        str(out_dir), buckets=BUCKETS, model_cfg=cfg)
    record = dict(losses=None, lrs=[], best=[], final=None,
                  proj=jax.device_get(trainer.proj_params))
    schedules = []
    make_optimizer = trainer_module.make_optimizer

    def recorded_make_optimizer(tcfg, steps_per_epoch):
        schedules.append(warmup_cosine_epoch_schedule(tcfg, steps_per_epoch))
        return make_optimizer(tcfg, steps_per_epoch)

    trainer_module.make_optimizer = recorded_make_optimizer
    init_state = trainer.init_state

    def recorded_init_state(params, frozen_dtype=None):
        state = init_state(params, frozen_dtype=frozen_dtype)
        step = trainer._train_step

        def train_step(state, *args):
            before = _schedule_count(state.opt_state)
            state, loss = step(state, *args)
            if _schedule_count(state.opt_state) > before:
                record["lrs"].append(float(schedules[-1](before)))
            return state, loss

        trainer._train_step = train_step
        return state

    trainer.init_state = recorded_init_state

    def trainable():
        return jax.tree_util.tree_map(np.asarray,
                                      jax.device_get(trainer.state.params))

    _recorder(trainer, record, trainable)
    return _drive(trainer, params, case, record, trainable)


def port_run(case: str, params: dict, proj: dict, out_dir: Path) -> dict:
    """The port's run of ``case`` from ``params_from_jax(params)`` and
    ``projector_from_jax(proj)`` -> the record of :func:`jax_run`, the
    learning rates as ``(lr() before the update, the rate AdamW applied)``
    and the parameters by the port's names."""
    from modaltune_tpu_torch import (create_aggregator, params_from_jax,
                                     projector_from_jax)
    from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
    from modaltune_tpu_torch.data import SyntheticSlideDataset
    from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
    cfg = tiny_test_config()
    datasets, packer = splits(SyntheticSlideDataset, CASES[case]["n_train"])
    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=cfg, n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    trainer = ModalTuneTrainer(
        model, TrainConfig(**SCHEDULE, **CASES[case]["train"]), datasets,
        str(out_dir), buckets=BUCKETS, model_cfg=cfg,
        projector=projector_from_jax(proj))
    record = dict(losses=None, lrs=[], best=[], final=None)
    init_state = trainer.init_state

    def recorded_init_state(params, frozen_dtype=None):
        opt = init_state(params, frozen_dtype=frozen_dtype)
        step = opt.step

        def recorded_step():
            lr = opt.lr()
            applied = step()
            if applied:
                record["lrs"].append((lr, opt.adamw.param_groups[0]["lr"]))
            return applied

        opt.step = recorded_step
        return opt

    trainer.init_state = recorded_init_state

    def trainable():
        return {n: p.detach().numpy().copy()
                for n, p in trainer._trainable().items()}

    _recorder(trainer, record, trainable)
    return _drive(trainer, params_from_jax(params, model), case, record,
                  trainable)


def write(path: Path, obj) -> None:
    """Pickle ``obj`` to ``path`` whole: written beside it, then renamed."""
    part = path.with_suffix(".part")
    with open(part, "wb") as f:
        pickle.dump(obj, f)
    part.rename(path)


def wait_for(path: Path):
    """The object :func:`write` pickled to ``path``."""
    deadline = time.time() + INIT_TIMEOUT
    while not path.exists():
        assert time.time() < deadline, f"no {path}"
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import modaltune_tpu.train.trainer  # noqa: F401  (before the wait)
    case, init_path, out = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    if case == DRAWS_INIT:
        init_params, init_proj = initial_params()
        write(init_path, (init_params, init_proj))
    else:
        init_params, _ = wait_for(init_path)
    write(out / "record.pkl", jax_run(case, init_params, out))
