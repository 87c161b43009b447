"""The port's data-parallel and mesh steps against the JAX package's and
against the port's own single-device steps, on the CPU (gloo ranks).

* ``make_dp_train_step`` on 2 and 4 ranks, each on its rows of a 4-row
  batch, two steps: against JAX's ``make_dp_train_step`` on a 4-device CPU
  mesh from the same parameters (``params_from_jax``) and text targets,
  and against the port's ``make_train_step`` on the whole batch;
* the mesh-aware eval and embed steps on 2 ranks with 3 masked wrap rows,
  as ``tests/test_parallel.py`` holds JAX's: the logits, the loss over all
  rows and over the real rows alone, the embeddings;
* ``make_spmd_train_step`` on a ``(2, 2)`` mesh, the model's ``seq_axes``
  set: its loss is the single-device step's.

Tolerances as ``tests/test_torch_train.py`` holds the train step: losses
at 3e-5 (the KD loss's fp32 floor), parameters after the steps within 2 %
of the tensor's update with the loss scaled by 1e-8 so that AdamW's step
is proportional to the gradient (``NULL_GRAD`` tensors against the
largest update of all). The ranks run with ``tests/_torch_mp.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as tmp_ranks
from modaltune_tpu.configs import TrainConfig as JTrainConfig
from modaltune_tpu.configs import tiny_test_config as j_tiny_config
from modaltune_tpu.models import ModalTuneModel as JaxModalTune
from modaltune_tpu.parallel.mesh import make_dp_train_step as j_dp_step
from modaltune_tpu.parallel.mesh import make_mesh as j_make_mesh
from modaltune_tpu.train import TextProjector as JaxTextProjector
from modaltune_tpu.train import TrainState
from modaltune_tpu.train import make_optimizer as j_make_optimizer
from modaltune_tpu.train import project_text as j_project_text
from modaltune_tpu_torch import (make_embed_step, make_eval_step,
                                 make_optimizer, make_train_step,
                                 params_from_jax)

torch.set_num_threads(2)

LOSS_TOL = 3e-5
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")
TCFG = dict(lr=0.2, kd_loss_scale=1e-8)
ROWS, STEPS, SPE = 4, 2, 3


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's data-parallel step on a 4-device mesh, two steps on a 4-row
    batch of the tiny model; the port's payload from the same parameters
    and text targets."""
    packer, batch, text = tmp_ranks.tiny_data(ROWS)
    jcfg = j_tiny_config()
    jmodel = JaxModalTune(jcfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if v is not None}
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"][:1], jb["coords"][:1], jb["genes"][:1],
        task_token=jnp.eye(3)[:1], bag_mask=jb["mask"][:1])["params"])(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)         # Injectors are identities at init
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    jproj = JaxTextProjector()
    proj_params = jproj.init(jax.random.PRNGKey(99),
                             jnp.zeros((1, 4, 512)))["params"]
    targets = np.asarray(j_project_text(jproj, proj_params,
                                        jnp.asarray(text)))
    tcfg = JTrainConfig(**TCFG)
    state = TrainState.create(params, j_make_optimizer(tcfg, SPE))
    step = j_dp_step(jmodel, tcfg, j_make_mesh(n_data=4, n_seq=1))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jb, jnp.asarray(targets),
                           jax.random.PRNGKey(i))
        losses.append(float(loss))
    model = tmp_ranks.port_model(tmp_ranks.tiny_config(), packer)
    p0 = {k: v.numpy() for k, v in params_from_jax(params, model).items()}
    want = params_from_jax(dict(jax.device_get(state.trainable),
                                backbone=params["backbone"]), model)
    payload = dict(rows=ROWS, state=p0, targets=targets, tcfg=TCFG,
                   steps=STEPS, spe=SPE)
    return dict(losses=losses, params=want, payload=payload)


def _one_device(payload, steps):
    """The port's single-device train step on the whole batch."""
    model, tcfg, batch, text = tmp_ranks._tiny_setup(payload, None)
    opt = make_optimizer(tcfg, [p for p in model.parameters()
                                if p.requires_grad], SPE)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, text, gen)) for _ in range(steps)]
    return losses, tmp_ranks.trainable(model)


def _eval_payload(jax_dp):
    """The dp payload's parameters after three single-device steps at a
    larger rate (a near-uniform softmax would hide mixed-up rows), on an
    8-row batch."""
    p = dict(jax_dp["payload"], rows=8, tcfg=dict(lr=1e-2))
    p.pop("targets")
    model, tcfg, batch, text = tmp_ranks._tiny_setup(p, None)
    opt = make_optimizer(tcfg, [q for q in model.parameters()
                                if q.requires_grad], 1)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        step(batch, text, gen)
    return dict(p, state={k: v.detach().numpy().copy()
                          for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def ranks(jax_dp, tmp_path_factory):
    """The 2-rank run (the dp step, the mesh eval and embed) and the
    4-rank run (the dp step, the (2, 2) spmd step)."""
    dp = jax_dp["payload"]
    spmd = dict(dp, steps=1)
    spmd.pop("targets")          # the port's own projector: no JAX here
    ev = _eval_payload(jax_dp)
    tmp = tmp_path_factory.mktemp("ranks")
    two = tmp_ranks.run_ranks(tmp_ranks.mesh_worker, 2, tmp, dict(
        jobs=[("dp", dp), ("eval", ev), ("rows", (3, 4))]))
    four = tmp_ranks.run_ranks(tmp_ranks.mesh_worker, 4, tmp, dict(
        jobs=[("dp", dp), ("spmd", spmd)]))
    return {2: two, 4: four, "eval": ev, "spmd": spmd}


def _hold_params(got, want, p0):
    upd = {n: float(np.abs(np.asarray(want[n]) - p0[n]).max()) for n in got}
    upd_all = max(upd.values())
    assert upd_all > 0
    for n in got:
        scale = upd_all if n.endswith(NULL_GRAD) else upd[n]
        err = float(np.abs(np.asarray(got[n]) - np.asarray(want[n])).max())
        assert err <= 0.02 * scale, (n, err, scale)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_train_step_matches_jax_and_one_device(jax_dp, ranks, n):
    """Each rank's losses and parameters after two data-parallel steps on
    its rows: equal on every rank, and equal to JAX's data-parallel step
    and to the port's single-device step on the whole batch."""
    p0 = jax_dp["payload"]["state"]
    results = [r[0] for r in ranks[n]]
    for losses, params in results[1:]:
        assert losses == results[0][0]
        for k in params:
            np.testing.assert_array_equal(params[k], results[0][1][k])
    losses, params = results[0]
    np.testing.assert_allclose(losses[0], jax_dp["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_dp["losses"], rtol=LOSS_TOL)
    want = {k: v.numpy() for k, v in jax_dp["params"].items()}
    _hold_params(params, want, p0)
    one_losses, one_params = _one_device(jax_dp["payload"], STEPS)
    np.testing.assert_allclose(losses, one_losses, rtol=LOSS_TOL)
    _hold_params(params, {k: v.numpy() for k, v in one_params.items()}, p0)


def test_mesh_eval_and_embed_match_one_device(ranks):
    """The eval and embed steps on 2 ranks (4 rows each): the logits and
    embeddings, whole and in row order on every rank, equal the
    single-device steps' (2e-5); the loss too (2e-4, JAX's bar); with the
    last 3 rows masked as wrap padding, the loss equals the single-device
    loss of the 5 real rows alone."""
    p = ranks["eval"]
    model, tcfg, batch, text = tmp_ranks._tiny_setup(p, None)
    logits, loss = make_eval_step(model, tcfg)(batch, text, torch.ones(8))
    real = {k: None if v is None else v[:5] for k, v in batch.items()}
    _, loss_real = make_eval_step(model, tcfg)(real, text[:5], torch.ones(5))
    emb = make_embed_step(model, tcfg)(batch)
    for r in ranks[2]:
        g_logits, g_loss, g_pad, g_emb = r[1]
        np.testing.assert_allclose(g_logits, logits.numpy(), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(float(g_loss), float(loss), rtol=2e-4)
        np.testing.assert_allclose(float(g_pad), float(loss_real), rtol=2e-4)
        np.testing.assert_allclose(g_emb, emb.numpy(), atol=2e-5, rtol=2e-5)


def test_spmd_train_step_matches_one_device(ranks):
    """``make_spmd_train_step`` on a ``(2, 2)`` mesh with the model's
    ``seq_axes`` set (rows over ``data``, backbone spans over ``seq``): the
    loss of every rank equals the single-device step's, and so do the
    parameters after the step."""
    p = ranks["spmd"]
    one_losses, one_params = _one_device(p, 1)
    want = {k: v.numpy() for k, v in one_params.items()}
    for r in ranks[4]:
        losses, params = r[1]
        np.testing.assert_allclose(losses, one_losses, rtol=LOSS_TOL)
        _hold_params(params, want, p["state"])


def test_shard_batch_keeps_uneven_axes_whole(ranks):
    """A batch of 3 rows on 2 data ranks is not split (JAX's
    ``shard_batch`` keeps an axis it cannot divide whole); 4 rows are, by
    the rank's data coordinate."""
    assert [r[2] for r in ranks[2]] == [[(0, 3), (0, 2)], [(0, 3), (2, 4)]]
