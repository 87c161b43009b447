"""The port's training path against the JAX package's, on the CPU, in fp32.

The same numpy inputs, made from a seed, go through both packages:

* (a) autograd through the port's ``flash_attention_reference`` against
  ``jax.grad`` of JAX's, with masked keys and a row whose keys are all
  masked;
* (b) ``flash_attention_backward_reference`` (the K2b kernel's oracle)
  against the rules of the custom VJP of JAX's Pallas flash attention in
  interpret mode;
* (c) autograd through the port's ``dilated_attention`` against
  ``jax.grad`` of JAX's plain ``dilated_attention`` and of its mega kernel
  in interpret mode (the branch mix weights carry no gradient);
* (d) the plain per-branch statistics (the K1f stats plane the K1b kernel
  reads) against the stats plane of JAX's mega forward kernel;
* (e) the KD loss, the text projection, the schedule and the optimizer;
* (f) the eval step and the whole train step for three steps from
  identical parameters.

The CUDA kernels do not run here; ``chip_smoke.py`` holds each against
these plain versions on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from modaltune_tpu.configs import TrainConfig, tiny_test_config
from modaltune_tpu.data import (BucketedLoader, GenePacker,
                                SyntheticSlideDataset, synthetic_pathways)
from modaltune_tpu.models import ModalTuneModel as JaxModalTune
from modaltune_tpu.ops.dilated import dilated_attention as j_dilated
from modaltune_tpu.ops.dilated_fused import comb, to_head_major, uncomb
from modaltune_tpu.ops.dilated_mega import (_mega_fwd_call, make_mega_plans,
                                            mega_dilated_attention as j_mega)
from modaltune_tpu.ops.flash_attention import (_bwd_pallas, _fwd_pallas,
                                               flash_attention_reference
                                               as j_flash_ref)
from modaltune_tpu.train import TextProjector as JaxTextProjector
from modaltune_tpu.train import TrainState
from modaltune_tpu.train import kd_loss as j_kd_loss
from modaltune_tpu.train import make_eval_step as j_make_eval_step
from modaltune_tpu.train import make_optimizer as j_make_optimizer
from modaltune_tpu.train import make_train_step as j_make_train_step
from modaltune_tpu.train import project_text as j_project_text
from modaltune_tpu.train import warmup_cosine_epoch_schedule as j_schedule
from modaltune_tpu.train.train_step import make_grad_step as j_make_grad_step
from modaltune_tpu_torch import (create_aggregator, freeze_backbone, kd_loss,
                                 make_eval_step, make_grad_step,
                                 make_optimizer, make_train_step,
                                 params_from_jax, project_text,
                                 projector_from_jax)
from modaltune_tpu_torch.ops import (NEG_INF, dilated_attention,
                                     flash_attention,
                                     flash_attention_reference,
                                     mega_dilated_attention)
from modaltune_tpu_torch.ops.dilated import dilated_attention_stats
from modaltune_tpu_torch.ops.flash_attention import \
    flash_attention_backward_reference
from modaltune_tpu_torch.train import batch_to_device
from modaltune_tpu_torch.train.state import warmup_cosine_epoch_schedule

torch.set_num_threads(2)

# Both sides run the same fp32 algorithm on two CPU backends; only the
# summation order and libm rounding differ.
TOL = 1e-5
# The KD loss is the KL of two near-uniform 256-way softmaxes (normalised
# embeddings over temperature): fp32 cancellation alone moves either side
# by ~1e-5 relative. The train-step test measures that floor as JAX against
# itself in a second summation order (2.3e-5 on its embeddings; 7e-6 to
# 2.2e-5 between the two packages).
LOSS_TOL = 3e-5

SEGS = (64, 128, 512, 96)
RATIOS = (1, 2, 4, 2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flash_case(seed, bh, lq, lk, d, masked):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(bh, n, d).astype(np.float32)
                    for n in (lq, lk, lk, lq))
    bias = None
    if masked:
        valid = rng.rand(bh, lk) >= 0.3
        valid[:, 0] = True
        valid[-1] = False                       # a bh with every key masked
        bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias, cot


FLASH_CASES = [
    (2, 40, 33, 16, True),
    (2, 300, 65, 16, False),        # Injector-style: tall q, short k
    (2, 65, 300, 16, True),         # Extractor-style: short q, tall k
    (2, 33, 70, 48, True),
]


def _jax_flash_grads(fn, q, k, v, bias, cot):
    jb = None if bias is None else jnp.asarray(bias)
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c, jb)[0] * cot),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))


@pytest.mark.parametrize("bh,lq,lk,d,masked", FLASH_CASES)
def test_flash_reference_grads_match_jax(bh, lq, lk, d, masked):
    """(a) Backward through the plain version works (it raised on an
    in-place op before), and its gradients are JAX's."""
    q, k, v, bias, cot = _flash_case(lq + lk, bh, lq, lk, d, masked)
    want = _jax_flash_grads(j_flash_ref, q, k, v, bias, cot)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tb = None if bias is None else _t(bias)
    out, lse = flash_attention_reference(tq, tk, tv, tb)
    assert not lse.requires_grad
    (out * _t(cot)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")
    if masked:
        dead = ~(bias > NEG_INF / 2)
        assert (tk.grad.numpy()[dead] == 0).all()      # masked keys
        assert (tv.grad.numpy()[dead] == 0).all()
        assert (tq.grad.numpy()[-1] == 0).all()        # the dead bh


@pytest.mark.parametrize("bh,lq,lk,d,masked", FLASH_CASES)
def test_flash_backward_reference_matches_jax_vjp(bh, lq, lk, d, masked):
    """(b) The K2b oracle against the VJP of JAX's Pallas kernel (its
    ``_dq_kernel``/``_dkv_kernel``) in interpret mode; the public
    ``flash_attention`` takes the same gradient on CPU tensors."""
    q, k, v, bias, cot = _flash_case(lq * 3 + lk, bh, lq, lk, d, masked)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jbias = None if bias is None else jnp.asarray(bias)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        # the VJP's rules called directly: with a bias, jax.grad of
        # _flash_pallas rejects the (BH, 1, Lk) zero cotangent _bwd_pallas
        # returns for the (BH, Lk) bias (ROADMAP F6); dq/dk/dv are whole
        jout, jlse = _fwd_pallas(jq, jk, jv, jbias, scale, 64, 64)
        want = _bwd_pallas(scale, 64, 64, (jq, jk, jv, jbias, jout, jlse),
                           (jnp.asarray(cot), None))[:3]
    tb = None if bias is None else _t(bias)
    out, lse = flash_attention_reference(_t(q), _t(k), _t(v), tb)
    got = flash_attention_backward_reference(_t(q), _t(k), _t(v), tb, out,
                                             lse, _t(cot))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o2, _ = flash_attention(tq, tk, tv, tb)
    (o2 * _t(cot)).sum().backward()
    for g, x in zip(got, (tq, tk, tv)):
        np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def _dil_case(seed, b=2, length=256, h=4, d=32):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(b, length, h, d).astype(np.float32)
                    for _ in range(4))
    lens = rng.randint(length // 2, length + 1, size=b)
    mask = np.arange(length)[None, :] < lens[:, None]
    return q, k, v, mask, cot * mask[:, :, None, None]


def test_dilated_grads_match_jax():
    """(c) Autograd through the plain dilated attention: the mix weights
    are stop-gradient, as in JAX (a softmax that lets the gradient through
    the branch lses gives other gradients)."""
    q, k, v, mask, cot = _dil_case(5, b=1, d=16)
    kw = dict(segment_lengths=SEGS, dilated_ratios=RATIOS)
    jm = jnp.asarray(mask)
    args = [jnp.asarray(x) for x in (q, k, v)]
    want = jax.grad(lambda a, b, c: jnp.sum(j_dilated(
        a, b, c, mask=jm, use_pallas=False, **kw) * cot),
        argnums=(0, 1, 2))(*args)
    want_mega = jax.grad(lambda a, b, c: jnp.sum(j_mega(
        a, b, c, mask=jm, interpret=True, **kw) * cot),
        argnums=(0, 1, 2))(*args)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = mega_dilated_attention(tq, tk, tv, mask=_t(mask), **kw)
    (out * _t(cot)).sum().backward()
    valid = mask[:, :, None, None]
    for name, got, w, wm in zip("qkv", (tq.grad, tk.grad, tv.grad), want,
                                want_mega):
        got = got.numpy()
        np.testing.assert_allclose(got, np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name} vs dilated_attention")
        np.testing.assert_allclose(got * valid, np.asarray(wm) * valid,
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"d{name} vs the mega kernel")
    # the plain dilated_attention itself is what the dispatcher ran
    tq2 = _t(q).requires_grad_()
    (dilated_attention(tq2, _t(k), _t(v), mask=_t(mask), **kw)
     * _t(cot)).sum().backward()
    np.testing.assert_array_equal(tq2.grad.numpy(), tq.grad.numpy())


def test_dilated_mix_weights_carry_no_gradient(monkeypatch):
    """(c) The stop-gradient is the mix's own: with branch attentions whose
    lse is differentiable (as JAX's plain flash attention's is), the
    gradients are still JAX's, whose mix stops them."""

    def lse_with_grad(q, k, v, bias, scale):
        out, lse = flash_attention_reference(q, k, v, bias, scale)
        s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale \
            + bias[:, None, :]
        return out, torch.where(lse > NEG_INF / 2,
                                torch.logsumexp(s, dim=-1), NEG_INF)

    monkeypatch.setattr("modaltune_tpu_torch.ops.dilated."
                        "flash_attention_reference", lse_with_grad)
    q, k, v, mask, cot = _dil_case(7, b=1, length=128, h=4, d=16)
    kw = dict(segment_lengths=(32, 128), dilated_ratios=(1, 2))
    want = jax.grad(lambda a: jnp.sum(j_dilated(
        a, jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
        use_pallas=False, **kw) * cot))(jnp.asarray(q))
    tq = _t(q).requires_grad_()
    (dilated_attention(tq, _t(k), _t(v), mask=_t(mask), **kw)
     * _t(cot)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_dilated_stats_match_jax_stats_plane():
    """(d) Per-branch lse, m and Z of the plain version against the stats
    plane JAX's mega forward kernel writes for its backward."""
    q, k, v, mask, _ = _dil_case(6)
    b, length, h, d = q.shape
    segs, ratios = (64, 128, 512, 80), (1, 2, 4, 4)
    R, plans = make_mega_plans(length, segs, ratios)
    qc, kc, vc = (comb(to_head_major(jnp.asarray(x)), R) for x in (q, k, v))
    vmask = comb(jnp.asarray(mask, jnp.float32), R)
    bias = jnp.where(vmask > 0.5, 0.0, NEG_INF).astype(jnp.float32)[:, None]
    _, stats = _mega_fwd_call(plans, qc, kc, vc, bias, length, h, d ** -0.5,
                              interpret=True)
    want = np.asarray(uncomb(jnp.swapaxes(stats, 1, 2), R)).swapaxes(1, 2)
    got = dilated_attention_stats(_t(q), _t(k), _t(v), segment_lengths=segs,
                                  dilated_ratios=ratios, mask=_t(mask))
    assert got.shape == want.shape == (b * h, len(segs) + 2, length)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    lse = got.numpy()[:, :len(segs)]
    assert (lse == NEG_INF).any() and (lse > NEG_INF / 2).any()


# ---------------------------------------------------------------------------
# (e) loss, text projection, schedule, optimizer
# ---------------------------------------------------------------------------

def _projectors(seed=99):
    jp = JaxTextProjector()
    params = jp.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 512)))
    params = jax.device_get(params["params"])
    return jp, params, projector_from_jax(params)


def test_kd_loss_and_text_projection_match_jax():
    rng = np.random.RandomState(1)
    text = rng.randn(2, 4, 512).astype(np.float32)
    logits = rng.randn(2, 3, 256).astype(np.float32)
    jp, params, proj = _projectors()
    want_t = j_project_text(jp, params, jnp.asarray(text))
    got_t = project_text(proj, _t(text))
    assert got_t.shape == (2, 3, 256)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=TOL,
                               rtol=TOL)
    for temperature, scale in ((1.0, 10.0), (0.5, 1.0)):
        want = j_kd_loss(jnp.asarray(logits), want_t, temperature, scale)
        got = kd_loss(_t(logits), got_t, temperature, scale)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


def test_schedule_matches_jax():
    for cfg, spe in ((TrainConfig(), 7), (TrainConfig(
            lr=3e-3, num_epochs=5, warmup_epochs=0), 2)):
        j_sched = j_schedule(cfg, spe)
        sched = warmup_cosine_epoch_schedule(cfg, spe)
        for step in range(0, spe * (cfg.num_epochs + 2)):
            np.testing.assert_allclose(sched(step), float(j_sched(step)),
                                       rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("grad_accum", [1, 3])
def test_optimizer_matches_optax(grad_accum):
    """AdamW with the epoch schedule (and optax.MultiSteps accumulation)
    against optax on the same gradients: the learning rate is indexed by
    applied updates, the decay is decoupled and reaches every tensor."""
    cfg = TrainConfig(lr=1e-2, num_epochs=4, warmup_epochs=2,
                      grad_accum=grad_accum)
    spe = 2
    rng = np.random.RandomState(grad_accum)
    p0 = {"w": rng.randn(5, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32)}
    tx = j_make_optimizer(cfg, spe)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jparams)
    tparams = {n: torch.nn.Parameter(_t(a.copy())) for n, a in p0.items()}
    opt = make_optimizer(cfg, tparams.values(), spe)
    j_sched = j_schedule(cfg, spe)
    for micro in range(8 * grad_accum):
        grads = {n: rng.randn(*a.shape).astype(np.float32)
                 for n, a in p0.items()}
        if micro % grad_accum == grad_accum - 1:
            np.testing.assert_allclose(opt.lr(), float(j_sched(opt.updates)),
                                       rtol=1e-6)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams.items():
            g = _t(grads[n])
            p.grad = g if p.grad is None else p.grad + g
        applied = opt.step()
        assert applied == (micro % grad_accum == grad_accum - 1)
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{n} @ {micro}")
    assert opt.updates == 8


# ---------------------------------------------------------------------------
# (f) the train step
# ---------------------------------------------------------------------------

N_GENES = 60
# Exactly zero gradients in exact arithmetic, fp32 noise in practice: an
# attention key bias (softmax is shift invariant) and the gene mixer's
# per-token biases (a constant over channels, which every later LayerNorm
# removes). Each framework's noise is its own.
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")


def _kd_loss_floor(logits, targets, n_orders=16):
    """Largest relative change of JAX's KD loss when the embedding
    channels of both inputs are permuted: the loss is invariant to that in
    exact arithmetic, so this is its fp32 floor in other summation orders."""
    base = float(j_kd_loss(logits, targets))
    return max(abs(float(j_kd_loss(logits[..., p], targets[..., p])) - base)
               / abs(base) for p in (np.random.RandomState(s).permutation(
                   logits.shape[-1]) for s in range(n_orders)))


def test_train_step_matches_jax():
    """(f) on the default route of both packages."""
    train_step_against_jax()


def test_per_branch_route_train_step_matches_jax(monkeypatch):
    """(f) on the per-branch route of both packages (``fused_attention``
    off, the CLI's ``--fused_attention 0``): the port runs every dilated
    branch through ``flash_attention`` (K2f, and K2b's autograd Function,
    on CPU tensors their plain versions) and neither K1 nor K3, JAX its
    own per-branch dilated attention."""
    import modaltune_tpu_torch.models.longnet as port_longnet
    import modaltune_tpu_torch.ops.dilated as port_dilated
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(port_dilated, "flash_attention", counted)
    monkeypatch.setattr(port_longnet, "mega_dilated_attention", None)
    monkeypatch.setattr(port_longnet, "fused_dilated_attention", None)
    cfg = tiny_test_config(depth=4)     # train_step_against_jax's
    train_step_against_jax(
        port_kw=dict(longnet=cfg.backbone.longnet(fused_attention=False)),
        jax_backbone_kw=dict(fused_attention=False))
    n_branches = len(cfg.backbone.longnet().segment_lengths)
    assert calls and len(calls) % (4 * n_branches) == 0


def train_step_against_jax(port_kw=None, jax_backbone_kw=None):
    """(f) JAX ``make_train_step`` and the port's from the same parameters
    (``params_from_jax``) and text projector (``projector_from_jax``),
    dropout off (the tiny config has none), three steps on one bag.

    Tolerances, with the reason for each:
    * losses: 1e-5 relative at the first step, ``LOSS_TOL`` after it
      and for the eval step's loss, which lies above the loss's own fp32
      floor on these embeddings (JAX against itself in other summation
      orders, asserted above 1e-5); the embeddings at 1e-4, the bar of
      ``test_torch_slice.py``;
    * the first step's adapter gradients: 1e-4 x max|g| per tensor, and
      for the ``NULL_GRAD`` tensors 1e-4 x the largest gradient of all;
    * parameters after three steps: within 2 % of the tensor's update
      max|p3 - p0| (of the largest update of all for ``NULL_GRAD``).
      The loss is scaled by 1e-8 so that every gradient lies below
      AdamW's eps (1e-8): there the step is proportional to the gradient.
      At the default scale the first AdamW step is lr * sign(g) for every
      element, and an element whose gradient is within fp32 noise of zero
      steps +-lr at random in each framework.

    ``port_kw`` goes to the port's ``create_aggregator`` (a kernel route);
    ``jax_backbone_kw`` replaces fields of the JAX model's backbone
    configuration (a route of the JAX package)."""
    cfg = tiny_test_config(depth=4)
    jcfg = cfg if jax_backbone_kw is None else dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, **jax_backbone_kw))
    tcfg = TrainConfig(lr=0.2, kd_loss_scale=1e-8)
    spe = 3                 # three steps of the first warmup epoch
    groups = synthetic_pathways(n_genes=N_GENES, n_groups=12, max_size=7,
                                seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(N_GENES)])
    ds = SyntheticSlideDataset(n_cases=1, in_chans=64, bag_range=(300, 400),
                               packer=packer, n_genes=N_GENES, seed=1)
    (batch,) = list(BucketedLoader(ds, buckets=(511,), batch_size=1,
                                   shuffle=False, prefetch=0,
                                   device_prefetch=False))
    jmodel = JaxModalTune(jcfg, n_gene_groups=packer.n_groups,
                          max_group_len=packer.max_group_len)
    jb = dict(bag=jnp.asarray(batch.bag), coords=jnp.asarray(batch.coords),
              mask=jnp.asarray(batch.mask), genes=jnp.asarray(batch.genes),
              clinical=None)
    params = jax.jit(lambda key: jmodel.init(
        key, jb["bag"], jb["coords"], jb["genes"], task_token=jnp.eye(3)[:1],
        bag_mask=jb["mask"])["params"])(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(7)        # Injectors are identities at init
    for name, block in params.items():
        if name.startswith("interactions_"):
            g = block["injector"]["gamma"]
            block["injector"]["gamma"] = (0.5 * rng.randn(*g.shape)
                                          ).astype(np.float32)
    jproj, proj_params, projector = _projectors()
    jtext = j_project_text(jproj, proj_params, jnp.asarray(batch.text))

    state = TrainState.create(params, j_make_optimizer(tcfg, spe))
    row_valid = np.ones(1, np.float32)
    jlogits, jeval_loss = j_make_eval_step(jmodel, tcfg)(
        state, jb, jtext, jnp.asarray(row_valid))
    floor = _kd_loss_floor(jlogits, jtext)
    assert 1e-5 < floor <= LOSS_TOL, floor
    _, jgrads = j_make_grad_step(jmodel, tcfg)(state, jb, jtext,
                                               jax.random.PRNGKey(0))
    jstep = j_make_train_step(jmodel, tcfg, donate=False)
    jlosses = []
    for i in range(3):
        state, loss = jstep(state, jb, jtext, jax.random.PRNGKey(i))
        jlosses.append(float(loss))

    model = create_aggregator("longnetvit_gene_adapter", device="cpu", cfg=cfg,
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len,
                              **(port_kw or {}))
    p0 = params_from_jax(params, model)
    model.load_state_dict(p0)
    opt = make_optimizer(tcfg, freeze_backbone(model), spe)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.startswith("backbone.") for n in frozen)
    text = project_text(projector, _t(batch.text))
    inputs = batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    logits, eval_loss = make_eval_step(model, tcfg)(inputs, text,
                                                    _t(row_valid))
    _, grads = make_grad_step(model, tcfg)(inputs, text, gen)
    step = make_train_step(model, tcfg, opt)
    losses = [float(step(inputs, text, gen)) for _ in range(3)]

    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL)

    def as_port(trainable):
        return params_from_jax(dict(trainable, backbone=params["backbone"]),
                               model)

    want_g = as_port(jax.device_get(jgrads))
    assert set(grads) == {n for n in p0 if not n.startswith("backbone.")}
    g_all = max(float(g.abs().max()) for g in want_g.values())
    for n, g in grads.items():
        scale = g_all if n.endswith(NULL_GRAD) else \
            float(want_g[n].abs().max())
        err = float((g - want_g[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)

    want_p = as_port(jax.device_get(state.trainable))
    got_p = model.state_dict()
    upd = {n: float((want_p[n] - p0[n]).abs().max()) for n in grads}
    upd_all = max(upd.values())
    assert upd_all > 0
    for n in grads:
        scale = upd_all if n.endswith(NULL_GRAD) else upd[n]
        err = float((got_p[n] - want_p[n]).abs().max())
        assert err <= 0.02 * scale, (n, err, scale)
    for n, p in frozen.items():
        assert torch.equal(got_p[n], p), n

    # the eval step from the same parameters: raw embeddings and the
    # row-weighted loss
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(eval_loss), float(jeval_loss),
                               rtol=LOSS_TOL)
