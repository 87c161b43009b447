"""The port's LongNet extras against the JAX package's, on the CPU.

* ``LoraDilatedSelfAttention``: the identity at initialisation (B = 0)
  against the plain attention on the same base weights; with every LoRA B
  nonzero, the layer and a 2-layer ``lora_adapter`` LongNetViT against
  JAX's in fp32 (outputs 1e-5 relative to the largest value; gradients
  relative to the largest of the tensor, 1e-5 in the layer and 1e-4
  through the whole backbone; the key bias's and the key's context
  deltas', zero but for rounding, to the largest of all), JAX's
  weights carried by ``params_from_jax`` (F16: the port built the plain
  attention and refused the tree's LoRA keys);
* ``top1_gating`` and ``top2_gating`` against JAX's: the dispatch (route
  and queue slot of every token) equal, the combine weights and aux loss
  within 1e-6 (an fp32 softmax summed in another order), top-2 with
  JAX's Gumbel draw passed as ``noise``, with and without dropping;
* ``MoeFeedForward`` forward and backward against JAX's (1e-5), top-1 and
  top-2, its tree carried by ``params_from_jax``; expert parallelism over
  two gloo ranks (``tests/_torch_mp.py``) against JAX's single-process
  result at 1e-5, as ``tests/test_extras.py`` holds JAX's own, and
  ``all_to_all_dim`` and its reverse exchange on dims 0 and 1;
* ``apply_xpos`` (1e-6) and ``RelativePositionBias`` (buckets equal, the
  bias gathered bit-equal) against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as tmp_ranks
from modaltune_tpu.configs import LongNetConfig as JLongNetConfig
from modaltune_tpu.configs import tiny_test_config as j_tiny_config
from modaltune_tpu.models import extras as j_extras
from modaltune_tpu.models.slide_encoder import LongNetViT as JaxLongNetViT
from modaltune_tpu_torch import create_aggregator, init_weights
from modaltune_tpu_torch.configs import LongNetConfig, tiny_test_config
from modaltune_tpu_torch.models import extras, fill_normal_
from modaltune_tpu_torch.models.longnet import DilatedSelfAttention
from modaltune_tpu_torch.models.slide_encoder import LongNetViT
from modaltune_tpu_torch.utils.convert import params_from_jax, port_names

torch.set_num_threads(2)

TOL = 1e-5
# gradients through a whole 2-layer backbone: fp32 rounding over the patch
# embedding, two encoder layers and the pooling head, as
# tests/test_torch_slice.py holds the model (1e-4)
GRAD_TOL_MODEL = 1e-4
LN_KW = dict(num_layers=1, embed_dim=32, ffn_dim=64, num_heads=4,
             segment_lengths=(8, 16), dilated_ratios=(1, 2), dropout=0.0,
             drop_path_rate=0.0)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max|err| / max|want| {err:.3e} > {tol}"


# gradients that are zero in exact arithmetic, rounding noise in practice,
# held against the largest gradient of all: the key bias's and the key's
# gene and task deltas', each a shift of every key by one vector (softmax
# is shift invariant)
NULL_GRAD = ("k_proj.bias",) + tuple(
    f"k_lora_{m}_{t}.weight" for m in "AB" for t in ("gene", "task"))


def _close_grads(got, want):
    """Every named gradient within TOL of the tensor's largest value, a
    NULL_GRAD tensor's of the largest of all."""
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for n, g in got.items():
        w = np.asarray(want[n], np.float64)
        scale = top if n.endswith(NULL_GRAD) else np.abs(w).max()
        err = np.abs(np.asarray(g, np.float64) - w).max() / max(scale, 1e-30)
        assert err <= TOL, f"{n}: max|err| / scale {err:.3e} > {TOL}"


def _nonzero_b(params, seed):
    """Every LoRA B matrix of a JAX tree set to N(0, 0.3)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.3 * rng.randn(*v.shape)).astype(np.float32)
                    if "_lora_B_" in path_of[id(tree)] + k else v)
                for k, v in tree.items()}
    path_of = {}

    def paths(tree, prefix=""):
        path_of[id(tree)] = prefix
        for k, v in tree.items():
            if isinstance(v, dict):
                paths(v, prefix + k + "/")
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    paths(params)
    return walk(params)


def _layer_inputs(length=20, n_masked=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, length, 32).astype(np.float32)
    gene = rng.randn(2, 1, 32).astype(np.float32)
    task = rng.randn(2, 1, 32).astype(np.float32)
    mask = np.ones((2, length), bool)
    mask[1, length - n_masked:] = False
    return x, gene, task, mask


def _port_layer(params):
    layer = extras.LoraDilatedSelfAttention(LongNetConfig(**LN_KW))
    layer.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in port_names(params).items()})
    return layer


def test_lora_identity_at_init():
    """B starts at zero: the layer is the plain attention on its base
    projections, whatever the context."""
    x, gene, task, mask = (torch.from_numpy(a) for a in _layer_inputs())
    layer = init_weights(extras.LoraDilatedSelfAttention(
        LongNetConfig(**LN_KW)), torch.Generator().manual_seed(0))
    plain = DilatedSelfAttention(LongNetConfig(**LN_KW))
    plain.load_state_dict({k: v for k, v in layer.state_dict().items()
                           if "lora" not in k})
    with torch.no_grad():
        got, want = layer(x, gene, task, mask), plain(x, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    names = set(layer.state_dict())
    assert {"q_lora_A_gene.weight", "v_lora_B_task.weight",
            "k_lora_A_img.weight"} <= names
    assert all(not layer.get_parameter(n).any() for n in names
               if "_lora_B_" in n)


def test_lora_layer_matches_jax():
    """Nonzero B: output and the gradients of sum(sin(out)) to x, the
    contexts and every parameter."""
    x, gene, task, mask = _layer_inputs()
    jlayer = j_extras.LoraDilatedSelfAttention(JLongNetConfig(**LN_KW))
    params = jlayer.init(jax.random.PRNGKey(3), x, gene, task,
                         mask)["params"]
    params = _nonzero_b(params, 1)

    def loss(p, x, gene, task):
        out = jlayer.apply({"params": p}, x, gene, task, mask)
        return jnp.sum(jnp.sin(out)), out
    (_, want), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(params, x, gene, task)

    layer = _port_layer(params)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, gene, task)]
    out = layer(*xs, torch.from_numpy(mask))
    torch.sin(out).sum().backward()
    _close(out.detach(), want, what="out")
    for t, w, name in zip(xs, jg[1:], ("x", "gene", "task")):
        _close(t.grad, w, what=f"d{name}")
    want_p = port_names(jax.device_get(jg[0]))
    assert len([n for n in want_p if "_lora_" in n]) == 18
    _close_grads({n: p.grad for n, p in layer.named_parameters()}, want_p)


def _vit_configs():
    """(JAX, port) pairs of the 2-layer tiny backbone config and its
    LongNet config with ``lora_adapter``."""
    jcfg, cfg = j_tiny_config(depth=2).backbone, \
        tiny_test_config(depth=2).backbone
    return (jcfg, jcfg.longnet(lora_adapter=True)), \
        (cfg, cfg.longnet(lora_adapter=True))


def test_lora_backbone_matches_jax():
    """A 2-layer LongNetViT with ``lora_adapter`` (every LoRA B nonzero)
    at 300 patches against JAX's: the pooled output and the gradient to
    every LoRA leaf, JAX's tree carried by ``params_from_jax`` into the
    port's model (F16)."""
    (jcfg, jln), (cfg, ln) = _vit_configs()
    rng = np.random.RandomState(4)
    n = 300
    bag = rng.randn(1, n, cfg.in_chans).astype(np.float32)
    coords = (rng.randint(0, 60, (1, n, 2)) * 256).astype(np.float32)
    mask = np.ones((1, n), bool)
    mask[0, 260:] = False
    jmodel = JaxLongNetViT(jcfg, longnet=jln)
    args = [jnp.asarray(a) for a in (bag, coords, mask)]
    params = jmodel.init(jax.random.PRNGKey(1), *args)["params"]
    params = _nonzero_b(params, 2)

    def loss(p):
        out = jmodel.apply({"params": p}, *args)
        return jnp.sum(jnp.sin(out)), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)

    port = LongNetViT(cfg, longnet=ln)
    assert isinstance(port.encoder.layers[0].self_attn,
                      extras.LoraDilatedSelfAttention)
    holder = torch.nn.ModuleDict({"backbone": port})
    holder.load_state_dict(params_from_jax({"backbone": params}, holder))
    out = port(*(torch.from_numpy(a) for a in (bag, coords, mask)))
    torch.sin(out).sum().backward()
    _close(out.detach(), want, what="pooled")
    want_g = port_names({"backbone": jax.device_get(jgrad)})
    lora = [(k, p) for k, p in holder.named_parameters() if "_lora_" in k]
    assert len(lora) == 2 * 18
    for k, p in lora:
        _close(p.grad, want_g[k], GRAD_TOL_MODEL, k)
    # B received signal on the image branch; the zero gene and task
    # contexts give their A nothing
    assert any(p.grad.abs().sum() > 0 for k, p in lora if "_B_img" in k)
    assert all(not p.grad.any() for k, p in lora
               if "_A_gene" in k or "_A_task" in k)


def test_lora_modaltune_route_identity_at_init():
    """ModalTune-GigaPath on the LoRA route: at initialisation (B = 0) its
    embed step equals the plain model's on the same weights, and
    ``freeze_backbone`` freezes the LoRA parameters with the backbone."""
    from modaltune_tpu_torch import freeze_backbone, make_embed_step
    from modaltune_tpu_torch.configs import TrainConfig
    packer, batch, _ = tmp_ranks.tiny_data(1, bag_range=(150, 200))
    cfg = tiny_test_config(depth=2)
    models = {}
    for lora in (False, True):
        kw = dict(longnet=cfg.backbone.longnet(lora_adapter=True)) \
            if lora else {}
        models[lora] = create_aggregator(
            "longnetvit_gene_adapter", device="cpu", cfg=cfg,
            n_gene_groups=packer.n_groups,
            max_group_len=packer.max_group_len, **kw)
    init_weights(models[True], torch.Generator().manual_seed(0))
    models[False].load_state_dict({k: v for k, v in
                                   models[True].state_dict().items()
                                   if "_lora_" not in k})
    with torch.no_grad():   # init_values = 0 makes the Injectors no-ops
        for m in models.values():
            for block in m.interactions:
                fill_normal_(block.injector.gamma, 0.1,
                             torch.Generator().manual_seed(1))
    b = {k: None if v is None else torch.from_numpy(v)
         for k, v in batch.items()}
    got = make_embed_step(models[True], TrainConfig())(b)
    want = make_embed_step(models[False], TrainConfig())(b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    freeze_backbone(models[True])
    lora = [p for n, p in models[True].named_parameters() if "_lora_" in n]
    assert lora and not any(p.requires_grad for p in lora)


# ---------------------------------------------------------------------------
# gating and the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,e,cap,seed", [(37, 4, 16, 0), (37, 4, 7, 1),
                                          (64, 8, 4, 2), (5, 3, 1, 3)])
def test_top1_gating_matches_jax(s, e, cap, seed):
    logits = (np.random.RandomState(seed).randn(s, e) * 2).astype(np.float32)
    jc, jd, ja = j_extras.top1_gating(jnp.asarray(logits), cap)
    c, d, a = extras.top1_gating(torch.from_numpy(logits), cap)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), rtol=1e-6)


@pytest.mark.parametrize("noisy", [False, True], ids=["plain", "gumbel"])
@pytest.mark.parametrize("s,e,cap,seed", [(37, 4, None, 0), (37, 4, 9, 1),
                                          (64, 8, 6, 2)])
def test_top2_gating_matches_jax(s, e, cap, seed, noisy):
    logits = (np.random.RandomState(seed).randn(s, e) * 2).astype(np.float32)
    key = jax.random.PRNGKey(seed) if noisy else None
    jc, jd, ja = j_extras.top2_gating(jnp.asarray(logits), cap, key)
    noise = None
    if noisy:
        noise = torch.from_numpy(np.array(jax.random.gumbel(
            key, logits.shape, jnp.float32)))
    c, d, a = extras.top2_gating(torch.from_numpy(logits), cap, noise=noise)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), rtol=1e-6)


def test_top2_gating_draws_from_the_generator():
    """Without ``noise`` a generator's draw is Gumbel noise: the same
    generator state gives the same routing as that draw passed in."""
    logits = torch.from_numpy(np.random.RandomState(5).randn(50, 4)
                              .astype(np.float32))
    g = torch.Generator().manual_seed(9)
    drawn = extras.gumbel_noise(logits.shape, logits,
                                torch.Generator().manual_seed(9))
    c1, _, _ = extras.top2_gating(logits, 26, g)
    c2, _, _ = extras.top2_gating(logits, 26, noise=drawn)
    assert torch.equal(c1, c2)
    assert abs(drawn.mean().item() - 0.5772) < 0.2


def _moe_case(gate_type, capacity_factor=1.0, shape=(2, 24, 16), e=4):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jm = j_extras.MoeFeedForward(dim=shape[2], ffn_dim=32, num_experts=e,
                                 capacity_factor=capacity_factor,
                                 gate_type=gate_type)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x)["params"])
    rng = np.random.RandomState(2)
    params = dict(params, b1=rng.randn(*params["b1"].shape).astype(
        np.float32) * 0.1, b2=rng.randn(*params["b2"].shape).astype(
        np.float32) * 0.1)
    return jm, params, x


@pytest.mark.parametrize("gate_type,cf", [("top1", 1.0), ("top1", 4.0),
                                          ("top2", 1.0)])
def test_moe_matches_jax(gate_type, cf):
    """Forward (out and aux) and the gradients of sum(sin(out)) + aux to x
    and every parameter."""
    jm, params, x = _moe_case(gate_type, cf)

    def loss(p, x):
        out, aux = jm.apply({"params": p}, x)
        return jnp.sum(jnp.sin(out)) + aux, (out, aux)
    (_, (want, want_aux)), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)

    moe = extras.MoeFeedForward(16, 32, 4, capacity_factor=cf,
                                gate_type=gate_type).eval()
    moe.load_state_dict(params_from_jax(params, moe))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe(xt)
    (torch.sin(out).sum() + aux).backward()
    _close(out.detach(), want, what="out")
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    _close(xt.grad, jg[1], what="dx")
    _close_grads({n: p.grad for n, p in moe.named_parameters()},
                 port_names(jax.device_get(jg[0])))


def test_moe_init_is_seeded():
    a, b = (init_weights(extras.MoeFeedForward(16, 32, 4),
                         torch.Generator().manual_seed(3)) for _ in range(2))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert a.w1.std().item() == pytest.approx(16 ** -0.5, rel=0.2)


@pytest.fixture(scope="module")
def expert_parallel(tmp_path_factory):
    """JAX's single-process MoE (8 experts, capacity that drops no token)
    on 16 tokens, and two gloo ranks of the port each on 8 of them with 4
    of the experts, top-1 and top-2."""
    n, e = 2, 8
    x = np.random.RandomState(0).randn(1, 16, 16).astype(np.float32)
    want, state = {}, None
    for gate_type in ("top1", "top2"):
        jm = j_extras.MoeFeedForward(dim=16, ffn_dim=32, num_experts=e,
                                     capacity_factor=8.0,
                                     gate_type=gate_type)
        if state is None:
            params = jax.device_get(jm.init(jax.random.PRNGKey(1),
                                            x)["params"])
            full = extras.MoeFeedForward(16, 32, e)
            state = {k: np.asarray(v) for k, v in
                     params_from_jax(params, full).items()}

        def loss(p, x, jm=jm):
            return jnp.sum(jnp.sin(jm.apply({"params": p}, x)[0]))
        want[gate_type] = (np.asarray(jm.apply({"params": params}, x)[0]),
                           jax.grad(loss, argnums=(0, 1))(params, x))
    ranks = tmp_ranks.run_ranks(
        tmp_ranks.moe_worker, n, tmp_path_factory.mktemp("moe"),
        dict(x=x, state=state, experts=e, capacity_factor=8.0,
             gate_types=("top1", "top2")))
    return n, want, ranks


@pytest.mark.parametrize("gate_type", ["top1", "top2"])
def test_moe_expert_parallel_matches_jax(expert_parallel, gate_type):
    n, want, ranks = expert_parallel
    want_out, (jg_p, jg_x) = want[gate_type]
    runs = [r[0][gate_type] for r in ranks]
    _close(np.concatenate([r[0] for r in runs], axis=1), want_out,
           what="out")
    _close(np.concatenate([r[1] for r in runs], axis=1), jg_x, what="dx")
    want_p = port_names(jax.device_get(jg_p))
    for name in ("w1", "b1", "w2", "b2"):
        _close(np.concatenate([r[2][name] for r in runs]), want_p[name],
               what=name)
    _close(sum(r[2]["gate.weight"] for r in runs), want_p["gate.weight"],
           what="gate")


def test_all_to_all_dim_over_two_ranks(expert_parallel):
    """Chunk i goes to rank i, concatenated by source rank; the gradient
    comes back by the reverse exchange."""
    n, _, ranks = expert_parallel
    base_a = np.arange(n * 6, dtype=np.float32).reshape(n, 6)
    base_b = np.arange(2 * n * 3, dtype=np.float32).reshape(2, n * 3)
    for r, (_, ex_a, ex_b, grad_b) in enumerate(ranks):
        want_a = np.stack([base_a[r] + 100 * j for j in range(n)])
        want_b = np.concatenate([base_b[:, 3 * r:3 * r + 3] + 100 * j
                                 for j in range(n)], axis=1)
        assert np.array_equal(ex_a, want_a)
        assert np.array_equal(ex_b, want_b)
        assert np.array_equal(grad_b, np.repeat(
            np.arange(1, n + 1, dtype=np.float32), 3)[None].repeat(2, 0))


# ---------------------------------------------------------------------------
# xPos and the T5 bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset,downscale", [(0, False), (7, True),
                                              (1000, False)])
def test_xpos_matches_jax(offset, downscale):
    x = np.random.RandomState(1).randn(2, 300, 48).astype(np.float32)
    want = np.asarray(j_extras.apply_xpos(jnp.asarray(x), offset,
                                          downscale=downscale))
    got = extras.apply_xpos(torch.from_numpy(x), offset,
                            downscale=downscale)
    assert got.dtype == torch.float32
    _close(got, want, 1e-6, "xpos")
    half = extras.apply_xpos(torch.from_numpy(x).bfloat16(), offset)
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("buckets,distance,heads", [(32, 128, 12),
                                                    (8, 16, 2), (64, 512, 4)])
def test_relative_position_bias_matches_jax(buckets, distance, heads):
    rel = np.arange(-3000, 3000)
    assert np.array_equal(
        extras.RelativePositionBias._bucket(torch.from_numpy(rel), buckets,
                                            distance).numpy(),
        np.asarray(j_extras.RelativePositionBias._bucket(
            jnp.asarray(rel), buckets, distance)))
    jm = j_extras.RelativePositionBias(buckets, distance, heads)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), 5, 5)["params"])
    want = np.asarray(jm.apply({"params": params}, 40, 70))
    m = extras.RelativePositionBias(buckets, distance, heads)
    m.load_state_dict(params_from_jax(params, m))
    got = m(40, 70)
    assert got.shape == (heads, 40, 70)
    assert np.array_equal(got.detach().numpy(), want)
