"""Plain PyTorch pieces shared by the ModalTune references.

Written for the benchmark alone: it imports neither the port nor the JAX
package. Every module keeps the attribute names of the port's modules, so
one ``state_dict`` made by the benchmark loads into both. Everything
computes in fp32 (TF32 off), or, for the control, with every product's
operands rounded to fp8 e4m3 (:class:`Runtime`).

Randomness follows the port's rule: every dropout of a model in training
mode draws ``torch.rand(shape, generator=g)`` from the one generator the
step is given, in the order the forward runs, so the same seed and the
same shapes give the same bits on both sides. :func:`remat` recomputes a
region in the backward with that generator set back to where the region
started.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e9
LIVE = NEG_INF * 0.5
# elements of one block of attention scores
SCORE_BLOCK = 1 << 26


class Runtime:
    """What a forward needs besides its inputs: the dropout generator (None
    in eval mode) and the precision of the products, ``"fp32"`` or
    ``"fp8"`` (the control: as bf16 autocast rounds the program's products
    and their outputs, each operand and output rounded to float8 e4m3 with
    a per-tensor scale, the gradient passed straight through)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.generator: Optional[torch.Generator] = None

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return x
        s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (q - x).detach()

    def rand(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=like.device)


def remat(rt: Runtime, fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward with the
    dropout generator replayed from the state it had here."""
    if not torch.is_grad_enabled():
        return fn(*args)
    g = rt.generator
    state = None if g is None else g.get_state()
    calls = []

    def run(*a):
        if not calls:
            calls.append(1)
            return fn(*a)
        if g is None:
            return fn(*a)
        now = g.get_state()
        g.set_state(state)
        try:
            return fn(*a)
        finally:
            g.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, rt: Runtime, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.rt = rt
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        r = self.rt.rnd
        return r(F.linear(r(x), r(self.weight.float()),
                          None if self.bias is None else self.bias.float()))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Dropout(nn.Module):
    def __init__(self, rt: Runtime, rate: float):
        super().__init__()
        self.rt, self.rate = rt, rate

    def forward(self, x):
        if self.rate == 0.0 or self.rt.generator is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(self.rt.rand(x.shape, x) < keep, x / keep, 0.0)


class DropPath(Dropout):
    def forward(self, x):
        if self.rate == 0.0 or self.rt.generator is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.where(self.rt.rand(shape, x) < keep, x / keep, 0.0)


class AlphaDropout(Dropout):
    ALPHA_P = -1.7580993408473766

    def forward(self, x):
        if self.rate == 0.0 or self.rt.generator is None:
            return x
        p = self.rate
        a = ((1.0 - p) * (1.0 + p * self.ALPHA_P ** 2)) ** -0.5
        b = -a * p * self.ALPHA_P
        keep = self.rt.rand(x.shape, x) < 1.0 - p
        return a * torch.where(keep, x, self.ALPHA_P) + b


# ---------------------------------------------------------------------------
# attention: softmax(q k^T scale + bias) v in blocks, with its own backward
# ---------------------------------------------------------------------------


def _blocks(bh: int, lq: int, lk: int):
    rows = max(1, SCORE_BLOCK // (lk * max(lq, 1)))
    qrows = lq if rows > 1 else max(1, SCORE_BLOCK // lk)
    for b0 in range(0, bh, rows):
        for i0 in range(0, lq, qrows):
            yield slice(b0, min(b0 + rows, bh)), slice(i0, min(i0 + qrows, lq))


class _Attention(torch.autograd.Function):
    """q (BH, Lq, D), k, v (BH, Lk, D); ``bias(bs, qs)`` the additive bias
    of the score block (rows ``bs``, queries ``qs``), broadcastable to
    (rows, queries, Lk) and NEG_INF where a key is masked. Returns out and
    the row's log-sum-exp (NEG_INF for a row with no live key, whose out
    is 0); only ``out`` carries a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, rnd):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=q.dtype, device=q.device)
        for bs, qs in _blocks(q.shape[0], q.shape[1], k.shape[1]):
            s = torch.bmm(q[bs, qs], k[bs].transpose(1, 2)) * scale \
                + bias(bs, qs)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            live = m > LIVE
            l = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
            out[bs, qs] = torch.bmm(rnd(p), v[bs]) / l * live
            lse[bs, qs] = torch.where(live[..., 0], m[..., 0] + torch.log(
                l[..., 0]), NEG_INF)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bias, ctx.scale, ctx.rnd = bias, scale, rnd
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        delta = (dout * out).sum(dim=-1)
        for bs, qs in _blocks(q.shape[0], q.shape[1], k.shape[1]):
            s = torch.bmm(q[bs, qs], k[bs].transpose(1, 2)) * ctx.scale \
                + ctx.bias(bs, qs)
            ls = lse[bs, qs][..., None]
            p = torch.where(ls > LIVE, torch.exp(s - ls), 0.0)
            do = dout[bs, qs]
            dv[bs] += torch.bmm(ctx.rnd(p).transpose(1, 2), do)
            dp = torch.bmm(do, v[bs].transpose(1, 2))
            ds = p * (dp - delta[bs, qs][..., None]) * ctx.scale
            dq[bs, qs] = torch.bmm(ds, k[bs])
            dk[bs] += torch.bmm(ds.transpose(1, 2), q[bs, qs])
        return dq, dk, dv, None, None, None


def attention(rt: Runtime, q, k, v, bias, scale: float):
    """See :class:`_Attention`; for the control q, k, v, the probabilities
    and the output are rounded."""
    out, lse = _Attention.apply(rt.rnd(q.float()), rt.rnd(k.float()),
                                rt.rnd(v.float()), bias, scale, rt.rnd)
    return rt.rnd(out), lse


def key_bias(key_mask: Optional[torch.Tensor], rows: int):
    """The bias of :func:`attention` for a (rows, Lk) bool key mask, or
    none."""
    if key_mask is None:
        return lambda bs, qs: 0.0
    b = torch.where(key_mask, 0.0, NEG_INF).float()
    return lambda bs, qs: b[bs][:, None, :]


# ---------------------------------------------------------------------------
# the Modal Adapter's layers (the port's models/layers.py names)
# ---------------------------------------------------------------------------


class TorchMHA(nn.Module):
    def __init__(self, rt, embed_dim, num_heads, kdim=None, vdim=None):
        super().__init__()
        self.rt, self.embed_dim, self.num_heads = rt, embed_dim, num_heads
        self.q_proj = Linear(rt, embed_dim, embed_dim)
        self.k_proj = Linear(rt, kdim or embed_dim, embed_dim)
        self.v_proj = Linear(rt, vdim or embed_dim, embed_dim)
        self.out_proj = Linear(rt, embed_dim, embed_dim)

    def forward(self, query, key, value, key_mask=None):
        e, h = self.embed_dim, self.num_heads
        dh = e // h
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        b, lq, lk = q.shape[0], q.shape[1], k.shape[1]

        def heads(t, n):
            return t.reshape(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh)

        mask = None if key_mask is None else \
            key_mask.repeat_interleave(h, dim=0)
        out, _ = attention(self.rt, heads(q, lq), heads(k, lk), heads(v, lk),
                           key_bias(mask, b * h), dh ** -0.5)
        out = out.reshape(b, h, lq, dh).transpose(1, 2).reshape(b, lq, e)
        return self.out_proj(out)


class CrossAttentionLayer(nn.Module):
    def __init__(self, rt, d, heads, cffn_ratio):
        super().__init__()
        inner = int(d * cffn_ratio)
        self.norm = LayerNorm(d, 1e-5)
        self.norm_kq = LayerNorm(d, 1e-5)
        self.q_proj = Linear(rt, d, inner)
        self.output_proj = Linear(rt, inner, d)
        self.multihead_attn = TorchMHA(rt, inner, heads, kdim=d, vdim=d)

    def forward(self, tgt, memory, pos=None, query_pos=None, memory_mask=None):
        tgt2 = self.norm(tgt)
        mem = self.norm_kq(memory)
        q_in = self.q_proj(tgt2 if query_pos is None else tgt2 + query_pos)
        kv = mem if pos is None else mem + pos
        attn = self.multihead_attn(q_in, kv, kv, key_mask=memory_mask)
        return tgt + self.output_proj(attn)


class SelfAttentionLayer(nn.Module):
    def __init__(self, rt, d, heads, cffn_ratio, dropout):
        super().__init__()
        inner = int(d * cffn_ratio)
        self.norm = LayerNorm(d, 1e-5)
        self.q_proj = Linear(rt, d, inner)
        self.output_proj = Linear(rt, inner, d)
        self.self_attn = TorchMHA(rt, inner, heads, kdim=d, vdim=d)
        self.dropout = Dropout(rt, dropout)

    def forward(self, tgt, query_pos=None):
        tgt2 = self.norm(tgt)
        qk = tgt2 if query_pos is None else tgt2 + query_pos
        attn = self.output_proj(self.self_attn(self.q_proj(qk), qk, tgt2))
        return tgt + self.dropout(attn)


class FFNLayer(nn.Module):
    def __init__(self, rt, d, hidden):
        super().__init__()
        self.norm = LayerNorm(d, 1e-5)
        self.linear1 = Linear(rt, d, hidden)
        self.linear2 = Linear(rt, hidden, d)

    def forward(self, x):
        return self.linear2(torch.relu(self.linear1(self.norm(x))))


class Injector(nn.Module):
    def __init__(self, rt, d, heads, cffn_ratio):
        super().__init__()
        self.attn = CrossAttentionLayer(rt, d, heads, cffn_ratio)
        self.gamma = nn.Parameter(torch.empty(d))

    def forward(self, query, feat, pos=None):
        return query + self.gamma.float() * self.attn(query, feat, pos=pos)


class Extractor(nn.Module):
    def __init__(self, rt, d, heads, cffn_ratio, drop_path):
        super().__init__()
        self.attn = CrossAttentionLayer(rt, d, heads, cffn_ratio)
        self.ffn = FFNLayer(rt, d, int(d * cffn_ratio))
        self.drop_path = DropPath(rt, drop_path)

    def forward(self, query, feat, pos=None, feat_mask=None):
        query = query + self.attn(query, feat, query_pos=pos,
                                  memory_mask=feat_mask)
        return query + self.drop_path(self.ffn(query))


class InteractionBlock(nn.Module):
    def __init__(self, rt, d, heads, cffn_ratio, drop_path, extra):
        super().__init__()
        self.injector = Injector(rt, d, heads, cffn_ratio)
        self.extractor = Extractor(rt, d, heads, cffn_ratio, drop_path)
        self.extra_extractors = nn.ModuleList(
            Extractor(rt, d, heads, cffn_ratio, drop_path)
            for _ in range(2 if extra else 0))

    def forward(self, x, modal, cls, run_span, query_pos, x_mask):
        x = self.injector(x, modal, pos=query_pos)
        h = run_span(torch.cat([cls, x], dim=1))
        cls, x = h[:, :1], h[:, 1:]
        for ex in [self.extractor, *self.extra_extractors]:
            modal = ex(modal, x, pos=query_pos, feat_mask=x_mask)
        return x, modal, cls


# ---------------------------------------------------------------------------
# the gene mixer (the port's models/gene.py names)
# ---------------------------------------------------------------------------


class TokenFeedForward(nn.Module):
    def __init__(self, rt, groups, expansion, dropout):
        super().__init__()
        inner = int(groups * expansion)
        self.rt = rt
        self.w1 = nn.Parameter(torch.empty(groups, inner))
        self.b1 = nn.Parameter(torch.empty(inner))
        self.w2 = nn.Parameter(torch.empty(inner, groups))
        self.b2 = nn.Parameter(torch.empty(groups))
        self.dropout = Dropout(rt, dropout)

    def forward(self, x):
        r = self.rt.rnd
        h = torch.einsum("bgc,gi->bic", r(x), r(self.w1)) \
            + self.b1[None, :, None]
        h = self.dropout(gelu(h))
        h = torch.einsum("bic,ig->bgc", r(h), r(self.w2)) \
            + self.b2[None, :, None]
        return self.dropout(h)


class ChannelFeedForward(nn.Module):
    def __init__(self, rt, dim, expansion, dropout):
        super().__init__()
        inner = int(dim * expansion)
        self.fc1 = Linear(rt, dim, inner)
        self.fc2 = Linear(rt, inner, dim)
        self.dropout = Dropout(rt, dropout)

    def forward(self, x):
        return self.dropout(self.fc2(self.dropout(gelu(self.fc1(x)))))


class MixerBlock(nn.Module):
    def __init__(self, rt, n_tokens, g):
        super().__init__()
        self.token_norm = LayerNorm(g["latent_dim"], 1e-5)
        self.token = TokenFeedForward(rt, n_tokens, g["expansion_groups"],
                                      g["dropout"])
        self.chan_norm = LayerNorm(g["latent_dim"], 1e-5)
        self.chan = ChannelFeedForward(rt, g["latent_dim"],
                                       g["expansion_dim"], g["dropout"])

    def forward(self, x):
        x = x + self.token(self.token_norm(x))
        return x + self.chan(self.chan_norm(x))


class GeneMixerEncoder(nn.Module):
    """genes (B, G, M) -> (B, final_groups, output_dim)."""

    def __init__(self, rt, g, n_groups, max_group_len, output_dim):
        super().__init__()
        lat = g["latent_dim"]
        self.rt = rt
        self.snn1_kernel = nn.Parameter(torch.empty(n_groups, max_group_len,
                                                    lat))
        self.snn1_bias = nn.Parameter(torch.empty(n_groups, lat))
        self.snn2_kernel = nn.Parameter(torch.empty(n_groups, lat, lat))
        self.snn2_bias = nn.Parameter(torch.empty(n_groups, lat))
        self.snn1_drop = AlphaDropout(rt, g["dropout"])
        self.snn2_drop = AlphaDropout(rt, g["dropout"])
        self.mix = nn.ModuleList(MixerBlock(rt, n_groups, g)
                                 for _ in range(g["depth"]))
        self.mixer_norm = LayerNorm(lat, 1e-5)
        self.mixer_out = Linear(rt, lat, output_dim)
        self.compress_kernel = nn.Parameter(torch.empty(n_groups,
                                                        g["final_groups"]))
        self.compress_bias = nn.Parameter(torch.empty(g["final_groups"]))

    def forward(self, genes):
        r = self.rt.rnd
        x = torch.einsum("bgm,gml->bgl", r(genes), r(self.snn1_kernel)) \
            + self.snn1_bias
        x = self.snn1_drop(F.elu(x))
        x = torch.einsum("bgl,glk->bgk", r(x), r(self.snn2_kernel)) \
            + self.snn2_bias
        x = self.snn2_drop(F.elu(x))
        for block in self.mix:
            x = block(x)
        x = self.mixer_out(self.mixer_norm(x))
        return torch.einsum("bgc,gf->bfc", r(x), r(self.compress_kernel)) \
            + self.compress_bias[None, :, None]


# ---------------------------------------------------------------------------
# the adapter around a backbone (the port's models/modaltune.py)
# ---------------------------------------------------------------------------


class AdapterModel(nn.Module):
    """The trainable Modal Adapter and gene mixer; a subclass adds
    ``self.backbone`` and :meth:`forward`."""

    def __init__(self, rt, cfg: dict, n_groups: int, max_group_len: int):
        super().__init__()
        m = cfg["model"]
        a = self.a = m["adapter"]
        d = m["backbone"]["embed_dim"]
        self.rt = rt
        self.gene_encoder = GeneMixerEncoder(rt, m["gene"], n_groups,
                                             max_group_len, d)
        n_int = len(a["interaction_indexes"])
        self.interactions = nn.ModuleList(
            InteractionBlock(rt, d, a["num_heads"], a["cffn_ratio"],
                             a["drop_path_rate"],
                             i == n_int - 1 and a["use_extra_extractor"])
            for i in range(n_int))
        self.prompt_sa = nn.ModuleList(
            SelfAttentionLayer(rt, d, a["num_heads"], a["cffn_ratio"],
                               a["prompt_dropout"])
            for _ in range(1, n_int if a["use_prompt_sa"] else 1))
        self.task_dense = Linear(rt, a["multi_task"], d)
        self.task_norm = LayerNorm(d, 1e-5)
        self.gene_pe = nn.Parameter(torch.empty(m["gene"]["final_groups"]
                                                + 1, d))
        n_cat = 1 if a["token_agg"] == "sum" else 3
        self.final_norm = LayerNorm(d * n_cat, 1e-5)
        self.final_project = Linear(rt, d * n_cat, a["output_dim"])
        if a["prompt_agg"] != "avg" or a["clinfeat_dim"] or \
                a["multi_task"] <= 1:
            raise ValueError("the reference covers the multi-task adapter "
                             "with averaged gene tokens and no clinical "
                             "branch")

    def modal_tokens(self, genes, task_token):
        modal = self.gene_encoder(genes)
        t = self.task_norm(self.task_dense(task_token))[:, None]
        return torch.cat([t, modal], dim=1)

    def interact(self, h, modal, run_layers, x_mask):
        idx = self.a["interaction_indexes"]
        if idx[0][0] != 0:
            h = run_layers(h, 0, idx[0][0])
        cls, x = h[:, :1], h[:, 1:]
        pe = self.gene_pe.float()
        for i, block in enumerate(self.interactions):
            lo, hi = idx[i]
            if 1 <= i <= len(self.prompt_sa):
                modal = self.prompt_sa[i - 1](modal, query_pos=pe)
            x, modal, cls = block(
                x, modal, cls, lambda t, lo=lo, hi=hi: run_layers(t, lo, hi + 1),
                pe, x_mask)
        return cls, x, modal

    def fuse(self, img, modal):
        task_out = modal[:, 0:1]
        gene_out = modal[:, 1:].mean(dim=1, keepdim=True)
        if self.a["token_agg"] == "sum":
            outcome = img + gene_out + task_out
        else:
            outcome = torch.cat([img, task_out, gene_out], dim=-1)
        return self.final_project(self.final_norm(outcome))[:, 0]


class TextProjector(nn.Module):
    """conv1x1 512 -> 256, LayerNorm (eps 1e-6), ReLU, conv1x1 256 -> 256."""

    def __init__(self, rt, in_dim=512, out_dim=256):
        super().__init__()
        self.conv1 = Linear(rt, in_dim, out_dim)
        self.ln = LayerNorm(out_dim, 1e-6)
        self.conv2 = Linear(rt, out_dim, out_dim)

    def forward(self, text):
        return self.conv2(torch.relu(self.ln(self.conv1(text))))


TEXT_ROWS = (0, 1, 3)


def l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def text_targets(projector, text):
    with torch.no_grad():
        return l2n(projector(text.float()))[:, list(TEXT_ROWS)]


def kd_loss(logits, targets, temperature: float, scale: float):
    """Mean over slides of the summed KL(targets || embeddings), x T^2 x
    scale (PromptKD)."""
    t = temperature
    logp = F.log_softmax(l2n(logits) / t, dim=-1)
    q = F.softmax(targets / t, dim=-1)
    per = torch.sum(q * (torch.log(q) - logp), dim=(-2, -1))
    return per.mean() * t * t * scale


def tiled(model, rows, num_tasks: int):
    """The model over every (slide, task) pair, slide b / task t at row
    b * T + t -> (B, T, output_dim)."""
    b = rows["bag"].shape[0]
    rep = {k: v.repeat_interleave(num_tasks, dim=0) for k, v in rows.items()}
    eye = torch.eye(num_tasks, device=rows["bag"].device)
    out = model(rep["bag"], rep["coords"], rep["genes"], eye.repeat(b, 1),
                rep["mask"])
    return out.reshape(b, num_tasks, -1)


# ---------------------------------------------------------------------------
# weights and AdamW
# ---------------------------------------------------------------------------


def init_spec(model: nn.Module) -> List[tuple]:
    """(name, shape, mean, std) of every parameter, in ``named_parameters``
    order: a Linear's weight N(0, 1/fan_in), a LayerNorm's weight
    N(1, 0.1), an Injector's gamma N(0, 0.1), everything else N(0, 0.02)."""
    spec = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            mean, std = 0.0, 0.02
            if isinstance(mod, Linear) and pname == "weight":
                std = p.shape[1] ** -0.5
            elif isinstance(mod, LayerNorm) and pname == "weight":
                mean, std = 1.0, 0.1
            elif isinstance(mod, Injector):
                std = 0.1
            spec.append((name, tuple(p.shape), mean, std))
    return spec


class AdamW:
    """AdamW with decoupled weight decay, as torch and optax define it."""

    def __init__(self, params: dict, lr_at, betas, eps, weight_decay):
        self.params, self.lr_at = params, lr_at
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        lr = self.lr_at(self.t)
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - lr * self.wd)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def warmup_cosine(train: dict, steps_per_epoch: int):
    """The learning rate of update ``t``: linear warm-up from lr/factor over
    ``warmup_epochs`` epochs, then a cosine to 0, quantised to epochs."""
    lr, factor = train["lr"], train["warmup_factor"]
    warm, epochs = train["warmup_epochs"], train["num_epochs"]
    cos_epochs = max(1, epochs - warm)

    def at(t):
        e = t // max(1, steps_per_epoch)
        if e < warm:
            return lr / factor * (1.0 + (factor - 1.0) * e / warm)
        ce = min(max(e - warm, 0), cos_epochs)
        return lr * 0.5 * (1.0 + math.cos(math.pi * ce / cos_epochs))

    return at
