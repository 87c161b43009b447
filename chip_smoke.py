#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``modaltune_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes of the
ModalTune-GigaPath embed and train steps (the forward kernels K1f, K2f
and K1f's statistics; the backward kernels K1b, K2b), then drives both
steps end to end at full published width (12-layer / 768-d / 16-head
LongNet backbone, Modal Adapter, gene mixer over 331 pathways, 3 task
tokens) with random weights from a seeded generator: the embed step on
three synthetic 10,239-patch slides, and a few train steps (KD loss,
AdamW on the adapter, bf16 compute, dropout on) on one. Every phase
prints its results on lines of its own; any failure raises and the
script exits non-zero. The last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists every kernel
of the two paths with its launches, error and time against its plain
version.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import copy
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _last_line(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()][-1]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` calls, each timed
    with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# K2: flash attention with key bias
# ---------------------------------------------------------------------------

# (name, BH, Lq, Lk, D, fraction of keys masked, a bh with every key masked)
# B = 1 slide x 3 tasks x 12 adapter heads at inner width 192 -> D = 16;
# the last shape is the plain dilated path's D = 48.
K2_SHAPES = [
    ("injector", 36, 10239, 65, 16, 0.0, False),
    ("extractor", 36, 65, 10239, 16, 1239 / 10239, True),
    ("prompt_sa", 36, 65, 65, 16, 0.0, False),
    ("d48", 48, 1024, 1024, 48, 0.12, False),
]


def k2_inputs(bh, lq, lk, d, masked, dead, dtype, device, seed):
    import torch
    from modaltune_tpu_torch.ops import NEG_INF
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    bias = None
    if masked or dead:
        valid = torch.ones(bh, lk, dtype=torch.bool)
        valid[:, lk - int(round(masked * lk)):] = False
        if dead:
            valid[0] = False
        bias = torch.where(valid, 0.0, NEG_INF).to(device)
    return q, k, v, bias


def compare(got, want, tol_rel, what):
    """Check that ``got`` is finite and max |got - want| <= tol_rel *
    max(1, max |want|); returns the max abs error."""
    import torch
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    check(err <= tol_rel * scale,
          f"{what}: max|err| {err:.3e} > {tol_rel:.1e} x {scale:.3g}")
    return err


def phase_k2(device, shapes=K2_SHAPES, iters=20):
    """Kernel vs plain version at every shape, fp32 and bf16; times in
    bf16. Returns {name: result dict}."""
    import torch
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    results = {}
    for i, (name, bh, lq, lk, d, masked, dead) in enumerate(shapes):
        res = {}
        for dtype, out_tol, lse_tol in ((torch.float32, 2e-4, 1e-4),
                                        (torch.bfloat16, 1.6e-2, 1e-2)):
            q, k, v, bias = k2_inputs(bh, lq, lk, d, masked, dead, dtype,
                                      device, seed=100 + i)
            got_o, got_l = fa.flash_attention(q, k, v, bias)
            # the plain version runs in fp32 on the same (rounded) values
            want_o, want_l = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), bias)
            torch.cuda.synchronize()
            tag = f"K2 {name} {str(dtype)[6:]}"
            err_o = compare(got_o, want_o, out_tol, f"{tag} out")
            err_l = (got_l - want_l).abs().max().item()
            check(err_l <= lse_tol, f"{tag} lse: max|err| {err_l:.3e}")
            if dead:
                check(bool((got_o[0] == 0).all()) and
                      bool((got_l[0] == fa.NEG_INF).all()),
                      f"{tag}: a fully masked row is not 0 / NEG_INF")
            res[str(dtype)[6:]] = dict(out_err=err_o, lse_err=err_l)
            if dtype == torch.bfloat16:
                res["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, bias),
                                    iters)
                res["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, bias), iters)
        print(f"K2 {name} BH={bh} Lq={lq} Lk={lk} D={d}: "
              f"fp32 out {res['float32']['out_err']:.3e} "
              f"lse {res['float32']['lse_err']:.3e} | "
              f"bf16 out {res['bfloat16']['out_err']:.3e} "
              f"lse {res['bfloat16']['lse_err']:.3e} | "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms",
              flush=True)
        results[name] = res
    return results


def phase_k2b(device, shapes=K2_SHAPES, iters=20):
    """The K2 backward kernel against its plain version at every shape,
    fp32 and bf16 (the plain version in fp32 on the same values); times in
    bf16. Returns {name: result dict}."""
    import torch
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    results = {}
    for i, (name, bh, lq, lk, d, masked, dead) in enumerate(shapes):
        res = {}
        scale = d ** -0.5
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            q, k, v, bias = k2_inputs(bh, lq, lk, d, masked, dead, dtype,
                                      device, seed=200 + i)
            g = torch.Generator(device="cpu").manual_seed(300 + i)
            dout = torch.randn(bh, lq, d, generator=g).to(device, dtype)
            out, lse = fa.flash_attention_reference(q, k, v, bias)
            out = out.to(dtype)
            got = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse,
                                                   dout, scale)
            want = fa.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), bias, out.float(), lse,
                dout.float())
            torch.cuda.synchronize()
            tag = f"K2b {name} {str(dtype)[6:]}"
            # (max|err|, its bound tol * max(1, max|want|)) of the worst grad
            res[str(dtype)[6:]], res[str(dtype)[6:] + "_bound"] = max(
                (compare(gt, wt, tol, f"{tag} {gn}"),
                 tol * max(1.0, wt.abs().max().item()))
                for gn, gt, wt in zip(("dq", "dk", "dv"), got, want))
            if dead:
                check(all(bool((gt[0] == 0).all()) for gt in got),
                      f"{tag}: a bh with every key masked has non-zero "
                      f"gradients")
            if dtype == torch.bfloat16:
                res["ms"] = time_ms(lambda: fa.flash_attention_backward_cuda(
                    q, k, v, bias, out, lse, dout, scale), iters)
                res["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, bias, out, lse, dout), iters)
        print(f"K2b {name} BH={bh} Lq={lq} Lk={lk} D={d}: "
              f"fp32 dq/dk/dv {res['float32']:.3e} (bound "
              f"{res['float32_bound']:.2e}) | bf16 {res['bfloat16']:.3e} "
              f"(bound {res['bfloat16_bound']:.2e}) | "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms",
              flush=True)
        results[name] = res
    return results


# ---------------------------------------------------------------------------
# K1: multi-branch dilated attention
# ---------------------------------------------------------------------------

def phase_k1(device, shape=(3, 10240, 16, 48), n_valid=9000,
             segments=None, ratios=None, iters=20):
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    mask = torch.zeros(b, length, dtype=torch.bool)
    mask[:, :n_valid] = True
    mask = mask.to(device)
    valid = mask[:, :, None, None]
    res = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 1.6e-2)):
        g = torch.Generator(device="cpu").manual_seed(7)
        q, k, v = (torch.randn(shape, generator=g).to(device, dtype)
                   for _ in range(3))
        kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
        got = dm.mega_dilated_attention(q, k, v, **kw)
        want = dilated_attention(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"K1 {dtype}: non-finite output (padded rows included)")
        tag = f"K1 {str(dtype)[6:]}"
        err = compare(got.float() * valid, want * valid, tol, f"{tag} out")
        res[str(dtype)[6:]] = err
        if dtype == torch.bfloat16:
            res["ms"] = time_ms(lambda: dm.mega_dilated_attention(q, k, v,
                                                                  **kw), iters)
            res["plain_ms"] = time_ms(lambda: dilated_attention(q, k, v, **kw),
                                      iters)
    print(f"K1 B={b} L={length} H={h} D={d} valid={n_valid} "
          f"segments={tuple(segments)} ratios={tuple(ratios)}: "
          f"fp32 out {res['float32']:.3e} | bf16 out {res['bfloat16']:.3e} | "
          f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms",
          flush=True)
    return res


def phase_k1b(device, shape=(3, 10240, 16, 48), n_valid=9000,
              segments=None, ratios=None, iters=10, plain_iters=3):
    """K1f's statistics and the K1 backward kernel against the plain
    version (its statistics, and autograd through it) at the train step's
    shape, fp32 and bf16, on the valid rows; times in bf16. The plain
    side keeps every branch's fp32 probabilities for its backward, 6.9 GB
    at this shape (35.9 M query-key pairs per (batch, head) x 48 x 4
    bytes), about 15 GB at its peak: it fits at B = 3."""
    import torch
    from modaltune_tpu_torch.configs import SlideEncoderConfig
    from modaltune_tpu_torch.ops.dilated import (dilated_attention,
                                                 dilated_attention_stats)
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    if segments is None:
        ln = SlideEncoderConfig().longnet()
        segments, ratios = ln.segment_lengths, ln.dilated_ratios
    b, length, h, d = shape
    scale = d ** -0.5
    mask = torch.zeros(b, length, dtype=torch.bool)
    mask[:, :n_valid] = True
    mask = mask.to(device)
    valid = mask[:, :, None, None]
    kw = dict(segment_lengths=segments, dilated_ratios=ratios, mask=mask)
    res = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
        g = torch.Generator(device="cpu").manual_seed(9)
        q, k, v, dmix = (torch.randn(shape, generator=g).to(device, dtype)
                         for _ in range(4))
        dmix = dmix * valid
        out, stats, branch_out = dm.mega_dilated_attention_cuda(
            q, k, v, mask, segments, ratios, scale, with_stats=True)
        got = dm.mega_dilated_attention_backward_cuda(
            q, k, v, mask, dmix, stats, branch_out, segments, ratios, scale)
        torch.cuda.synchronize()
        tag = f"K1b {str(dtype)[6:]}"
        want_st = dilated_attention_stats(q.float(), k.float(), v.float(),
                                          **kw)
        st_err = (stats - want_st).abs().max().item()
        check(st_err <= 1e-3 and bool(((stats == -1e9) ==
                                       (want_st == -1e9)).all()),
              f"K1f stats {str(dtype)[6:]}: max|err| {st_err:.3e}")
        del want_st
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(dilated_attention(*leaves, **kw),
                                dmix.float())
        want = [x.grad for x in leaves]
        del leaves
        torch.cuda.synchronize()
        err = max(compare(gt * valid, wt * valid, tol, f"{tag} {gn}")
                  for gn, gt, wt in zip(("dq", "dk", "dv"), got, want))
        res[str(dtype)[6:]] = dict(grad_err=err, stats_err=st_err)
        del want
        if dtype == torch.bfloat16:
            res["ms"] = time_ms(
                lambda: dm.mega_dilated_attention_backward_cuda(
                    q, k, v, mask, dmix, stats, branch_out, segments, ratios,
                    scale), iters)
            res["fwd_stats_ms"] = time_ms(
                lambda: dm.mega_dilated_attention_cuda(
                    q, k, v, mask, segments, ratios, scale, with_stats=True),
                iters)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            plain_out = dilated_attention(*leaves, **kw)
            res["plain_ms"] = time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, dmix, retain_graph=True), plain_iters,
                warmup=1)
            del plain_out, leaves
        torch.cuda.empty_cache()
    print(f"K1b B={b} L={length} H={h} D={d} valid={n_valid}: "
          f"stats fp32 {res['float32']['stats_err']:.3e} "
          f"bf16 {res['bfloat16']['stats_err']:.3e} | dq/dk/dv fp32 "
          f"{res['float32']['grad_err']:.3e} bf16 "
          f"{res['bfloat16']['grad_err']:.3e} | K1b kernel {res['ms']:.4f} "
          f"ms, plain backward {res['plain_ms']:.4f} ms | K1f with stats "
          f"{res['fwd_stats_ms']:.4f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# The slice: ModalTune-GigaPath embed step
# ---------------------------------------------------------------------------

def build_slice(device, dtype, cfg=None, n_genes=4987, n_groups=331,
                max_size=100, in_chans=1536, bag_range=(9000, 10239),
                bucket=10239, n_slides=3, seed=0):
    """Model (random weights, Injector gammas non-zero), embed step and
    the slides' batches on ``device``, built through the public entry
    points."""
    from modaltune_tpu_torch import make_embed_step
    from modaltune_tpu_torch.configs import TrainConfig
    from modaltune_tpu_torch.train import batch_to_device
    model, host = build_model_and_data(
        cfg, n_genes, n_groups, max_size, in_chans, bag_range, bucket,
        n_slides, seed)
    model = model.to(device=device, dtype=dtype).eval()
    batches = [batch_to_device(b, device) for b in host]
    return model, make_embed_step(model, TrainConfig()), batches


def build_model_and_data(cfg=None, n_genes=4987, n_groups=331, max_size=100,
                         in_chans=1536, bag_range=(9000, 10239), bucket=10239,
                         n_slides=3, seed=0):
    """The model on the CPU (random fp32 weights from ``seed``, Injector
    gammas non-zero) and the host batches of ``n_slides`` synthetic slides
    padded to ``bucket``, through the public entry points."""
    import torch
    from modaltune_tpu_torch import create_aggregator, init_weights
    from modaltune_tpu_torch.configs import gigapath_modaltune_config
    from modaltune_tpu_torch.data import (BucketedLoader, GenePacker,
                                          SyntheticSlideDataset,
                                          synthetic_pathways)
    cfg = cfg or gigapath_modaltune_config()
    groups = synthetic_pathways(n_genes=n_genes, n_groups=n_groups,
                                max_size=max_size, seed=0)
    packer = GenePacker.build(groups, [f"g{i}" for i in range(n_genes)])
    model = create_aggregator("longnetvit_gene_adapter", cfg=cfg,
                              n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():   # init_values = 0 would make the Injectors no-ops
        for block in model.interactions:
            block.injector.gamma.normal_(0.0, 0.1, generator=g)
    ds = SyntheticSlideDataset(n_cases=n_slides, in_chans=in_chans,
                               bag_range=bag_range, packer=packer,
                               n_genes=n_genes, seed=seed)
    loader = BucketedLoader(ds, buckets=(bucket,), batch_size=1,
                            shuffle=False, prefetch=0, device_prefetch=False)
    return model, list(loader)


def plain_kernels():
    """Patch the model's kernel entry points with their plain versions (a
    comparison path of this script only); autograd differentiates them."""
    from modaltune_tpu_torch.ops.dilated import dilated_attention
    from modaltune_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    return [mock.patch("modaltune_tpu_torch.models.longnet."
                       "mega_dilated_attention", dilated_attention),
            mock.patch("modaltune_tpu_torch.models.layers.flash_attention",
                       flash_attention_reference)]


def phase_slice(device, dtype, build_kw=None, timing_rounds=3, card=""):
    import torch
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    t0 = time.perf_counter()
    model, step, batches = build_slice(device, dtype, **(build_kw or {}))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: model built in {time.perf_counter() - t0:.1f} s, "
          f"{n_params} parameters, {len(batches)} slides of bucket "
          f"{batches[0]['bag'].shape[1]}", flush=True)

    # the main path: every launch count starts at 0 just before it
    fa.LAUNCHES = 0
    dm.LAUNCHES = 0
    outs = [step(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"K1": dm.LAUNCHES, "K2": fa.LAUNCHES}
    n_layers = len(model.backbone.encoder.layers)
    n_k2 = (sum(2 + len(blk.extra_extractors) for blk in model.interactions)
            + len(model.prompt_sa))
    for i, out in enumerate(outs):
        check(tuple(out.shape) == (1, 3, model.cfg.adapter.output_dim),
              f"slide {i}: embedding shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              f"slide {i}: non-finite embedding")
    check(launches == {"K1": n_layers * len(batches),
                       "K2": n_k2 * len(batches)},
          f"launch counts {launches} != {n_layers} K1 and {n_k2} K2 per "
          f"slide")
    print(f"slice: {len(outs)} embeddings {tuple(outs[0].shape)} finite; "
          f"launches K1 {launches['K1']} ({n_layers}/slide), "
          f"K2 {launches['K2']} ({n_k2}/slide)", flush=True)

    # the same slide through the plain versions
    patches = plain_kernels()
    for p in patches:
        p.start()
    try:
        plain = step(batches[0])
        torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    a, b = outs[0].float().flatten(), plain.float().flatten()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    rel = ((a - b).norm() / b.norm()).item()
    print(f"slice: kernel vs plain embeddings of slide 0: cosine {cos:.6f}, "
          f"rel-L2 {rel:.3e}", flush=True)
    check(cos >= 0.999 and rel <= 2e-2,
          f"kernel vs plain embeddings: cosine {cos:.6f}, rel-L2 {rel:.3e}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timing_rounds):
        for bt in batches:
            t = time.perf_counter()
            step(bt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: embed step {ms:.2f} ms/slide median of {len(times)} "
          f"({1e3 / ms:.3f} slides/s), peak allocated {peak / 2**30:.3f} GiB"
          f"{'; ' + card if card else ''}", flush=True)
    return dict(launches=launches, cosine=cos, rel_l2=rel, ms=ms,
                peak_bytes=peak, n_per_slide={"K1": n_layers, "K2": n_k2})


# Trainable tensors whose gradient is exactly zero in exact arithmetic and
# rounding noise in practice: attention key biases (softmax is shift
# invariant) and the gene mixer's per-token biases (a constant over
# channels, which every later LayerNorm removes).
NULL_GRAD = ("k_proj.bias", "token.b2", "compress_bias")


def build_train(device, seed=0, **data_kw):
    """The train step's model (frozen backbone in bf16, trainable adapter
    in fp32), optimizer, projected text targets and batch on ``device``;
    ``data_kw`` goes to :func:`build_model_and_data`."""
    import torch
    from modaltune_tpu_torch import (TextProjector, freeze_backbone,
                                     init_weights, make_optimizer,
                                     project_text)
    from modaltune_tpu_torch.configs import TrainConfig
    from modaltune_tpu_torch.train import batch_to_device
    model, host = build_model_and_data(n_slides=1, seed=seed, **data_kw)
    model = model.to(device)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg, freeze_backbone(model, torch.bfloat16),
                         steps_per_epoch=1)
    projector = init_weights(TextProjector(),
                             torch.Generator().manual_seed(seed + 99))
    projector = projector.to(device).requires_grad_(False)
    text = project_text(projector, torch.from_numpy(host[0].text).to(device))
    return model, tcfg, opt, text, batch_to_device(host[0], device)


def phase_train(device, steps=3, timed_steps=5, compare_bucket=2047,
                card="", build_kw=None):
    """The full-width train step: ``steps`` steps with the launch counts
    checked (K1f, K1b once per backbone layer, K2f, K2b once per adapter
    attention), loss finite, trainable parameters moved, frozen backbone
    bit-identical; then ms/step and peak memory over ``timed_steps``; then
    the step's loss and adapter gradients against the plain path at the
    ``compare_bucket`` bucket, where the plain path's saved scores fit
    (about 12 x 0.67 GB at 2,047): in bf16 as a whole, and in fp32 each
    gradient tensor on its own."""
    import torch
    from modaltune_tpu_torch import make_grad_step, make_train_step
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
    build_kw = build_kw or {}
    t0 = time.perf_counter()
    model, tcfg, opt, text, batch = build_train(device, **build_kw)
    step = make_train_step(model, tcfg, opt)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    gen = torch.Generator(device=device).manual_seed(1)
    torch.cuda.synchronize()
    print(f"train: model built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in before.values())} trainable fp32 and "
          f"{sum(p.numel() for p in frozen.values())} frozen bf16 "
          f"parameters, bucket {batch['bag'].shape[1]}", flush=True)

    # the main path: every launch count starts at 0 just before it
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    dm.LAUNCHES = dm.BWD_LAUNCHES = 0
    losses = [float(step(batch, text, gen)) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = {"K1f": dm.LAUNCHES, "K1b": dm.BWD_LAUNCHES,
                "K2f": fa.LAUNCHES, "K2b": fa.BWD_LAUNCHES}
    n_layers = len(model.backbone.encoder.layers)
    n_k2 = (sum(2 + len(blk.extra_extractors) for blk in model.interactions)
            + len(model.prompt_sa))
    per_step = {"K1f": n_layers, "K1b": n_layers, "K2f": n_k2, "K2b": n_k2}
    check(launches == {k: n * steps for k, n in per_step.items()},
          f"train launch counts {launches} != {per_step} per step x {steps}")
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    # every trainable tensor moves, except perhaps the NULL_GRAD ones
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), before[n])]
    check(all(n.endswith(NULL_GRAD) for n in still),
          f"trainable tensors did not move: {still}")
    moved = len(before) - len(still)
    check(all(torch.equal(p.detach(), frozen[n])
              for n, p in model.named_parameters() if not p.requires_grad),
          "the frozen backbone changed")
    print(f"train: {steps} steps, losses {[round(x, 6) for x in losses]}, "
          f"launches per step K1f {launches['K1f'] // steps} K1b "
          f"{launches['K1b'] // steps} K2f {launches['K2f'] // steps} K2b "
          f"{launches['K2b'] // steps}; {moved} of {len(before)} trainable "
          f"tensors moved, backbone bit-identical", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed_steps):
        t = time.perf_counter()
        step(batch, text, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"train: step {ms:.2f} ms median of {len(times)} "
          f"({[round(x, 2) for x in times]}), peak allocated "
          f"{peak / 2**30:.3f} GiB{'; ' + card if card else ''}", flush=True)
    del model, opt, step, frozen, before, batch
    torch.cuda.empty_cache()

    # kernel path vs plain path, one grad step each from the same weights
    # and the same dropout bits, at a bucket where the plain path fits: in
    # bf16 as the step trains, and in fp32 (the backbone cast up, so no
    # autocast), where rounding is small enough to hold each tensor alone
    model, tcfg, _, text, batch = build_train(
        device, bucket=compare_bucket,
        bag_range=(compare_bucket * 7 // 8, compare_bucket), **{
            k: v for k, v in build_kw.items()
            if k not in ("bucket", "bag_range")})
    model32 = copy.deepcopy(model)
    model32.backbone.float()
    runs = {}
    for dt, m in (("bf16", model), ("fp32", model32)):
        for plain in (False, True):
            patches = plain_kernels() if plain else []
            for p in patches:
                p.start()
            try:
                gen = torch.Generator(device=device).manual_seed(2)
                loss, grads = make_grad_step(m, tcfg)(batch, text, gen)
                runs[dt, plain] = (float(loss), {
                    n: g.float().flatten() for n, g in grads.items()})
                torch.cuda.synchronize()
            finally:
                for p in patches:
                    p.stop()
    (loss_k, g_k), (loss_p, g_p) = runs["bf16", False], runs["bf16", True]
    (loss_k32, g_k32), (loss_32, g_32) = (runs["fp32", False],
                                          runs["fp32", True])
    cos = torch.nn.functional.cosine_similarity(
        torch.cat(list(g_k.values())), torch.cat([g_p[n] for n in g_k]),
        dim=0).item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    rel32 = abs(loss_k32 - loss_32) / abs(loss_32)
    g_all = max(g.abs().max().item() for g in g_32.values())

    def rel_l2(g, want):
        return ((g - want).norm() / want.norm()).item()

    # fp32, each tensor on its own: rel-L2 of kernel vs plain; the NULL_GRAD
    # tensors, whose gradient is rounding noise, by max|kernel - plain| /
    # g_all. bf16: each tensor's rel-L2 from the fp32 plain path, the
    # kernel path's worst against the bf16 plain path's worst
    err32, null32, e_k, e_p = {}, {}, {}, {}
    for n, g in g_k32.items():
        if n.endswith(NULL_GRAD):
            null32[n] = (g - g_32[n]).abs().max().item() / g_all
            continue
        err32[n] = rel_l2(g, g_32[n])
        e_k[n], e_p[n] = rel_l2(g_k[n], g_32[n]), rel_l2(g_p[n], g_32[n])
    w32, wnull = max(err32, key=err32.get), max(null32, key=null32.get)
    wk, wp = max(e_k, key=e_k.get), max(e_p, key=e_p.get)
    print(f"train: kernel vs plain at bucket {compare_bucket}, bf16: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3e}); adapter gradients "
          f"cosine {cos:.6f}; largest per-tensor rel-L2 from the fp32 plain "
          f"path {e_k[wk]:.3e} ({wk}) vs {e_p[wp]:.3e} plain ({wp})",
          flush=True)
    print(f"train: kernel vs plain at bucket {compare_bucket}, fp32: loss "
          f"rel {rel32:.3e}; largest rel-L2 of a tensor (of {len(err32)}) "
          f"{err32[w32]:.3e} ({w32}); {len(null32)} NULL_GRAD tensors "
          f"{NULL_GRAD}: largest max|kernel - plain| / max|g| "
          f"{null32[wnull]:.3e} ({wnull}), max|g| {g_all:.3e}", flush=True)
    check(cos >= 0.999 and rel <= 1e-2 and e_k[wk] <= 2 * e_p[wp]
          and rel32 <= 1e-5 and err32[w32] <= 1e-4 and null32[wnull] <= 1e-4,
          f"train kernel vs plain: bf16 gradient cosine {cos:.6f}, loss rel "
          f"{rel:.3e}, worst tensor {e_k[wk]:.3e} vs {e_p[wp]:.3e} plain; "
          f"fp32 loss rel {rel32:.3e}, worst tensor {w32} {err32[w32]:.3e}, "
          f"NULL_GRAD max|err| / max|g| {null32[wnull]:.3e}")
    return dict(launches=launches, per_step=per_step, ms=ms, peak_bytes=peak,
                losses=losses, grad_cosine=cos, loss_rel=rel,
                grad_rel_fp32=err32[w32])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from modaltune_tpu_torch.ops import _build

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = _last_line(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader", "--id=0"])
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, "
          f"{_last_line([_build.find_nvcc(), '--version'])}", flush=True)
    print("card (nvidia-smi name, power.limit):")
    print(card, flush=True)

    # 2. build
    info = _build.build_library()
    _build.load_library()
    print(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    # 3-6. kernels against their plain versions
    k2 = phase_k2(device, iters=10)
    k2b = phase_k2b(device, iters=10)
    k1 = phase_k1(device, iters=10)
    k1b = phase_k1b(device)

    # 7. the embed step
    sl = phase_slice(device, torch.bfloat16, card=card, timing_rounds=2)

    # 8. the train step
    tr = phase_train(device, card=card)

    kernels = [
        {"name": "dilated_attention_fwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/dilated_attention_fwd.cu",
         "replaces": "modaltune_tpu/ops/dilated_mega.py:426",
         "launches": tr["launches"]["K1f"],
         "launches_embed": sl["launches"]["K1"],
         "max_abs_err": max(k1["float32"], k1["bfloat16"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "dilated_attention_bwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/dilated_attention_bwd.cu",
         "replaces": "modaltune_tpu/ops/dilated_mega.py:641",
         "launches": tr["launches"]["K1b"],
         "max_abs_err": max(k1b[dt]["grad_err"]
                            for dt in ("float32", "bfloat16")),
         "ms": k1b["ms"], "plain_ms": k1b["plain_ms"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "modaltune_tpu/ops/flash_attention.py:101",
         "launches": tr["launches"]["K2f"],
         "launches_embed": sl["launches"]["K2"],
         "max_abs_err": max(r[dt]["out_err"] for r in k2.values()
                            for dt in ("float32", "bfloat16")),
         "ms": k2["extractor"]["ms"],
         "plain_ms": k2["extractor"]["plain_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "modaltune_tpu/ops/flash_attention.py:214",
         "launches": tr["launches"]["K2b"],
         "max_abs_err": max(r[dt] for r in k2b.values()
                            for dt in ("float32", "bfloat16")),
         "ms": k2b["extractor"]["ms"],
         "plain_ms": k2b["extractor"]["plain_ms"]},
    ]
    # launches: the train step's run (launches_embed: the embed step's);
    # max_abs_err: the largest output or gradient error of any comparison
    # above; ms and plain_ms: K1f/K1b at their one shape, K2f/K2b at the
    # Extractor shape
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
