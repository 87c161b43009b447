#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``modaltune_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes of the
ModalTune-GigaPath embed step, then runs that embed step end to end at
full published width (12-layer / 768-d / 16-head LongNet backbone, Modal
Adapter, gene mixer over 331 pathways, 3 task tokens) on three synthetic
10,239-patch slides, with random weights from a seeded generator. Every
phase prints its results on lines of its own; any failure raises and the
script exits non-zero. The last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists every kernel
of the path with its launches, error and time against its plain version.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import importlib
import json
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


# ---------------------------------------------------------------------------
# The slice: ModalTune-GigaPath embed step
# ---------------------------------------------------------------------------

def build_slice(device, dtype, cfg=None, n_genes=4987, n_groups=331,
                max_size=100, in_chans=1536, bag_range=(9000, 10239),
                bucket=10239, n_slides=3, seed=0):
    """Model (random weights, Injector gammas non-zero), embed step and
    the slides' batches on ``device``, built through the public entry
    points."""
    import torch
    from modaltune_tpu_torch import (create_aggregator, init_weights,
                                     make_embed_step)
    from modaltune_tpu_torch.configs import (TrainConfig,
                                             gigapath_modaltune_config)
    from modaltune_tpu_torch.data import (BucketedLoader, GenePacker,
                                          SyntheticSlideDataset,
                                          synthetic_pathways)
    from modaltune_tpu_torch.train import batch_to_device
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
    model = model.to(device=device, dtype=dtype).eval()
    ds = SyntheticSlideDataset(n_cases=n_slides, in_chans=in_chans,
                               bag_range=bag_range, packer=packer,
                               n_genes=n_genes, seed=seed)
    loader = BucketedLoader(ds, buckets=(bucket,), batch_size=1,
                            shuffle=False, prefetch=0, device_prefetch=False)
    batches = [batch_to_device(b, device) for b in loader]
    return model, make_embed_step(model, TrainConfig()), batches


def plain_kernels():
    """Patch the model's kernel entry points with their plain versions (a
    comparison path of this script only)."""
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

    # 3-4. kernels against their plain versions
    k2 = phase_k2(device)
    k1 = phase_k1(device)

    # 5. the slice
    sl = phase_slice(device, torch.bfloat16, card=card)

    kernels = [
        {"name": "dilated_attention_fwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/dilated_attention_fwd.cu",
         "replaces": "modaltune_tpu/ops/dilated_mega.py:426",
         "launches": sl["launches"]["K1"],
         "max_abs_err": max(k1["float32"], k1["bfloat16"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "modaltune_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "modaltune_tpu/ops/flash_attention.py:101",
         "launches": sl["launches"]["K2"],
         "max_abs_err": max(r[dt]["out_err"] for r in k2.values()
                            for dt in ("float32", "bfloat16")),
         "ms": k2["extractor"]["ms"],
         "plain_ms": k2["extractor"]["plain_ms"]},
    ]
    # max_abs_err: the largest output error of any comparison above; ms
    # and plain_ms: K1 at its one shape, K2 at the Extractor shape
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
