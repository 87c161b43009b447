#!/usr/bin/env python3
"""Device-time profile of one full-width ModalTune train step on one
NVIDIA GPU, over the GigaPath backbone or the TITAN backbone.

    python3 profile_train.py [--model gigapath|titan]
                             [--route default|fused|k5|branch]
                             [--remat off|flash|flash_ffn|full]
                             [--bf16 1|0]
                             [--bucket N] [--warmup 2] [--steps 10]
                             [--out FILE]
    (--route, --bucket: GigaPath only; ``--route fused`` profiles the step
    on the per-branch attention kernels K3 and the fused GELU -> LayerNorm
    K5 in place of K1 and the unfused FFN chain, ``--route k5`` on K1 with
    K5 (the JAX package's ``MODALTUNE_FUSED_GELU_LN=1`` on its default
    route), ``--route branch`` with
    ``fused_attention=False``: each branch's attention by K2 and the
    branches gathered, scattered and mixed in torch, with the unfused FFN;
    --remat, GigaPath only: the LongNet layers' rematerialization, off or
    under a policy of ``LongNetConfig.remat_policy``, default the config's
    own: on, ``"flash"``; ``--bf16 0``, both models: the frozen backbone in
    fp32 and no autocast, the train CLI's ``--bf16 0``)

Builds the train step as ``chip_smoke.py`` does (frozen backbone in bf16,
or fp32 with ``--bf16 0`` as ``chip_smoke.phase_train_fp32`` builds it;
adapter in fp32, bf16 autocast below an fp32 adapter, dropout on, random
weights from a seed,
one synthetic bag: padded to ``--bucket``, 10,239 patches unless given,
for GigaPath; grid-scattered into the 16,383-cell bucket for TITAN),
runs ``--warmup``
steps, then ``--steps`` timed steps (their median wall time, and the time
Python's garbage collector took in them, from ``gc.callbacks``), then one
step under ``torch.profiler`` with CUDA activity. Prints the step's
wall time, the host's side of it (the operators the profiler recorded on
the host, their count, and the 10 with the most self time on the host), the device's busy time (the union of every kernel, memcpy and
memset interval) and its share of the wall time, the device time of each
group of kernels (K1b, K1f, K2f, K2b, K3b, K3f, K4b, K4f, K5b, K5f, GEMMs,
LayerNorm, the rest) with
its share of the busy time, the same summed into GEMM, LayerNorm, the
port's kernels and the rest, and the 25 kernels with the most device time.
Writes the profiler's whole table to ``--out``. Exits non-zero when no
CUDA device is available or the profiler records no device time.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

# Kernels that K1b and K3b share (the tensor-core gradient cores of
# csrc/dilated_bwd_wgmma.cu and csrc/dilated_bwd_tf32.cu and the combine),
# and K1f and K3f (the tensor-core forward cores of
# csrc/dilated_fwd_wgmma.cu and csrc/dilated_fwd_tf32.cu and the mix): they
# count to the backward or the forward of the route that is profiled.
SHARED_BWD = ("dilated_bwd_dq_wg", "dilated_bwd_dkv_wg",
              "dilated_bwd_dq_tf32", "dilated_bwd_dkv_tf32", "fused_combine")
SHARED_FWD = ("dilated_fwd_wg", "dilated_fwd_tf32", "fused_mix")
# (group, substrings of the kernel name), first match wins
GROUPS = [
    ("K1b", ("dilated_bwd",)),
    ("K1f", ("dilated_fwd",)),
    ("K2b", ("flash_bwd",)),
    ("K2f", ("flash_fwd",)),
    ("K3b", ("fused_bwd", "fused_combine")),
    ("K3f", ("fused_branch_fwd", "fused_mix")),
    ("K4b", ("alibi_bwd",)),
    ("K4f", ("alibi_fwd",)),
    ("K5b", ("gelu_ln_bwd",)),
    ("K5f", ("gelu_ln_fwd",)),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
]


def group_of(name: str, backward: str = "K1b", forward: str = "K1f") -> str:
    """The group of a kernel; ``backward`` and ``forward`` are the profiled
    route's dilated backward and forward, K1b and K1f or K3b and K3f, which
    own the shared kernels."""
    if any(k in name for k in SHARED_BWD):
        return backward
    if any(k in name for k in SHARED_FWD):
        return forward
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, reductions, copies)"


def union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("gigapath", "titan"),
                    default="gigapath")
    ap.add_argument("--route", choices=("default", "fused", "k5", "branch"),
                    default="default",
                    help="GigaPath kernel route: K1 and the unfused FFN "
                         "chain (default), K3 and K5 (fused), K1 and K5 "
                         "(k5), or K2 per branch and the unfused FFN chain "
                         "(branch)")
    ap.add_argument("--bucket", type=int, default=None,
                    help="GigaPath bag bucket (default 10239)")
    ap.add_argument("--remat", default=None,
                    choices=("off", "flash", "flash_ffn", "full"),
                    help="GigaPath: the LongNet layers' rematerialization, "
                         "off or a remat_policy (default: the config's)")
    ap.add_argument("--bf16", type=int, choices=(0, 1), default=1,
                    help="0: the frozen backbone in fp32, no autocast (the "
                         "train CLI's --bf16 0)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10,
                    help="steps timed without the profiler")
    ap.add_argument("--out", default=None,
                    help="default: chiprun_out/profile_train"
                         "[_titan|_fused|_k5|_branch][_fp32].txt")
    args = ap.parse_args()
    fused = args.route == "fused"
    if args.out is None:
        tail = "_titan" if args.model == "titan" else \
            "" if args.route == "default" else f"_{args.route}"
        tail += "" if args.bf16 else "_fp32"
        args.out = os.path.join("chiprun_out", f"profile_train{tail}.txt")
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    from modaltune_tpu_torch import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    print("card (nvidia-smi name, power.limit):")
    print(chip_smoke._last_line(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader", "--id=0"]))
    if args.model == "titan":
        if (args.bucket is not None or args.route != "default"
                or args.remat is not None):
            ap.error("--bucket, --route and --remat apply to --model "
                     "gigapath; the TITAN step is profiled at "
                     "chip_smoke.TITAN's bucket")
        build_kw = dict(chip_smoke.TITAN)
    else:
        bucket = args.bucket or chip_smoke.GIGAPATH["bucket"]
        route = dict(default=chip_smoke.GIGAPATH,
                     fused=chip_smoke.GIGAPATH_FUSED,
                     k5=chip_smoke.GIGAPATH_K5,
                     branch=chip_smoke.GIGAPATH_BRANCH)[args.route]
        build_kw = dict(route, bucket=bucket,
                        bag_range=(min(9000, bucket * 7 // 8), bucket))
        if args.remat is not None:
            build_kw = chip_smoke.with_remat(
                build_kw, args.remat != "off",
                "flash" if args.remat == "off" else args.remat)
    args.bucket = build_kw["bucket"]
    if not args.bf16:
        build_kw = dict(build_kw, frozen="float32")
    model, tcfg, opt, text, batch = chip_smoke.build_train(device, **build_kw)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(args.warmup):
        step(batch, text, gen)
    torch.cuda.synchronize()
    enc = getattr(model.backbone, "encoder", None)
    remat = ("off" if enc is None or not enc.cfg.remat
             else enc.cfg.remat_policy)
    what = (f"{args.model} train step ({args.route} route, remat {remat}, "
            f"backbone {'bf16' if args.bf16 else 'fp32'})")
    walls, gc_ms = [], []
    with chip_smoke.gc_timer() as in_gc:
        for _ in range(args.steps):
            before = in_gc["ms"]
            t = time.perf_counter()
            step(batch, text, gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            gc_ms.append(in_gc["ms"] - before)
    if walls:
        print(f"{what} at bucket {args.bucket}: wall {statistics.median(walls):.2f} "
              f"ms median of {len(walls)} ({[round(x, 2) for x in walls]}); "
              f"Python's garbage collector {statistics.median(gc_ms):.2f} ms "
              f"a step, median ({in_gc['collections']} collections, "
              f"{in_gc['gen2']} of generation 2)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch, text, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # device-side kernels, copies and sets; not the ranges that annotate them
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        print("profile_train: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    busy = union_ms((e.time_range.start, e.time_range.end) for e in dev)
    by_group, by_name, calls = {}, {}, {}
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        group = group_of(e.name, *(("K3b", "K3f") if fused else
                                   ("K1b", "K1f")))
        by_group[group] = by_group.get(group, 0) + ms
        by_name[e.name] = by_name.get(e.name, 0) + ms
        calls[e.name] = calls.get(e.name, 0) + 1

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    kernels = sum(1 for e in dev if "memcpy" not in e.name.lower()
                  and "memset" not in e.name.lower())
    print(f"{what} at bucket {args.bucket}, profiled: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms (busy share {busy / wall:.3f}), peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"{kernels} kernels and {len(dev) - kernels} copies or sets on the "
          f"card, {len(host)} operators recorded on the host")
    print(f"{'host operator':<60} {'calls':>6} {'self host ms':>12}")
    for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total
                    )[:10]:
        print(f"{a.key[:60]:<60} {a.count:>6} "
              f"{a.self_cpu_time_total / 1e3:>12.2f}")
    print(f"{'group':<42} {'device ms':>10} {'of busy':>8}")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"{group:<42} {ms:>10.2f} {ms / busy:>8.1%}")
    # the same in four: the port's kernels (K1-K5) against the library's
    split = {}
    for group, ms in by_group.items():
        key = ("the port's kernels" if group[:1] == "K" and group[1:2].isdigit()
               else group if group in ("GEMM", "LayerNorm") else "the rest")
        split[key] = split.get(key, 0) + ms
    print("split: " + ", ".join(
        f"{key} {split.get(key, 0):.2f} ms ({split.get(key, 0) / busy:.1%})"
        for key in ("GEMM", "LayerNorm", "the port's kernels", "the rest")))
    print(f"{'kernel':<80} {'calls':>5} {'device ms':>10}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{name[:80]:<80} {calls[name]:>5} {ms:>10.2f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=-1))
    print(f"profiler table -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
