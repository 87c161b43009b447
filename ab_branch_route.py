#!/usr/bin/env python3
"""A/B of GigaPath's per-branch route (``fused_attention=False``) on one
NVIDIA GPU: this tree's port against the port of another tree.

    python3 ab_branch_route.py PARENT_DIR

``PARENT_DIR`` is an earlier commit unpacked with ``git archive``; each
tree's port builds its own kernels. Each run is a process of its own, in
turns parent, this, this, parent, and reads on the port it imports:

- bf16 K2f and K2b at ``chip_smoke.BRANCH_SHAPES`` (the five branches of a
  LongNet layer at 10,240 tokens): median ms by CUDA events and on the card
  alone, and the family that ran;
- the route's embed ms/slide and train ms/step, each with its peak
  allocated memory, on ``chip_smoke.GIGAPATH_BRANCH``'s slides and weights.

Only entry points that every tree of the port has are called. Nothing is
checked but finiteness: ``chip_smoke.py`` holds the route and the kernels
to their references. Prints the readings side by side, then one JSON
object of every run. Exits non-zero without a CUDA device or when a run
fails.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ORDER = ("parent", "change", "change", "parent")


def _smoke():
    """This tree's ``chip_smoke.py``, loaded by path: with another tree's
    root first on ``sys.path`` its helpers then call that tree's port."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readings(timed_steps=5, rounds=2, device="cuda:0") -> dict:
    """One run of the A/B on the port that is imported."""
    import torch
    from modaltune_tpu_torch import make_train_step
    cs = _smoke()
    device = torch.device(device)
    fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
    res = {"card": cs._last_line(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader", "--id=0"]),
           "shapes": {}}
    for i, (name, bh, lq, lk, d, masked, dead) in enumerate(cs.BRANCH_SHAPES):
        q, k, v, bias = cs.k2_inputs(bh, lq, lk, d, masked, dead,
                                     torch.bfloat16, device, seed=100 + i)
        dout = torch.randn(bh, lq, d, generator=torch.Generator().manual_seed(
            300 + i)).to(device, torch.bfloat16)
        out, lse = fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)
        grads = fa.flash_attention_backward_cuda(q, k, v, bias, out, lse,
                                                 dout, d ** -0.5)
        cs.check(all(bool(torch.isfinite(t.float()).all())
                     for t in (out, *grads)), f"A/B {name}: non-finite")

        def fwd():
            return fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)

        def bwd():
            return fa.flash_attention_backward_cuda(q, k, v, bias, out, lse,
                                                    dout, d ** -0.5)
        res["shapes"][name] = dict(
            family=fa.card_family(lq, lk, d, torch.bfloat16),
            ms=cs.time_ms(fwd, 10), device_ms=cs.device_ms(fwd),
            bwd_ms=cs.time_ms(bwd, 10), bwd_device_ms=cs.device_ms(bwd))
        del q, k, v, bias, dout, out, lse, grads
    torch.cuda.empty_cache()

    model, step, batches = cs.build_slice(device, torch.bfloat16,
                                          **cs.GIGAPATH_BRANCH)
    for b in batches:   # warm-up
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(rounds):
        for b in batches:
            t = time.perf_counter()
            cs.check(bool(torch.isfinite(step(b).float()).all()),
                     "A/B embed: non-finite")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    res["embed_ms"] = statistics.median(times)
    res["embed_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, step, batches
    torch.cuda.empty_cache()

    model, tcfg, opt, text, batch = cs.build_train(device,
                                                   **cs.GIGAPATH_BRANCH)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(2):   # warm-up
        step(batch, text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed_steps):
        t = time.perf_counter()
        cs.check(math.isfinite(float(step(batch, text, gen))),
                 "A/B train: non-finite loss")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    res["train_ms"] = statistics.median(times)
    res["train_steps_ms"] = times
    res["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def main(parent: str, timeout=900) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ab_branch_route: no CUDA device", file=sys.stderr)
        return 1
    roots = {"parent": str(Path(parent).resolve()),
             "change": str(HERE.parent)}
    runs = []
    for tag in ORDER:
        code = ("import json, sys; sys.path.insert(0, {root!r}); "
                "import importlib.util as u; "
                "s = u.spec_from_file_location('ab_branch_route', {me!r}); "
                "m = u.module_from_spec(s); s.loader.exec_module(m); "
                "print('AB ' + json.dumps(m.readings()))").format(
                    root=roots[tag], me=str(HERE))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=roots[tag],
                              capture_output=True, text=True,
                              timeout=timeout)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(f"A/B {tag} run failed ({proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        runs.append((tag, json.loads(lines[-1][3:])))
        print(f"A/B {tag} ({roots[tag]}): {time.perf_counter() - t0:.1f} s; "
              f"{runs[-1][1]['card']}", flush=True)
    for name in runs[0][1]["shapes"]:
        for key, what in (("ms", "K2f"), ("bwd_ms", "K2b")):
            dev = "device_ms" if key == "ms" else "bwd_device_ms"
            print(f"A/B {what} {name}: " + " | ".join(
                f"{tag} ({r['shapes'][name]['family']}) "
                f"{r['shapes'][name][key]:.4f} ms, card "
                f"{r['shapes'][name][dev]:.4f}" for tag, r in runs),
                flush=True)
    for key, what in (("embed_ms", "branch embed ms/slide"),
                      ("train_ms", "branch train ms/step"),
                      ("embed_peak_gib", "branch embed peak GiB"),
                      ("train_peak_gib", "branch train peak GiB")):
        print(f"A/B {what}: " + " | ".join(
            f"{tag} {r[key]:.3f}" for tag, r in runs), flush=True)
    print(json.dumps({"ab": [dict(run=tag, **r) for tag, r in runs]}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
