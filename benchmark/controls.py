"""Readings that set the upper ends of a cell's limits, at the cell's own
size, on the chip; the benchmark's runs never run this.

    python benchmark/controls.py --workload NAME --seeds 11 12 13

For each seed it makes the cell's inputs as a run does and computes, with
the reference alone, the cell's compared numbers for

* ``control``: the reference in fp8 (e4m3 operands of every product, the
  precision below the configuration's bf16) in the program's place;
* ``half_bag``: the reference with the second half of every bag's valid
  tiles masked, in the program's place (half of the batch left out);

against the reference in fp32, over the steps a run checks: the first of
the seed's first epoch, one case of each bucket, in the order the
trainer's loader draws them. A state left unchanged reads 1 on the change
of the weights by definition and is not run. Prints one JSON line a seed
and variant, under ``chiprun_out/`` too when that directory exists.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# variant -> (precision, planted fault) of the reference in the program's
# place
VARIANTS = {"control": ("fp8", ""), "half_bag": ("fp32", "half_bag")}


def checked(ctx) -> list:
    """The cases a run checks, in the order the trainer's loader draws
    them."""
    from benchmark.entries import train
    order = train.visit_order(ctx.cases, ctx.workload["buckets"])
    return [k.case_id for k in order[:train.CHECKED_STEPS]]


def reference(ctx, ids, precision="fp32", fault=""):
    from benchmark.entries import train
    return train.reference_readings(ctx, ids, len(ctx.cases), precision,
                                    fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import importlib
    import torch
    from benchmark.harness import compare
    from benchmark.harness.cell import Context
    from benchmark.harness.inputs import Seeds
    from benchmark.harness.manifest import Manifest
    if not torch.cuda.is_available():
        print("controls.py: no CUDA device", file=sys.stderr)
        return 2
    m = Manifest.load(ROOT)
    cell = m.cell(args.workload)
    config, wl = m.config(cell), m.workload(cell)
    traffic = importlib.import_module(f"benchmark.traffic.{wl['generator']}")
    out = ROOT / "chiprun_out"
    for seed in args.seeds:
        seeds = Seeds.of(seed, wl["trainer_seed"])
        ctx = Context(m, cell, config, wl, seeds, torch.device("cuda:0"),
                      traffic.make_cohort(wl, config, seeds.data))
        ids = checked(ctx)
        ref = reference(ctx, ids)
        for variant in args.variants:
            t = time.perf_counter()
            got = reference(ctx, ids, *VARIANTS[variant])
            line = dict(workload=args.workload, seed=seed, variant=variant,
                        cases=ids, **compare.train(got, ref),
                        seconds=time.perf_counter() - t)
            print(json.dumps(line), flush=True)
            if out.is_dir():
                with open(out / "controls.jsonl", "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
