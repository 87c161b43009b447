"""Run one cell of the benchmark of ``modaltune_tpu_torch`` once.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with an NVIDIA GPU. Prints as the
last line of standard output one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``checks``: each number compared beside its limit); the same
numbers are the last lines of standard error. Exits non-zero, printing no
result, where there is no CUDA device or fewer than the cell asks for, or
where a module of the JAX side is loaded once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness import cell
    from benchmark.harness.manifest import Manifest

    chips = Manifest.load(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, STARTED,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    if result is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
