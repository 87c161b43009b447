"""The numbers that decide ``correct``, each beside its limit.

The checked train steps' losses (the largest gap relative to the
reference's loss), the first gradient's norm and the norm of the weights'
change after the checked steps, both by the worst trainable leaf:
the gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change. Beside them, by the same
worst leaf and base, the norm of the first gradient's difference
(``grad_diff_gap``): a norm cancels a rounding error's first order, the
difference does not; and the typical leaf's, the median over the moving
leaves of that norm over the leaf's own (``grad_diff_median``), which one
noisy small leaf does not move. The workload's ``limits`` say which are
compared.
"""

from __future__ import annotations

import statistics
from typing import Dict

# a leaf whose reference gradient norm is under this share of the median
# leaf's takes no part in the change
ROUND_OFF_LEAF = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names):
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def train(prog: dict, ref: dict) -> dict:
    """The numbers of the checked steps, by name."""
    if sorted(prog["grad"]) != sorted(ref["grad"]):
        raise ValueError("the program's and the reference's trainable "
                         "leaves differ")
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in leaves)
    moving = [n for n in leaves if ref["grad"][n] >= ROUND_OFF_LEAF * med]
    diff = {n: float((prog["first"][n].to(ref["first"][n].device).float()
                      - ref["first"][n].float()).norm()) for n in leaves}
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": _leaf_gap(prog["grad"], ref["grad"], leaves),
        "grad_diff_gap": max(diff[n] / max(ref["grad"][n], med)
                             for n in leaves),
        "grad_diff_median": statistics.median(diff[n] / ref["grad"][n]
                                              for n in moving),
        "change_norm_gap": _leaf_gap(prog["change"], ref["change"], moving),
    }


def held(values: dict, limits: dict) -> dict:
    """name -> (value, limit) of the numbers the workload gives a limit;
    the others are read and printed, not compared."""
    return {k: (v, limits[k]) for k, v in values.items() if k in limits}
