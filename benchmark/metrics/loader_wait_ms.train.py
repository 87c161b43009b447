"""Mean wait of a train step in the loader's ``next()``, ms: the trainer's
own ``loader_ms`` over every step of the window."""

from benchmark.harness.cell import mean


def read(view):
    if view.kind != "train":
        return None
    return mean(view.record["loader_ms"])
