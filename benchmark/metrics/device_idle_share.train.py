"""Share of an epoch in which no operation ran on the device, %: 1 - (union
of the device intervals of the traced epoch) / (the median untraced epoch
on the host clock). Every epoch does the same work; the profiler stretches
the one it traces on the host, not the device's work."""

import statistics


def read(view):
    if view.kind != "train" or view.trace is None or \
            not view.untraced_pass_s:
        return None
    return 100.0 * (1.0 - view.trace.busy_s()
                    / statistics.median(view.untraced_pass_s))
