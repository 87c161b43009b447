"""Device idle between the traced epoch's train-step windows, ms a traced
step, scaled to the untraced epoch: the per-step sync, the loader, the
copy, the text projection and the forward's prologue
(``harness/step_windows.py``, read from the port's ``mt.train.step`` and
``mt.train.loss_read`` spans)."""

from benchmark.harness.step_windows import idle_ms


def read(view):
    got = idle_ms(view)
    return None if got is None else got[1]
