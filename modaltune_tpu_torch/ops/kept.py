"""What an attention Function keeps for its backward, handed back when a
rematerialized region runs again.

Under the ``"flash"`` remat policy a LongNet layer
(:mod:`..models.longnet`) is rematerialized from its input through
LayerNorm, the q/k/v projections and the attention call, so its backward
holds neither q/k/v nor anything the attention derived from them: JAX's
``"flash"`` policy keeps only the attention kernels' tagged outputs. The
attention Functions (K1, K3, K2 and the sequence-parallel island) compute
the outputs they keep through :func:`kept`. Outside such a region it just
computes them. On the region's first run it computes them and records them
on the region's :class:`KeptOutputs`; when the backward runs the region
again, it hands back the recorded tensors in the same order instead of
launching the forward kernel again, and the Function saves them beside the
recomputed q/k/v.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, List, Optional, Tuple

import torch

_CURRENT: contextvars.ContextVar[Optional["KeptOutputs"]] = \
    contextvars.ContextVar("kept_outputs", default=None)


class KeptOutputs:
    """The kept outputs of one rematerialized region's attention calls, in
    the order of the calls."""

    def __init__(self):
        self._outputs: List[Tuple[torch.Tensor, ...]] = []
        self._next: Optional[int] = None   # the next call's, on a replay

    @contextlib.contextmanager
    def active(self, replay: bool) -> Iterator["KeptOutputs"]:
        """Within, the region's calls record their outputs (``replay``
        False: the first run) or take them back (True: a recompute)."""
        self._next = 0 if replay else None
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def _take(self, compute: Callable[[], Tuple[torch.Tensor, ...]]
              ) -> Tuple[torch.Tensor, ...]:
        if self._next is None:
            out = compute()
            self._outputs.append(tuple(t.detach() for t in out))
            return out
        out = self._outputs[self._next]
        self._next += 1
        return tuple(t.detach() for t in out)


def kept(compute: Callable[[], Tuple[torch.Tensor, ...]]
         ) -> Tuple[torch.Tensor, ...]:
    """``compute()``, a tuple of tensors, except on a recompute of a
    region that keeps them: then the tensors its first run computed (new
    tensor objects sharing their storage), and ``compute`` is not called."""
    outputs = _CURRENT.get()
    return compute() if outputs is None else outputs._take(compute)
