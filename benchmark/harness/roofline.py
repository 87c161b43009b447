"""Peaks of one NVIDIA H100 SXM and the least time a kernel could take:
the benchmark's frozen copy of ``chip_smoke.py``'s arithmetic
(``PEAK_*``, ``bound_ms``, ``attention_bound``, ``dilated_pairs``)."""

from __future__ import annotations

import functools

# dense rates of the data sheet at the full 700 W: bf16 tensor cores, TF32
# tensor cores, fp32 outside the tensor cores, HBM3
PEAK_FLOPS = 989e12
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """The larger of flops over the peak rate and bytes (each input read
    once, each output written once) over the memory rate, in seconds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def attention_bound_s(pairs: float, d: int, nbytes: float, backward: bool):
    """An attention kernel over ``pairs`` (query, unmasked key) pairs of
    head dimension ``d``: two products forward, five backward, 2 flop a
    multiply-add."""
    return bound_s((10 if backward else 4) * pairs * d, nbytes)


@functools.lru_cache(maxsize=None)
def dilated_pairs(length: int, n_valid: int, segments: tuple, ratios: tuple,
                  heads: int, q_range=None) -> float:
    """(query, unmasked key) pairs of one batch row of a dilated attention
    call, summed over its heads: in branch (w, r) a query meets the keys of
    its segment (of length min(w, L)) in its residue class mod r, for the
    heads of that class's group; keys past ``n_valid`` are masked. With
    ``q_range=(p0, p1)`` only the queries at positions in [p0, p1)."""
    p0, p1 = q_range or (0, length)
    total = 0
    for w, r in zip(segments, ratios):
        sl = min(w, length)
        per_group = -(-heads // r)
        for s0 in range(0, length, sl):
            s1 = min(s0 + sl, length)
            for g in range(r):
                n_heads = max(0, min(per_group, heads - g * per_group))
                n_q = len(range(max(s0 + g, _first(p0, s0 + g, r)),
                                min(s1, p1), r))
                n_k = len(range(s0 + g, min(s1, n_valid), r))
                total += n_heads * n_q * n_k
    return float(total)


def _first(p0: int, start: int, r: int) -> int:
    """The first position >= p0 of the class of ``start`` mod r."""
    if p0 <= start:
        return start
    return start + -(-(p0 - start) // r) * r
