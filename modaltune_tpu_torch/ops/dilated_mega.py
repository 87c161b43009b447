"""Multi-branch LongNet dilated attention in one kernel launch.

Counterpart of ``modaltune_tpu/ops/dilated_mega.py::mega_dilated_attention``:
same signature and semantics as :func:`.dilated.dilated_attention`. A CUDA
tensor goes to the hand-written Hopper kernels ``csrc/dilated_attention_fwd.cu``
(K1f) and, for the gradient, ``csrc/dilated_attention_bwd.cu`` (K1b), in the
family that the C entry points choose (:func:`.dilated_fused.card_family`):
at D = 48 K1f is the family's tensor-core forward core into K3's compact
rows and K3f's mix, and K1b a prep onto those rows, the family's gradient
core and K3b's combine, every core shared with K3 (bf16:
``csrc/dilated_fwd_wgmma.cu``, ``csrc/dilated_bwd_wgmma.cu``; fp32: the
3xTF32 cores ``csrc/dilated_fwd_tf32.cu``, ``csrc/dilated_bwd_tf32.cu``);
else K1f is one CUDA-core kernel (every branch and the mix, q/k/v read in
place) and K1b CUDA-core kernels. A CPU tensor goes to the plain version
:func:`.dilated.dilated_attention`, and autograd differentiates it.

When the forward is recorded for autograd, K1f also writes what K1b needs:
``stats (B*H, n_br + 2, L)`` fp32 (each branch's lse, then
``m = max_b lse_b`` and ``Z = sum_b exp(lse_b - m)``, the layout of
:func:`.dilated.dilated_attention_stats`). The Function keeps q, k, v, the
mask and the stats, the Pallas kernel's residuals, and no branch output:
K1b takes ``delta_b = rowsum(dO_b * o_b)`` as ``rowsum(P_b * dP_b)`` from
the probabilities it recomputes. Under the ``"flash"`` remat policy the
layer recomputes q, k and v, and the Function keeps only its outputs
(:mod:`.kept`).

``q_token_range=(p0, p1)`` (the JAX kernel's ``qrange``, the
sequence-parallel shard's rows, :mod:`.dilated_sp`) computes only the
query rows ``[p0, p1)`` against every key; the rows outside come back zero
(and, in the stats, as rows without a valid key), and the backward gives dq
zero outside and the range's share of dk/dv. The kernels skip the query
tiles outside the range; :func:`query_tile_plan` is the CPU copy of the
tensor-core family's plan. Range launches are counted apart, in
``QRANGE_LAUNCHES`` and ``BWD_QRANGE_LAUNCHES`` (K1b in two parts: part 0
there, part 1 in ``BWD_PART1_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ._build import check_launch, load_library
from .dilated import check_q_token_range, dilated_attention
from .kept import kept

# Kernel launches since the last reset (read by chip_smoke.py): K1f and K1b
# (each also by family, dilated_fused.FAMILIES), and apart from them their
# launches with a q_token_range (K1b in two parts: part 0 with the range's,
# part 1 on its own).
LAUNCHES = 0
BWD_LAUNCHES = 0
FAMILY_LAUNCHES = {"cuda_cores": 0, "wgmma": 0, "tf32x3": 0}
BWD_FAMILY_LAUNCHES = {"cuda_cores": 0, "wgmma": 0, "tf32x3": 0}
QRANGE_LAUNCHES = 0
BWD_QRANGE_LAUNCHES = 0
BWD_PART1_LAUNCHES = 0

MAX_BRANCHES = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, mask, segment_lengths, dilated_ratios):
    if q.dim() != 4:
        raise ValueError("dilated attention takes (B, L, H, D) q/k/v")
    b, length, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or d > 128 or b > 65535 or h > 65535:
        raise ValueError(f"kernel takes D a multiple of 8 up to 128, got "
                         f"{tuple(q.shape)}")
    if not 1 <= len(segment_lengths) <= MAX_BRANCHES or \
            len(segment_lengths) != len(dilated_ratios):
        raise ValueError(f"kernel takes 1..{MAX_BRANCHES} branches with one "
                         f"ratio each, got {segment_lengths}, {dilated_ratios}")
    if min(segment_lengths) < 1 or min(dilated_ratios) < 1:
        raise ValueError("segment lengths and ratios must be positive")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if mask is not None:
        if mask.shape != (b, length) or mask.dtype != torch.bool or \
                mask.device != q.device or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous bool {(b, length)} "
                             f"tensor on {q.device}")


def _branch_args(segment_lengths, dilated_ratios):
    segs = [int(w) for w in segment_lengths]
    ratios = [int(r) for r in dilated_ratios]
    n = len(segs)
    return (segs, ratios, ctypes.cast((ctypes.c_int * n)(*segs), ctypes.c_void_p),
            ctypes.cast((ctypes.c_int * n)(*ratios), ctypes.c_void_p))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def query_tile_plan(length: int, segment_lengths: Sequence[int],
                    dilated_ratios: Sequence[int], q0: int, q1: int,
                    span: int = 1) -> List[Tuple[int, int]]:
    """The tensor-core family's tiles (``span=1``) or spans of two tiles
    (``span=2``) of the query range ``[q0, q1)``, per branch ``(first,
    count)`` in the branch's full enumeration (segment-major, 64-row
    compact tiles): the CPU copy of ``query_tiles`` in
    ``csrc/dilated_fused_common.cuh``. The run starts at the tile of row
    ``(q0 - s0) // r`` of the range's first segment and ends with the tile
    of row ``ceil((q1 - s0') / r) - 1`` of its last."""
    plan = []
    for w, r in zip(segment_lengths, dilated_ratios):
        sl, r = min(int(w), length), int(r)
        m = -(-sl // r)
        per_seg = -(-m // 64)
        units = -(-per_seg // span)
        seg_lo, seg_hi = q0 // sl, (q1 - 1) // sl
        t_lo = (q0 - seg_lo * sl) // r // 64
        t_hi = -(-min(m, -(-(q1 - seg_hi * sl) // r)) // 64)
        first = seg_lo * units + t_lo // span
        plan.append((first, seg_hi * units + -(-t_hi // span) - first))
    return plan


def mega_dilated_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mask: Optional[torch.Tensor],
                                segment_lengths: Sequence[int],
                                dilated_ratios: Sequence[int],
                                scale: float, with_stats: bool = False,
                                q_token_range: Optional[Tuple[int, int]]
                                = None):
    """Launch K1f on ``q``'s device and current stream: in a tensor-core
    family (``"wgmma"`` at bf16, ``"tf32x3"`` at fp32) its forward core
    into compact scratch (``(B, H, M, D)`` in q's dtype and ``(B, H, M)``
    fp32, 98 MB in bf16 and 196 MB in fp32 at the train step's shape, freed
    after the mix) and the mix; in the CUDA-core family one kernel (and,
    with a range, the fill of the rows outside it).

    Returns ``out``, or with ``with_stats`` ``(out, stats)`` (see the
    module docstring)."""
    from .dilated_fused import card_family, total_rows
    global LAUNCHES, QRANGE_LAUNCHES
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    q0, q1 = (0, length) if q_token_range is None else \
        check_q_token_range(q_token_range, ratios, length)
    n = len(segs)
    out_c = lse_c = None
    fam = card_family(d, q.dtype)
    if fam != "cuda_cores":
        rows = total_rows(length, segs, ratios)
        out_c = torch.empty((b, h, rows, d), dtype=q.dtype, device=q.device)
        lse_c = torch.empty((b, h, rows), dtype=torch.float32,
                            device=q.device)
    out = torch.empty_like(q)
    stats = None
    if with_stats:
        stats = torch.empty((b * h, n + 2, length), dtype=torch.float32,
                            device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            out.data_ptr(), _ptr(stats), _ptr(out_c),
            _ptr(lse_c), b, length, h, d, c_segs, c_ratios, n, float(scale),
            _DTYPE_CODES[q.dtype], q0, q1, stream)
    check_launch(err, "mt_dilated_attention_fwd")
    if q_token_range is None:
        LAUNCHES += 1
        FAMILY_LAUNCHES[fam] += 1
    else:
        QRANGE_LAUNCHES += 1
    return (out, stats) if with_stats else out


def mega_dilated_attention_backward_cuda(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], dmix: torch.Tensor, stats: torch.Tensor,
        segment_lengths: Sequence[int],
        dilated_ratios: Sequence[int], scale: float,
        q_token_range: Optional[Tuple[int, int]] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1b on ``q``'s device and current stream: in a tensor-core
    family (``"wgmma"`` at bf16, ``"tf32x3"`` at fp32) the compact prep, the
    dq and dk/dv kernels of its gradient core (the dq kernel takes
    ``delta_b``) and the combine, over fp32 compact scratch (``(3, B, H,
    M)`` row statistics and ``(3, B, H, M, D)`` gradients, 567 MB at the
    train step's shape); in the CUDA-core family
    the mix weights and ``delta_b`` (rebuilt over each row's keys), then
    dq, then dk/dv. Returns ``(dq, dk, dv)``; with the forward's
    ``q_token_range``, dq zero outside it and the range's share of dk/dv."""
    from .dilated_fused import card_family, total_rows
    global BWD_LAUNCHES, BWD_QRANGE_LAUNCHES
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    q0, q1 = (0, length) if q_token_range is None else \
        check_q_token_range(q_token_range, ratios, length)
    n = len(segs)
    if dmix.shape != q.shape or dmix.dtype != q.dtype or \
            dmix.device != q.device or not dmix.is_contiguous():
        raise ValueError(f"dmix must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    if stats.shape != (b * h, n + 2, length) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError("stats do not match the forward's")
    f32 = dict(dtype=torch.float32, device=q.device)
    wd = rows_c = grads_c = None
    fam = card_family(d, q.dtype)
    if fam != "cuda_cores":
        rows = total_rows(length, segs, ratios)
        rows_c = torch.empty((3, b, h, rows), **f32)
        grads_c = torch.empty((3, b, h, rows, d), **f32)
    else:   # per-branch mix weight w_b and delta_b, (B*H, n_br, L) each
        wd = torch.empty((2, b * h, n, length), **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            dmix.data_ptr(), stats.data_ptr(),
            *((None, None) if wd is None else (wd[0].data_ptr(),
                                              wd[1].data_ptr())),
            _ptr(rows_c), _ptr(grads_c), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, length, h, d, c_segs, c_ratios, n, float(scale),
            _DTYPE_CODES[q.dtype], q0, q1, stream)
    check_launch(err, "mt_dilated_attention_bwd")
    if q_token_range is None:
        BWD_LAUNCHES += 1
        BWD_FAMILY_LAUNCHES[fam] += 1
    else:
        BWD_QRANGE_LAUNCHES += 1
    return dq, dk, dv


def mega_dilated_attention_backward_part_cuda(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], dmix: torch.Tensor, stats: torch.Tensor,
        segment_lengths: Sequence[int], dilated_ratios: Sequence[int],
        scale: float, part: int, token_range: Tuple[int, int],
        scratch: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b of the bf16 tensor-core family in two parts over
    ``token_range`` (a sequence-parallel rank's rows, :mod:`.dilated_sp`),
    on ``q``'s device and current stream. ``scratch`` is ``(rows_c (3, B, H, M), grads_c (3,
    B, H, M, D))`` fp32, the same for both parts (:func:`part_scratch`).
    Part 0 (``dmix`` nonzero on the range's rows at least): ``dq`` of the
    range, 0 elsewhere, and in ``rows_c[2]`` every compact row's delta, 0
    outside the range's queries. Part 1, given every row's delta in
    ``rows_c[2]``, the whole ``dmix`` and the whole stats plane: ``dk`` and
    ``dv`` of the range's keys over every query, the whole call's bits
    (the rows of other keys are not meaningful). Returns ``(dq, dk, dv)``;
    part 0 counts one K1b launch with a range, part 1 one part-1 launch."""
    global BWD_QRANGE_LAUNCHES, BWD_PART1_LAUNCHES
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    r0, r1 = check_q_token_range(token_range, ratios, length)
    rows_c, grads_c = scratch
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_attention_bwd_part(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            dmix.data_ptr(), stats.data_ptr(), rows_c.data_ptr(),
            grads_c.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, length, h, d, c_segs, c_ratios, len(segs), float(scale),
            _DTYPE_CODES[q.dtype], int(part), r0, r1, stream)
    check_launch(err, "mt_dilated_attention_bwd_part")
    if part == 0:
        BWD_QRANGE_LAUNCHES += 1
    else:
        BWD_PART1_LAUNCHES += 1
    return dq, dk, dv


def part_scratch(q: torch.Tensor, segment_lengths: Sequence[int],
                 dilated_ratios: Sequence[int]):
    """The fp32 scratch of :func:`mega_dilated_attention_backward_part_cuda`."""
    from .dilated_fused import total_rows
    b, length, h, d = q.shape
    rows = total_rows(length, [int(w) for w in segment_lengths],
                      [int(r) for r in dilated_ratios])
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((3, b, h, rows), **f32),
            torch.empty((3, b, h, rows, d), **f32))


class _MegaDilatedAttention(torch.autograd.Function):
    """K1f (with stats) forward, K1b backward; CUDA tensors only. Saves
    q, k, v, the mask and the stats; a rematerialized region's recompute
    takes K1f's ``(out, stats)`` back (:func:`.kept.kept`)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, segment_lengths, dilated_ratios, scale,
                q_token_range):
        out, stats = kept(lambda: mega_dilated_attention_cuda(
            q, k, v, mask, segment_lengths, dilated_ratios, scale,
            with_stats=True, q_token_range=q_token_range))
        ctx.save_for_backward(q, k, v, mask, stats)
        ctx.branches = (segment_lengths, dilated_ratios, scale, q_token_range)
        return out

    @staticmethod
    def backward(ctx, dmix):
        q, k, v, mask, stats = ctx.saved_tensors
        dq, dk, dv = mega_dilated_attention_backward_cuda(
            q, k, v, mask, dmix.contiguous(), stats, *ctx.branches)
        return dq, dk, dv, None, None, None, None, None


def mega_dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, segment_lengths: Sequence[int],
                           dilated_ratios: Sequence[int],
                           mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           q_token_range: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Multi-branch LongNet dilated attention, differentiable in q, k, v.

    q/k/v ``(B, L, H, D)``, optional ``(B, L)`` bool validity mask, output
    ``(B, L, H, D)`` in q's dtype. CUDA tensors run the kernels (or
    raise): K1f alone when no gradient is needed, K1f with stats and K1b
    behind an autograd Function otherwise. CPU tensors run the plain
    version. ``q_token_range=(p0, p1)``, multiples of R = max ratio: only
    those query rows, the others zero (see the module docstring).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q_token_range is not None:
        q_token_range = check_q_token_range(q_token_range, dilated_ratios,
                                            q.shape[1])
    if q.device.type == "cuda":
        branches = (tuple(int(w) for w in segment_lengths),
                    tuple(int(r) for r in dilated_ratios), float(scale))
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _MegaDilatedAttention.apply(q, k, v, mask, *branches,
                                               q_token_range)
        return mega_dilated_attention_cuda(q, k, v, mask, *branches,
                                           q_token_range=q_token_range)
    if q.device.type != "cpu":
        raise ValueError(f"mega_dilated_attention: unsupported device "
                         f"{q.device}")
    return dilated_attention(q, k, v, segment_lengths=segment_lengths,
                             dilated_ratios=dilated_ratios, mask=mask,
                             scale=scale, q_token_range=q_token_range)
