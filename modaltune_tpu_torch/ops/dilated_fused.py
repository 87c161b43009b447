"""Multi-branch LongNet dilated attention as per-branch kernels and a mix.

Counterpart of ``modaltune_tpu/ops/dilated_fused.py::fused_dilated_attention``:
same signature and result as :func:`.dilated_mega.mega_dilated_attention`.
Where that kernel (K1) runs every branch inside one online softmax, this
route keeps the branches apart: each (segment length ``w``, ratio ``r``)
branch is an ordinary attention over its own *compact* rows, and a second
pass mixes the branches per (token, head) with ``softmax(lse)`` weights.

Compact layout of a branch. With ``sl = min(w, L)``, ``nseg = ceil(L / sl)``
and ``m = ceil(sl / r)``, head ``h`` (group ``g = h // (round_up(H, r) /
r)``) owns ``nseg * m`` rows: row ``n * m + l`` is the position
``n * sl + l * r + g``, real when ``l * r + g < sl`` and the position lies
below ``L``. A branch's tensors are ``(B, H, nseg * m, ...)``: only each
head's own rows, never the ``r``-times larger dense scatter. The branches'
rows are concatenated along that axis (``branch_rows`` gives the offsets).

A CUDA tensor goes to the hand-written Hopper kernels
``csrc/dilated_fused_fwd.cu`` (K3f: the branch attention and the mix) and,
for the gradient, ``csrc/dilated_fused_bwd.cu`` (K3b: the demix weights and
``delta``, the branch dq and dk/dv kernels, the combine). At D = 48
(:func:`card_family`) the branch attention is a tensor-core forward core
and the dq and dk/dv kernels a gradient core: at bf16
``csrc/dilated_fwd_wgmma.cu`` and ``csrc/dilated_bwd_wgmma.cu``, at fp32
the 3xTF32 cores ``csrc/dilated_fwd_tf32.cu`` and
``csrc/dilated_bwd_tf32.cu`` (:data:`CORE_SOURCES`); every core is shared
with K1. A CPU
tensor goes to the plain version :func:`.dilated.dilated_attention` under
autograd. The four ``fused_*_reference`` functions are the plain
versions of the four kernels, piece by piece.

For the backward the forward saves q, k, v, the mask, the compact branch
lses and the mix statistics ``m = max_b lse_b`` and
``Z = sum_b exp(lse_b - m)``, the Pallas kernels' residuals; the compact
branch outputs are freed after the mix, and K3b takes
``delta_b = rowsum(dO_b * o_b)`` as ``rowsum(P_b * dP_b)``. Under the
``"flash"`` remat policy the layer recomputes q, k and v, and the Function
keeps only its outputs (:mod:`.kept`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library
from .dilated import _round_up, dense_to_sparse, dilated_attention
from .dilated_mega import _DTYPE_CODES, _branch_args, _check, _ptr
from .flash_attention import (MASK_THRESHOLD, NEG_INF,
                              flash_attention_reference)
from .kept import kept

# Kernel launches since the last reset (read by chip_smoke.py): K3f (one per
# forward: the branch kernel and the mix kernel) and K3b (one per backward:
# its four kernels), each also by family (FAMILIES).
LAUNCHES = 0
BWD_LAUNCHES = 0
FAMILY_LAUNCHES = {"cuda_cores": 0, "wgmma": 0, "tf32x3": 0}
BWD_FAMILY_LAUNCHES = {"cuda_cores": 0, "wgmma": 0, "tf32x3": 0}
# K3f's two kernels launched one at a time (fused_forward_part_cuda)
PART_LAUNCHES = {"core": 0, "mix": 0}


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def branch_rows(length: int, segment_lengths: Sequence[int],
                dilated_ratios: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Per branch ``(offset, nseg, m)``: its compact rows per head are
    ``[offset, offset + nseg * m)`` of the concatenated row axis."""
    out, off = [], 0
    for w, r in zip(segment_lengths, dilated_ratios):
        sl = min(int(w), length)
        nseg, m = -(-length // sl), -(-sl // int(r))
        out.append((off, nseg, m))
        off += nseg * m
    return out


def total_rows(length: int, segment_lengths: Sequence[int],
               dilated_ratios: Sequence[int]) -> int:
    off, nseg, m = branch_rows(length, segment_lengths, dilated_ratios)[-1]
    return off + nseg * m


def to_compact(x: torch.Tensor, seg_len: int, ratio: int) -> torch.Tensor:
    """``(B, L, H, ...)`` -> one branch's compact ``(B, H, nseg * m, ...)``;
    rows that are no real position are zero (False)."""
    b, length, h = x.shape[:3]
    trailing = tuple(x.shape[3:])
    sl = min(seg_len, length)
    lp = _round_up(length, sl)
    n = lp // sl
    if lp != length:
        x = F.pad(x, [0, 0] * (x.dim() - 2) + [0, lp - length])
    xs = dense_to_sparse(x.reshape((b * n, sl, h) + trailing), ratio)
    m = xs.shape[1]
    xs = xs.reshape((b, n, m, h) + trailing).movedim(3, 1)
    return xs.reshape((b, h, n * m) + trailing)


def compact_rows(length: int, heads: int, seg_len: int, ratio: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(real (H, R) bool, position (H, R) long)`` of one branch's compact
    rows: whether the row is a real position, and which (0 where not)."""
    pos = torch.arange(length, device=device)[None, :, None]
    pos = to_compact(pos.expand(1, length, heads), seg_len, ratio)[0]
    real = torch.ones((1, length, heads), dtype=torch.bool, device=device)
    return to_compact(real, seg_len, ratio)[0], pos


def from_compact(x: torch.Tensor, length: int, seg_len: int, ratio: int,
                 fill: float = 0.0) -> torch.Tensor:
    """One branch's compact ``(B, H, R, ...)`` -> dense ``(B, H, L, ...)``;
    (token, head) slots the branch does not cover get ``fill``."""
    b, h = x.shape[:2]
    real, pos = compact_rows(length, h, seg_len, ratio, x.device)
    # every (head, position) is covered by at most one row
    row_of = torch.full((h, length), -1, dtype=torch.long, device=x.device)
    hh = torch.arange(h, device=x.device)[:, None].expand_as(pos)
    row_of[hh[real], pos[real]] = torch.arange(
        pos.shape[1], device=x.device)[None].expand_as(pos)[real]
    covered = row_of >= 0
    idx = row_of.clamp_min(0)
    view = (1, h, length) + (1,) * (x.dim() - 3)
    dense = torch.take_along_dim(x, idx.view(view), dim=2)
    return torch.where(covered.view(view), dense,
                       torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def _key_valid(mask, q, seg_len, ratio):
    b, length, h, _ = q.shape
    if mask is None:
        mask = torch.ones((b, length), dtype=torch.bool, device=q.device)
    return to_compact(mask.bool()[..., None].expand(b, length, h), seg_len,
                      ratio)


# ---------------------------------------------------------------------------
# Plain versions of the four kernels
# ---------------------------------------------------------------------------

def fused_branch_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor], seg_len: int,
                           ratio: int, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One branch's compact ``(out_b (B, H, R, D) in q's dtype, lse_b
    (B, H, R) fp32)``: softmax attention of each (segment, head group)'s
    rows over the valid keys among them. A row that is no real position,
    or has no valid key, has out 0 and lse ``NEG_INF``."""
    b, length, h, d = q.shape
    _, nseg, m = branch_rows(length, [seg_len], [ratio])[0]
    qc, kc, vc = (to_compact(t, seg_len, ratio).reshape(b * h * nseg, m, d)
                  for t in (q, k, v))
    valid = _key_valid(mask, q, seg_len, ratio).reshape(b * h * nseg, m)
    bias = torch.where(valid, 0.0, NEG_INF)
    out, lse = flash_attention_reference(qc, kc, vc, bias, scale)
    real, _ = compact_rows(length, h, seg_len, ratio, q.device)
    out = out.reshape(b, h, nseg * m, d) * real[None, :, :, None]
    lse = torch.where(real[None], lse.reshape(b, h, nseg * m), NEG_INF)
    return out, lse


def fused_mix_reference(outs: Sequence[torch.Tensor],
                        lses: Sequence[torch.Tensor], length: int,
                        segment_lengths: Sequence[int],
                        dilated_ratios: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The branches' compact ``(out_b, lse_b)`` mixed per (token, head):
    ``(mixed (B, L, H, D) in out_b's dtype, m (B, H, L), Z (B, H, L))``
    with ``m = max_b lse_b`` and ``Z = sum_b exp(lse_b - m)`` over the
    branches that cover the slot with an lse above ``MASK_THRESHOLD``
    (``m = NEG_INF``, ``Z = 0`` and mixed 0 where there is none)."""
    dense = [(from_compact(o.float(), length, int(w), int(r)),
              from_compact(l, length, int(w), int(r), fill=NEG_INF))
             for o, l, w, r in zip(outs, lses, segment_lengths,
                                   dilated_ratios)]
    m = torch.stack([l for _, l in dense]).amax(dim=0)
    z = torch.zeros_like(m)
    acc = torch.zeros_like(dense[0][0])
    for o, l in dense:
        wb = torch.where(l > MASK_THRESHOLD, torch.exp(l - m), 0.0)
        z = z + wb
        acc = acc + wb[..., None] * o
    mixed = acc / torch.where(z > 0, z, 1.0)[..., None]
    return mixed.permute(0, 2, 1, 3).to(outs[0].dtype), m, z


def fused_branch_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], lse_b: torch.Tensor, m: torch.Tensor,
        z: torch.Tensor, dmix: torch.Tensor, seg_len: int, ratio: int,
        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One branch's compact fp32 ``(dq_b, dk_b, dv_b)``, each (B, H, R, D),
    from its saved ``lse_b`` and the mix statistics. The demix weight
    ``wm = exp(lse_b - m) / Z`` (0 where lse_b is masked) scales ``dmix``
    and carries no gradient; ``P = exp(s - lse_b)`` is recomputed (a row
    with a masked lse takes ``+|NEG_INF / 2|`` in its place, so its P
    underflows to 0), ``delta = rowsum(P * dP)``."""
    b, length, h, d = q.shape
    _, nseg, rows = branch_rows(length, [seg_len], [ratio])[0]
    blocks = (b, h, nseg, rows)
    qc, kc, vc, dm = (to_compact(t.float(), seg_len, ratio)
                      .reshape(blocks + (d,)) for t in (q, k, v, dmix))
    valid = _key_valid(mask, q, seg_len, ratio).reshape(blocks)
    m_c, z_c = (to_compact(t.permute(0, 2, 1), seg_len, ratio)
                for t in (m, z))
    live = lse_b > MASK_THRESHOLD
    wm = torch.where(live, torch.exp(lse_b - m_c)
                     / torch.where(z_c > 0, z_c, 1.0), 0.0)
    do = dm * wm.reshape(blocks)[..., None]
    s = torch.matmul(qc * scale, kc.transpose(-1, -2))
    s = s + torch.where(valid, 0.0, NEG_INF)[..., None, :]
    lse_use = torch.where(live, lse_b, -MASK_THRESHOLD).reshape(blocks)
    p = torch.exp(s - lse_use[..., None])
    dp = torch.matmul(do, vc.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kc) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qc) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    return tuple(t.reshape(b, h, nseg * rows, d) for t in (dq, dk, dv))


def fused_combine_reference(grads: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]],
                            length: int, segment_lengths: Sequence[int],
                            dilated_ratios: Sequence[int], dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Dense ``(dq, dk, dv)``, each (B, L, H, D) in ``dtype``: the sum over
    the branches of their compact gradients at the positions each covers."""
    sums = [sum(from_compact(g[i].float(), length, int(w), int(r))
                for g, w, r in zip(grads, segment_lengths, dilated_ratios))
            for i in range(3)]
    return tuple(s.permute(0, 2, 1, 3).to(dtype) for s in sums)


def split_branches(x: torch.Tensor, length: int,
                   segment_lengths: Sequence[int],
                   dilated_ratios: Sequence[int]) -> List[torch.Tensor]:
    """The per-branch views of a concatenated compact ``(B, H, M, ...)``."""
    return [x.narrow(2, off, nseg * m) for off, nseg, m in
            branch_rows(length, segment_lengths, dilated_ratios)]


# ---------------------------------------------------------------------------
# The kernel families
# ---------------------------------------------------------------------------

# csrc/dilated_wgmma.cuh::dilated_family, by code
FAMILIES = ("cuda_cores", "wgmma", "tf32x3")
WGMMA_D = 48    # the head dimension of the tensor-core families
# tensor-core family -> (its forward core, its gradient core), under csrc/:
# both routes run them between their own prep, mix and combine kernels (the
# CUDA-core family's kernels are each route's own file)
CORE_SOURCES = {
    "wgmma": ("dilated_fwd_wgmma.cu", "dilated_bwd_wgmma.cu"),
    "tf32x3": ("dilated_fwd_tf32.cu", "dilated_bwd_tf32.cu"),
}


def family(d: int, dtype: torch.dtype) -> str:
    """The kernels that serve a dilated attention, K1's and K3's alike,
    forward and backward: ``"wgmma"`` (the compact-tile tensor-core cores,
    bf16 at D = :data:`WGMMA_D`, GigaPath's head size), ``"tf32x3"`` (the
    3xTF32 tensor-core cores on the same tiles at fp32 and D =
    :data:`WGMMA_D`) or ``"cuda_cores"`` (fp32 and bf16 at any other D).
    A tensor-core family's cores are :data:`CORE_SOURCES`'. The C entry
    points own the rule (``mt_dilated_family``) and the wrappers ask them
    (:func:`card_family`); this copy serves the CPU tests, and
    ``tests/test_torch_kernels_cuda.py`` holds it equal to the library's."""
    if d != WGMMA_D:
        return "cuda_cores"
    return {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(
        dtype, "cuda_cores")


def card_family(d: int, dtype: torch.dtype) -> str:
    """The family the C entry points choose on the card; builds the
    library on first use."""
    code = load_library().mt_dilated_family(d, _DTYPE_CODES[dtype])
    return FAMILIES[code]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def fused_dilated_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor],
                                 segment_lengths: Sequence[int],
                                 dilated_ratios: Sequence[int], scale: float):
    """Launch K3f (every branch's attention in one launch, then the mix) on
    ``q``'s device and current stream.

    Returns ``(mixed (B, L, H, D), out_c (B, H, M, D), lse_c (B, H, M),
    stats (2, B, H, L))``: the branches' compact outputs and lses
    concatenated along the row axis (:func:`split_branches`), and ``m``
    and ``Z``."""
    global LAUNCHES
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    rows = total_rows(length, segs, ratios)
    mixed = torch.empty_like(q)
    out_c = torch.empty((b, h, rows, d), dtype=q.dtype, device=q.device)
    lse_c = torch.empty((b, h, rows), dtype=torch.float32, device=q.device)
    stats = torch.empty((2, b, h, length), dtype=torch.float32,
                        device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_fused_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            mixed.data_ptr(), out_c.data_ptr(), lse_c.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), b, length, h, d,
            c_segs, c_ratios, len(segs), float(scale), _DTYPE_CODES[q.dtype],
            stream)
    check_launch(err, "mt_dilated_fused_fwd")
    LAUNCHES += 1
    FAMILY_LAUNCHES[card_family(d, q.dtype)] += 1
    return mixed, out_c, lse_c, stats


def fused_forward_part_cuda(part: str, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: Optional[torch.Tensor],
                            segment_lengths: Sequence[int],
                            dilated_ratios: Sequence[int], scale: float,
                            pieces: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None):
    """K3f's two kernels one at a time on ``q``'s device and current
    stream, as JAX's ``_branch_fwd_call`` and ``_mix_call`` are two calls:
    ``part="core"``, the tensor-core family's forward core alone (a
    CUDA-core family raises), returns ``(out_c, lse_c)``; ``part="mix"``,
    the mix alone of ``pieces = (out_c, lse_c)``, returns ``(mixed, stats
    (2, B, H, L))``. Their plain versions are :func:`fused_branch_reference`
    and :func:`fused_mix_reference`. It serves to time each kernel alone
    on the host's clock as well as the card's (a profiler's split of the
    whole call gives only the card's); the routes launch both in one call
    (:func:`fused_dilated_attention_cuda`). Counted in ``PART_LAUNCHES``,
    not in ``LAUNCHES``."""
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    rows = total_rows(length, segs, ratios)
    if part == "core":
        out_c = torch.empty((b, h, rows, d), dtype=q.dtype, device=q.device)
        lse_c = torch.empty((b, h, rows), dtype=torch.float32,
                            device=q.device)
        mixed = stats = None
    elif part == "mix":
        out_c, lse_c = pieces
        if out_c.shape != (b, h, rows, d) or out_c.dtype != q.dtype or \
                lse_c.shape != (b, h, rows) or \
                lse_c.dtype != torch.float32 or not out_c.is_contiguous() \
                or not lse_c.is_contiguous():
            raise ValueError("pieces do not match the forward core's")
        mixed = torch.empty_like(q)
        stats = torch.empty((2, b, h, length), dtype=torch.float32,
                            device=q.device)
    else:
        raise ValueError(f"part must be 'core' or 'mix', got {part!r}")
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_fused_fwd_part(
            0 if part == "core" else 1, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(mask), _ptr(mixed), out_c.data_ptr(),
            lse_c.data_ptr(), *((None, None) if stats is None else
                                (stats[0].data_ptr(), stats[1].data_ptr())),
            b, length, h, d, c_segs, c_ratios, len(segs), float(scale),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_dilated_fused_fwd_part")
    PART_LAUNCHES[part] += 1
    return (out_c, lse_c) if part == "core" else (mixed, stats)


def fused_dilated_attention_backward_cuda(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], dmix: torch.Tensor, lse_c: torch.Tensor,
        stats: torch.Tensor,
        segment_lengths: Sequence[int], dilated_ratios: Sequence[int],
        scale: float, return_compact: bool = False):
    """Launch K3b (the demix weights, with the CUDA-core kernels also
    ``delta``; every branch's dq, with a tensor-core core also ``delta``;
    every branch's dk/dv; the combine; the dq and dk/dv kernels in the
    family the C entry points choose) on ``q``'s device and current stream;
    returns ``(dq, dk, dv)``, and with ``return_compact`` also the fp32
    compact gradients ``(3, B, H, M, D)`` the combine summed."""
    global BWD_LAUNCHES
    segs, ratios, c_segs, c_ratios = _branch_args(segment_lengths,
                                                  dilated_ratios)
    _check(q, k, v, mask, segs, ratios)
    b, length, h, d = q.shape
    rows = total_rows(length, segs, ratios)
    if dmix.shape != q.shape or dmix.dtype != q.dtype or \
            dmix.device != q.device or not dmix.is_contiguous():
        raise ValueError(f"dmix must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    if lse_c.shape != (b, h, rows) or lse_c.dtype != torch.float32 or \
            not lse_c.is_contiguous() or \
            stats.shape != (2, b, h, length) or \
            stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError("lse_c/stats do not match the forward's")
    # per compact row: the demix weight and delta; then the compact grads
    wd = torch.empty((2, b, h, rows), dtype=torch.float32, device=q.device)
    grads_c = torch.empty((3, b, h, rows, d), dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_dilated_fused_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            dmix.data_ptr(), lse_c.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), wd[0].data_ptr(),
            wd[1].data_ptr(), grads_c[0].data_ptr(), grads_c[1].data_ptr(),
            grads_c[2].data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, length, h, d, c_segs, c_ratios, len(segs),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "mt_dilated_fused_bwd")
    BWD_LAUNCHES += 1
    BWD_FAMILY_LAUNCHES[card_family(d, q.dtype)] += 1
    return (dq, dk, dv, grads_c) if return_compact else (dq, dk, dv)


class _FusedDilatedAttention(torch.autograd.Function):
    """K3f forward, K3b backward; CUDA tensors only. Saves q, k, v, the
    mask, the compact lses and the mix statistics; a rematerialized
    region's recompute takes K3f's ``(mixed, lse_c, stats)`` back
    (:func:`.kept.kept`)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, segment_lengths, dilated_ratios, scale):
        def launch():
            mixed, _, lse_c, stats = fused_dilated_attention_cuda(
                q, k, v, mask, segment_lengths, dilated_ratios, scale)
            return mixed, lse_c, stats   # the compact outputs are freed
        mixed, lse_c, stats = kept(launch)
        ctx.save_for_backward(q, k, v, mask, lse_c, stats)
        ctx.branches = (segment_lengths, dilated_ratios, scale)
        return mixed

    @staticmethod
    def backward(ctx, dmix):
        q, k, v, mask, lse_c, stats = ctx.saved_tensors
        dq, dk, dv = fused_dilated_attention_backward_cuda(
            q, k, v, mask, dmix.contiguous(), lse_c, stats, *ctx.branches)
        return dq, dk, dv, None, None, None, None


def fused_dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, segment_lengths: Sequence[int],
                            dilated_ratios: Sequence[int],
                            mask: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Multi-branch LongNet dilated attention, differentiable in q, k, v.

    q/k/v ``(B, L, H, D)``, optional ``(B, L)`` bool validity mask, output
    ``(B, L, H, D)`` in q's dtype. CUDA tensors run the kernels (or
    raise): K3f alone when no gradient is needed, K3f and K3b behind an
    autograd Function otherwise. CPU tensors run the plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        branches = (tuple(int(w) for w in segment_lengths),
                    tuple(int(r) for r in dilated_ratios), float(scale))
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FusedDilatedAttention.apply(q, k, v, mask, *branches)
        return fused_dilated_attention_cuda(q, k, v, mask, *branches)[0]
    if q.device.type != "cpu":
        raise ValueError(f"fused_dilated_attention: unsupported device "
                         f"{q.device}")
    return dilated_attention(q, k, v, segment_lengths=segment_lengths,
                             dilated_ratios=dilated_ratios, mask=mask,
                             scale=scale)
