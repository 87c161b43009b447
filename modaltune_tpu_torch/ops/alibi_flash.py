"""Flash attention with the 2-D ALiBi bias computed inside the kernel
(the TITAN backbone's attention).

Counterpart of ``modaltune_tpu/ops/alibi_flash.py``. A CUDA tensor goes to
the hand-written Hopper kernels behind ``csrc/alibi_attention_fwd.cu``
(K4f) and, for the gradient, ``csrc/alibi_attention_bwd.cu`` (K4b), in
three families (:func:`family`): at D = 64 (the model's case) bf16 on the
Hopper frame ``csrc/attention_wgmma.cuh`` (``"wgmma"``) and fp32 on the
3xTF32 kernels ``csrc/alibi_tf32_{fwd,bwd}.cu`` (``"tf32x3"``), both
reading the side inputs made here once per forward and kept for its
backward (lane-major coordinates, a key term of 0 or ``-inf``, the live
64-key tiles); any other D on CUDA cores (``"cuda_cores"``). A CPU tensor
goes to :func:`alibi_attention_reference` and
:func:`alibi_attention_backward_reference`, the plain PyTorch versions of
the same functions, which are also the kernels' oracles.

For batch row b, head h, query i and key j::

    s_ij = q_i . k_j * scale
           - slope_h * ||c_i - c_j||_2 * (1 - cls_i) * (1 - cls_j)
           + key_bias_j

with ``coords3[b, i] = [row, col, is_cls]`` (the cls token's row and
column carry no distance bias) and ``key_bias`` 0 for a valid key and
``NEG_INF`` for a masked one. A masked key gets exactly zero weight and
zero gradient; a row without a valid key gets output 0, lse ``NEG_INF``
and zero gradients. The (H, N, N) bias never exists in device memory.
Only q, k and v are differentiated: coords, slopes and the key mask are
inputs that nothing learns, and ``lse`` is an output without a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.tracing import span
from ._build import check_launch, load_library
from .flash_attention import _DTYPE_CODES, MASK_THRESHOLD, NEG_INF

# The kernel families, by the code of the C rule (mt_alibi_family).
FAMILIES = ("cuda_cores", "wgmma", "tf32x3")

# Kernel launches since the last reset (read by chip_smoke.py): K4f and K4b,
# and the same by family.
LAUNCHES = 0
BWD_LAUNCHES = 0
FAMILY_LAUNCHES = dict.fromkeys(FAMILIES, 0)
BWD_FAMILY_LAUNCHES = dict.fromkeys(FAMILIES, 0)


def _plain_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs; fp64 for fp64 ones (the fp64 oracle)."""
    return torch.promote_types(q.dtype, torch.float32)


def alibi_scores_bias(coords3: torch.Tensor, slopes: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense (B, H, N, N) ALiBi term of the scores in ``dtype`` (fp32
    unless given), for the plain versions: ``-slope_h * dist_ij *
    not_cls_ij``."""
    c = coords3.to(dtype)
    d = c[:, :, None, :2] - c[:, None, :, :2]
    dist = torch.sqrt((d * d).sum(dim=-1))
    not_cls = (1.0 - c[:, :, None, 2]) * (1.0 - c[:, None, :, 2])
    return -slopes.to(dtype)[None, :, None, None] * (dist * not_cls)[:, None]


def alibi_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, coords3: torch.Tensor,
                              slopes: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ALiBi attention with the kernel's semantics, in fp32
    (in fp64 for fp64 inputs: the oracle of the fp32 kernels on the card).

    q/k/v: (B, H, N, D); coords3: (B, N, 3); slopes: (H,); key_mask:
    (B, N) bool. Returns ``(out (B, H, N, D) in q's dtype, lse (B, H, N)
    fp32, or fp64 for fp64 inputs)``. The softmax runs over the valid keys
    only (a masked key's probability is exactly 0 and the rest sum to 1, as
    the JAX oracle re-normalises them). Out of place, so autograd differentiates
    ``out``; ``lse`` is detached. Autocast is off inside, so the products
    stay in fp32 under the train step's bf16 autocast too, as the JAX
    package's reference computes them at HIGHEST precision.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = _plain_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)) * scale \
            + alibi_scores_bias(coords3, slopes, dt)
        if key_mask is not None:
            s = torch.where(key_mask[:, None, None, :], s, NEG_INF)
        # the shift cancels in the softmax, so it carries no gradient
        m = s.detach().amax(dim=-1, keepdim=True)
        # next to a valid key a masked key's exp(NEG_INF - m) is exactly 0;
        # a row with none (m <= NEG_INF/2) is zeroed below
        p = torch.exp(s - m)
        live = m > MASK_THRESHOLD
        l_safe = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
        out = (torch.einsum("bhqk,bhkd->bhqd", p, v.to(dt)) / l_safe
               * live).to(q.dtype)
        lse = torch.where(live[..., 0],
                          m[..., 0] + torch.log(l_safe[..., 0]), NEG_INF)
    return out, lse.detach()


def alibi_attention_backward_reference(q, k, v, coords3, slopes, key_mask,
                                       out, lse, dout,
                                       scale: Optional[float] = None):
    """Plain PyTorch gradient of :func:`alibi_flash_attention` from its
    saved ``out`` and ``lse``: the formulas of the JAX package's
    ``_dq_kernel`` and ``_dkv_kernel``.

    ``delta = rowsum(dout * out)``, ``P = exp(s - lse)`` with the forward's
    scores ``s`` (0 for a masked key), ``dS = P * (dout V^T - delta)``,
    ``dq = dS K scale``, ``dk = dS^T Q scale``, ``dv = P^T dout``. A row
    without a valid key (lse ``NEG_INF``) takes ``+|NEG_INF/2|`` in lse's
    place, so its P underflows to 0. Returns ``(dq, dk, dv)`` in the dtypes
    of q, k and v. In fp32 under autocast too, as
    :func:`alibi_attention_reference` (in fp64 for fp64 inputs).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = _plain_dtype(q)
    qf, kf, vf, do = q.to(dt), k.to(dt), v.to(dt), dout.to(dt)
    with torch.autocast(q.device.type, enabled=False):
        delta = (do * out.to(dt)).sum(dim=-1, keepdim=True)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale \
            + alibi_scores_bias(coords3, slopes, dt)
        lse_use = torch.where(lse > MASK_THRESHOLD, lse, -MASK_THRESHOLD)
        p = torch.exp(s - lse_use[..., None])
        if key_mask is not None:
            p = torch.where(key_mask[:, None, None, :], p, 0.0)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The Hopper families at D = 64 (csrc/attention_wgmma.cuh for bf16,
# csrc/alibi_tf32.cuh for fp32) work on 64-row tiles.
TILE = 64
WGMMA_HEAD_DIM = 64
# a row without a valid key has lse NEG_INF; the backward puts this in its
# place so that the row's P underflows to 0 (log2 units)
_LSE_DEAD = 1e30
_LOG2E = 1.4426950408889634


def family(q: torch.Tensor) -> str:
    """The kernels that serve ``q``: ``"wgmma"`` (bf16 at D =
    :data:`WGMMA_HEAD_DIM`), ``"tf32x3"`` (fp32 there) or ``"cuda_cores"``
    (every other D).

    The C entry points own this rule (``csrc/alibi_tf32.cuh::
    alibi_family``) and the card's calls ask them (:func:`card_family`).
    This copy serves the CPU, where no library is built;
    ``tests/test_torch_kernels_cuda.py`` holds it equal to the library's on
    the card."""
    if q.shape[-1] != WGMMA_HEAD_DIM:
        return "cuda_cores"
    return {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(
        q.dtype, "cuda_cores")


def card_family(q: torch.Tensor) -> str:
    """The family that the C entry points choose for ``q`` on the card
    (``mt_alibi_family``; a dtype no kernel takes asks with code -1, and the
    launch raises); builds the library on first use."""
    return FAMILIES[load_library().mt_alibi_family(
        q.shape[-1], _DTYPE_CODES.get(q.dtype, -1))]


def work_floats(b: int, h: int, n: int) -> int:
    """fp32 scratch of the 3xTF32 backward: every (b, h)'s vbar (the mean of
    its valid keys' v rows, D = 64 floats), then its delta and its lse in
    base 2, each padded to whole 64-row tiles, in that order
    (``csrc/alibi_tf32_bwd.cu::launch_alibi_tf32_bwd``)."""
    return b * h * (WGMMA_HEAD_DIM + 2 * (-(-n // TILE) * TILE))


def lane_major_coords(coords3: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3)`` [row, col, is_cls] -> ``(B, 3, NP)`` contiguous fp32
    planes row, col and is_cls, NP = N rounded up to a multiple of 64, zeros
    past N: 64 keys' worth of one plane is one 256-byte copy."""
    planes = coords3.to(torch.float32).transpose(1, 2)
    return F.pad(planes, (0, -coords3.shape[1] % TILE)).contiguous()


def padded_key_mask(key_mask: Optional[torch.Tensor], b: int, n: int,
                    device) -> torch.Tensor:
    """``(B, NP)`` bool: the key mask (all valid if None), False past N."""
    pad = -n % TILE
    if key_mask is None:
        return (torch.arange(n + pad, device=device) < n).expand(b, -1)
    if pad == 0:
        return key_mask
    return torch.cat((key_mask, key_mask.new_zeros((b, pad))), dim=1)


def live_key_tiles(valid: torch.Tensor) -> torch.Tensor:
    """Which 64-key tiles of each batch row hold a valid key, from the
    padded ``(B, NP)`` mask: int32 ``(B, NP / 64)``, 1 for a live tile. The
    kernels visit a row's live tiles in ascending order and never load the
    others."""
    return valid.reshape(valid.shape[0], -1, TILE).any(dim=-1).to(torch.int32)


def key_terms(valid: torch.Tensor) -> torch.Tensor:
    """``(B, NP)`` fp32: 0 for a valid key, ``-inf`` for a masked one or
    one past N, added to the score so that its weight is exactly 0."""
    return torch.where(valid, 0.0, -torch.inf).contiguous()


def wgmma_side_inputs(coords3, key_mask, b: int, n: int):
    """What the Hopper kernels read beside q, k and v:
    ``[lane_major_coords, key_terms, live_key_tiles]``. The forward's serve
    its backward too."""
    valid = padded_key_mask(key_mask, b, n, coords3.device)
    return [lane_major_coords(coords3), key_terms(valid),
            live_key_tiles(valid)]


def backward_rows(lse: torch.Tensor, delta: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-query rows the Hopper backward streams, ``(B, H, NP)`` fp32:
    lse in log2 units, with ``_LSE_DEAD`` for a row without a valid key and
    past N (so that the row's P underflows to 0), and delta, 0 past N."""
    pad = -lse.shape[-1] % TILE
    lse2 = torch.where(lse > MASK_THRESHOLD, lse * _LOG2E, _LSE_DEAD)
    return (F.pad(lse2, (0, pad), value=_LSE_DEAD).contiguous(),
            F.pad(delta, (0, pad)).contiguous())


def _key_bias(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if key_mask is None:
        return None
    return torch.where(key_mask, 0.0, NEG_INF).to(torch.float32).contiguous()


def _check(q, k, v, coords3, slopes, key_mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"alibi_flash_attention takes q, k and v of one "
                         f"(B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (d <= 128 and b * h <= 65535 and n >= 1):
        raise ValueError(f"kernel takes D <= 128, B*H <= 65535 and N >= 1, "
                         f"got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t, shape in (("coords3", coords3, (b, n, 3)),
                           ("slopes", slopes, (h,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {q.device}")
    if key_mask is not None and (tuple(key_mask.shape) != (b, n)
                                 or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be a bool {(b, n)} tensor on "
                         f"{q.device}")


def _check_aligned(fam: str, *tensors) -> None:
    """The Hopper families read and write 16-byte chunks (TMA, cp.async):
    a view that does not start on a 16-byte boundary raises."""
    if fam != "cuda_cores" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {fam} kernels take 16-byte aligned q, k, v, "
                         f"out and dout")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def alibi_flash_attention_cuda(q, k, v, coords3, slopes, key_mask,
                               scale: float, side=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K4f kernel of ``q``'s family (:func:`card_family`) on
    ``q``'s device and current stream, or raise. ``side``:
    :func:`wgmma_side_inputs` of these coords and mask, where the caller
    holds them already."""
    global LAUNCHES
    _check(q, k, v, coords3, slopes, key_mask)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    bias = None
    fam = card_family(q)
    _check_aligned(fam, q, k, v)
    if fam == "cuda_cores":
        bias, side = _key_bias(key_mask), [None] * 3
    elif side is None:
        side = wgmma_side_inputs(coords3, key_mask, b, n)
    lib = load_library()
    with span("mt.op.k4f"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_alibi_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), coords3.data_ptr(),
            slopes.data_ptr(), _ptr(bias), out.data_ptr(), lse.data_ptr(),
            b, h, n, d, float(scale), _DTYPE_CODES[q.dtype],
            *map(_ptr, side), stream)
    check_launch(err, "mt_alibi_attention_fwd")
    LAUNCHES += 1
    FAMILY_LAUNCHES[fam] += 1
    return out, lse


def alibi_flash_attention_backward_cuda(q, k, v, coords3, slopes, key_mask,
                                        out, lse, dout, scale: float,
                                        side=None):
    """Launch the K4b kernels of ``q``'s family (:func:`card_family`; dq,
    then dk/dv) on ``q``'s device and current stream, or raise. The
    ``"tf32x3"`` kernels make ``delta = rowsum(dout * out)`` themselves
    (centered, ``csrc/alibi_tf32_bwd.cu``) in fp32 scratch allocated here;
    for the other families it is computed here in torch, as the JAX package
    computes it outside its Pallas kernels. ``side``: the forward's
    :func:`wgmma_side_inputs`, where the caller kept them."""
    global BWD_LAUNCHES
    _check(q, k, v, coords3, slopes, key_mask)
    b, h, n, d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    if tuple(lse.shape) != (b, h, n) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, n)} "
                         f"tensor")
    if out.shape != q.shape or out.dtype != q.dtype or \
            out.device != q.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fam = card_family(q)
    _check_aligned(fam, q, k, v, out, dout)
    bias = delta = work = None
    if fam != "tf32x3":
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    if fam == "cuda_cores":
        bias, side = _key_bias(key_mask), [None] * 5
    else:
        if side is None:
            side = wgmma_side_inputs(coords3, key_mask, b, n)
        if fam == "wgmma":
            side = [*side, *backward_rows(lse, delta)]
        else:
            side = [*side, None, None]
            work = torch.empty(work_floats(b, h, n), dtype=torch.float32,
                               device=q.device)
    lib = load_library()
    with span("mt.op.k4b"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_alibi_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), coords3.data_ptr(),
            slopes.data_ptr(), _ptr(bias), dout.data_ptr(), lse.data_ptr(),
            _ptr(delta), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, d, float(scale), _DTYPE_CODES[q.dtype],
            *map(_ptr, side), out.data_ptr(), _ptr(work), stream)
    check_launch(err, "mt_alibi_attention_bwd")
    BWD_LAUNCHES += 1
    BWD_FAMILY_LAUNCHES[fam] += 1
    return dq, dk, dv


class _AlibiFlashAttention(torch.autograd.Function):
    """K4f forward, K4b backward on CUDA tensors; the plain versions on
    CPU tensors. ``lse`` is an output without a gradient. The Hopper
    families' side inputs are made in the forward and kept for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, coords3, slopes, key_mask, scale):
        ctx.side = None
        if q.device.type == "cuda":
            if card_family(q) != "cuda_cores":
                ctx.side = wgmma_side_inputs(coords3, key_mask, q.shape[0],
                                             q.shape[2])
            out, lse = alibi_flash_attention_cuda(
                q, k, v, coords3, slopes, key_mask, scale, side=ctx.side)
        else:
            out, lse = alibi_attention_reference(q, k, v, coords3, slopes,
                                                 key_mask, scale)
        ctx.save_for_backward(q, k, v, coords3, slopes, key_mask, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, coords3, slopes, key_mask, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = alibi_flash_attention_backward_cuda(
                q, k, v, coords3, slopes, key_mask, out, lse,
                dout.contiguous(), ctx.scale, side=ctx.side)
        else:
            grads = alibi_attention_backward_reference(
                q, k, v, coords3, slopes, key_mask, out, lse, dout, ctx.scale)
        return (*grads, None, None, None, None)


def alibi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          coords3: torch.Tensor, slopes: torch.Tensor,
                          key_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """ALiBi flash attention, differentiable in q, k and v.

    q/k/v: ``(B, H, N, D)`` contiguous; coords3: ``(B, N, 3)`` =
    [row, col, is_cls]; slopes: ``(H,)``; key_mask: ``(B, N)`` bool;
    scale defaults to ``D ** -0.5``. Returns ``(B, H, N, D)``. CUDA
    tensors run the kernels (or raise), CPU tensors the plain versions.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"alibi_flash_attention: unsupported device "
                         f"{q.device}")
    out, _ = _AlibiFlashAttention.apply(
        q, k, v, coords3.to(torch.float32).contiguous(),
        slopes.to(torch.float32).contiguous(), key_mask, float(scale))
    return out
