"""Flash attention with an additive key bias, returning the log-sum-exp.

Counterpart of ``modaltune_tpu/ops/flash_attention.py``. A CUDA tensor
goes to the hand-written Hopper kernels of K2f and, for the gradient, K2b,
in one of four families that the C entry points choose from the shape and
the dtype (:func:`card_family`; :func:`family` is its copy for the CPU):

* the short-side families: head dimension 16 with one side of at most
  :data:`SHORT_SIDE` rows, which is every adapter attention of the models,
  in bf16 (``csrc/flash_short_side_{fwd,bwd}.cu``, ``"short_keys"`` and
  ``"short_queries"``: ``mma.sync`` bf16) and in fp32
  (``csrc/flash_short_side_tf32_{fwd,bwd}.cu``, ``"short_keys_tf32"`` and
  ``"short_queries_tf32"``: 3xTF32 on the TF32 tensor cores, every product
  at fp32 accuracy). That side is resident in every block, the other is
  split into :func:`long_side_chunks` chunks streamed once, and the chunks'
  partials are added in a fixed order in fp32 scratch that this module
  allocates (:func:`workspace_floats`);
* the wgmma family (``csrc/flash_wgmma_{fwd,bwd}.cu``): bf16 at head
  dimension :data:`WGMMA_D` (48), any Lq and Lk, which is every call of
  the per-branch dilated attention (:mod:`.dilated`, the CLI's
  ``--fused_attention 0``): 64-row tiles on the tensor cores, dead key
  tiles skipped, P rounded once to bf16 in the forward, P and dS as hi +
  lo bf16 parts in the backward, whose dq kernel makes delta into fp32
  scratch that this module allocates;
* its fp32 sibling, the 3xTF32 family (``csrc/flash_tf32_{fwd,bwd}.cu``):
  fp32 at head dimension 48, any Lq and Lk, which is every call of the
  per-branch route under an fp32 backbone (the CLI's ``--bf16 0``): the
  dilated 3xTF32 cores' frame on contiguous rows, every product as three
  TF32 products on the tensor cores (fp32 accuracy), summed a half tile
  at a time in fresh fragments, delta made by the dq kernel into fp32
  scratch as in the wgmma family, dP - delta taken against v and out less
  vbar, the valid keys' mean v row, which a first kernel writes there
  (as the fp32 short-keys kernel takes it);
* the CUDA-core kernels (``csrc/flash_attention_{fwd,bwd}.cu``) for every
  other shape: other D in fp32 and bf16, both sides long at D = 16.

The short-side, wgmma and 3xTF32 families read their tensors in 16-byte
chunks and raise on one that is not 16-byte aligned. No family falls back
to another.

A CPU tensor goes to :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, the plain PyTorch versions of
the same functions, which are also the kernels' oracles.

Semantics: ``bias`` is ``(BH, Lk)``, an additive float: 0 for a valid
key and ``NEG_INF`` for a masked one on the model's calls, any value in
general, a key with bias ``<= NEG_INF/2`` being masked. A masked key gets
exactly zero weight (and zero gradient), and a row whose keys are all
masked gets output 0, lse ``NEG_INF`` and zero gradients. ``lse`` is not differentiated: its
cotangent is dropped, as the JAX package's ``_bwd_pallas`` drops it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..utils.tracing import span
from ._build import check_launch, load_library
from .kept import kept

NEG_INF = -1e9
MASK_THRESHOLD = NEG_INF * 0.5

# Kernel launches since the last reset (read by chip_smoke.py): K2f and K2b.
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The short-side families (csrc/flash_short_side.cuh, bf16;
# csrc/flash_short_side_tf32.cuh, fp32): head dimension SHORT_SIDE_D with one
# side of at most SHORT_SIDE rows. The long side is cut
# into TILE-row tiles and split into chunks of MIN_CHUNK_TILES to
# MAX_CHUNK_TILES tiles, one block per (bh, chunk), aiming at BLOCKS_PER_SM
# blocks on each SM of the card.
SHORT_SIDE = 128
SHORT_SIDE_D = 16
TILE = 64
BLOCKS_PER_SM = 4
MIN_CHUNK_TILES, MAX_CHUNK_TILES = 2, 64


# The wgmma family (csrc/flash_wgmma.cuh, bf16) and the 3xTF32 family
# (csrc/flash_tf32.cuh, fp32): this head dimension.
WGMMA_D = 48

# csrc/flash_short_side.cuh::Family, by code
FAMILIES = ("cuda_cores", "short_keys", "short_queries", "wgmma",
            "short_keys_tf32", "short_queries_tf32", "tf32x3")

# The same launches by family, keyed by FAMILIES (read by chip_smoke.py).
FAMILY_LAUNCHES = dict.fromkeys(FAMILIES, 0)
BWD_FAMILY_LAUNCHES = dict.fromkeys(FAMILIES, 0)


def family(lq: int, lk: int, d: int, dtype: torch.dtype) -> str:
    """The kernels that serve a call: ``"wgmma"`` (bf16 at D =
    :data:`WGMMA_D`, any Lq and Lk), ``"tf32x3"`` (fp32 there),
    ``"short_keys"`` (at most :data:`SHORT_SIDE` keys, the Injector and
    the prompt self-attention), ``"short_queries"`` (at most that many
    queries, the Extractor), both bf16 at D = 16, ``"short_keys_tf32"``
    and ``"short_queries_tf32"`` (the same sides in fp32 at D = 16), or
    ``"cuda_cores"`` (every other shape: other D, both sides long).

    The C entry points own this rule (``csrc/flash_short_side.cuh::family``)
    and the card's calls ask them (:func:`card_family`). This copy serves
    the CPU, where no library is built: the step-by-step emulation and the
    chunk plan's tests. ``tests/test_torch_kernels_cuda.py`` holds it equal
    to the library's on the card.
    """
    if d == WGMMA_D and dtype in _DTYPE_CODES:
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    if dtype in _DTYPE_CODES and d == SHORT_SIDE_D:
        tail = "_tf32" if dtype == torch.float32 else ""
        if lk <= SHORT_SIDE:
            return "short_keys" + tail
        if lq <= SHORT_SIDE:
            return "short_queries" + tail
    return "cuda_cores"


def long_side_chunks(bh: int, long_len: int, n_sms: int) -> int:
    """How many chunks the short-side family splits the long side of each
    bh into: enough that ``bh`` times as many blocks give each of ``n_sms``
    SMs about :data:`BLOCKS_PER_SM`, at least :data:`MIN_CHUNK_TILES` tiles
    a chunk where the side allows, at most :data:`MAX_CHUNK_TILES` (the
    chunk's bias or lse entries live in shared memory)."""
    tiles = -(-long_len // TILE)
    chunks = min(-(-BLOCKS_PER_SM * n_sms // bh),
                 max(1, tiles // MIN_CHUNK_TILES))
    return max(chunks, -(-tiles // MAX_CHUNK_TILES))


def workspace_floats(fam: str, backward: bool, bh: int, lq: int, lk: int,
                     chunks: int) -> int:
    """fp32 scratch of a call: the short-side forward's short-queries
    partials (acc, m, l of every (bh, chunk, padded query)), the short-side
    backward's partial dk and dv (short keys) or dq (short queries) of
    every (bh, chunk, padded resident row), the wgmma backward's delta of
    every (bh, query), the 3xTF32 backward's vbar of every bh (the mean of
    its valid keys' v rows, :data:`WGMMA_D` floats) and then that delta;
    0 where the family needs none. The fp32 short-side family's scratch is
    the bf16 one's."""
    fam = fam.removesuffix("_tf32")
    if fam == "wgmma":
        return bh * lq if backward else 0
    if fam == "tf32x3":
        return bh * (WGMMA_D + lq) if backward else 0
    if fam == "cuda_cores" or (fam == "short_keys" and not backward):
        return 0
    short = -(-(lk if fam == "short_keys" else lq) // 16) * 16
    rows = bh * chunks * short
    if not backward:
        return rows * (SHORT_SIDE_D + 2)
    return rows * SHORT_SIDE_D * (2 if fam == "short_keys" else 1)


def card_family(lq: int, lk: int, d: int, dtype: torch.dtype) -> str:
    """The family that the C entry points choose for a call on the card
    (``mt_flash_attention_family``); builds the library on first use."""
    code = load_library().mt_flash_attention_family(lq, lk, d,
                                                   _DTYPE_CODES[dtype])
    return FAMILIES[code]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(q, k, backward, tensors):
    """``(family, chunks, scratch or None)`` of a call on the card, the
    family as the C entry points choose it. The short-side families' bulk
    copies or 16-byte ``cp.async`` and the wgmma and 3xTF32 families'
    16-byte chunks need 16-byte aligned ``tensors`` (q/k/v, dout/out, the
    gradients)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    fam = card_family(lq, lk, d, q.dtype)
    if fam == "cuda_cores":
        return fam, 0, None
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {fam} flash attention kernels take 16-byte "
                         f"aligned tensors")
    chunks = 0
    if fam.startswith("short"):
        long_len = lq if fam.startswith("short_keys") else lk
        chunks = long_side_chunks(bh, long_len,
                                  _sm_count(q.device.index or 0))
    n = workspace_floats(fam, backward, bh, lq, lk, chunks)
    work = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    return fam, chunks, work


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for the plain versions' products, fp64 for fp64 inputs."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's semantics, in fp32 (in
    fp64 for fp64 q, a more exact oracle for the fp32 kernels).

    ``q``: (BH, Lq, D); ``k``/``v``: (BH, Lk, D); ``bias``: (BH, Lk)
    additive. Returns ``(out (BH, Lq, D) in q's dtype, lse (BH, Lq) fp32 or
    fp64)``. Out of place, so autograd differentiates ``out``; ``lse`` is
    detached. Autocast is off inside, so the products stay in fp32 under
    the train step's bf16 autocast too, as the JAX package's reference
    computes them at HIGHEST precision.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _compute_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        s = torch.bmm(q.to(acc), k.to(acc).transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, None, :].to(acc)
        # the shift cancels in the softmax, so it carries no gradient
        m = s.detach().amax(dim=-1, keepdim=True)
        # With one valid key in a row, a masked key's exp(NEG_INF - m) is
        # exactly 0; a row with none (m <= NEG_INF/2) is zeroed below.
        p = torch.exp(s - m)
        live = m > MASK_THRESHOLD
        l_safe = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
        out = (torch.bmm(p, v.to(acc)) / l_safe * live).to(q.dtype)
        lse = torch.where(live[..., 0],
                          m[..., 0] + torch.log(l_safe[..., 0]), NEG_INF)
    return out, lse.detach()


def flash_attention_backward_reference(q, k, v, bias, out, lse, dout,
                                       scale: Optional[float] = None):
    """Plain PyTorch gradient of :func:`flash_attention` from its saved
    ``out`` and ``lse``: the formulas of the JAX package's ``_bwd_pallas``.

    ``delta = rowsum(dout * out)``, ``P = exp(s * scale + bias - lse)``
    (0 for a masked key), ``dS = P * (dout V^T - delta)``,
    ``dq = dS K scale``, ``dk = dS^T Q scale``, ``dv = P^T dout``. A row
    whose keys are all masked (lse ``NEG_INF``) takes ``+|NEG_INF/2|`` in
    lse's place, so its P underflows to 0. Returns ``(dq, dk, dv)`` in
    the dtypes of q, k and v. In fp32 (fp64 for fp64 q) under autocast
    too, as :func:`flash_attention_reference`.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _compute_dtype(q)
    qf, kf, vf, do = (x.to(acc) for x in (q, k, v, dout))
    with torch.autocast(q.device.type, enabled=False):
        delta = (do * out.to(acc)).sum(dim=-1, keepdim=True)
        s = torch.bmm(qf, kf.transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, None, :].to(acc)
        lse_use = torch.where(lse > MASK_THRESHOLD, lse, -MASK_THRESHOLD)
        p = torch.exp(s - lse_use[..., None].to(acc))
        if bias is not None:
            p = torch.where(bias[:, None, :] > MASK_THRESHOLD, p, 0.0)
        ds = p * (torch.bmm(do, vf.transpose(1, 2)) - delta)
        dq = torch.bmm(ds, kf) * scale
        dk = torch.bmm(ds.transpose(1, 2), qf) * scale
        dv = torch.bmm(p.transpose(1, 2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH, L, D) q, k and v")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (d <= 128 and bh <= 65535 and q.shape[1] >= 1 and k.shape[1] >= 1):
        raise ValueError(f"kernel takes D <= 128, BH <= 65535 and non-empty "
                         f"rows, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if bias is not None:
        if bias.shape != (bh, k.shape[1]) or bias.device != q.device \
                or bias.dtype != torch.float32 or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous float32 "
                             f"{(bh, k.shape[1])} tensor on {q.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2f on ``q``'s device and current stream: the wgmma or
    3xTF32 family's kernel, a short-side family's (and, for short queries,
    its combine) or the CUDA-core kernel, as :func:`card_family` says."""
    global LAUNCHES
    _check(q, k, v, bias)
    bh, lq, d = q.shape
    out = torch.empty_like(q)
    fam, chunks, work = _plan(q, k, False, (q, k, v, out))
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    lib = load_library()
    with span("mt.op.k2f"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, lq, k.shape[1], d,
            float(scale), _DTYPE_CODES[q.dtype], chunks,
            None if work is None else work.data_ptr(), stream)
    check_launch(err, "mt_flash_attention_fwd")
    LAUNCHES += 1
    FAMILY_LAUNCHES[fam] += 1
    return out, lse


def flash_attention_backward_cuda(q, k, v, bias, out, lse, dout, scale: float):
    """Launch the K2b kernels on ``q``'s device and current stream: the
    wgmma or 3xTF32 family's dq and dk/dv kernels, or a short-side
    family's gradient kernel and its fixed-order sum, which make ``delta
    = rowsum(dout * out)`` themselves, or the CUDA-core dq and dk/dv
    kernels, for which it is computed here in torch, as the JAX package
    computes it outside its Pallas kernels."""
    global BWD_LAUNCHES
    _check(q, k, v, bias)
    bh, lq, d = q.shape
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} "
                             f"{tuple(q.shape)} tensor on {q.device}")
    if lse.shape != (bh, lq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(bh, lq)} tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fam, chunks, work = _plan(q, k, True, (q, k, v, dout, out, dq, dk, dv))
    delta = None
    if fam == "cuda_cores":
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lib = load_library()
    with span("mt.op.k2b"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            None if delta is None else delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, lq, k.shape[1], d,
            float(scale), _DTYPE_CODES[q.dtype], chunks,
            None if work is None else work.data_ptr(), stream)
    check_launch(err, "mt_flash_attention_bwd")
    BWD_LAUNCHES += 1
    BWD_FAMILY_LAUNCHES[fam] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K2f forward, K2b backward on CUDA tensors; the plain versions on
    CPU tensors. ``lse`` is an output without a gradient. Saves q, k, v,
    the bias, out and lse; a rematerialized region's recompute takes
    ``(out, lse)`` back (:func:`.kept.kept`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = kept(lambda: (flash_attention_cuda if q.device.type ==
                                 "cuda" else flash_attention_reference)(
            q, k, v, bias, scale))
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_backward_cuda(
                q, k, v, bias, out, lse, dout.contiguous(), ctx.scale)
        else:
            grads = flash_attention_backward_reference(
                q, k, v, bias, out, lse, dout, ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(out, lse)``, differentiable in q, k, v.

    q: ``(BH, Lq, D)``; k, v: ``(BH, Lk, D)``; bias: optional ``(BH, Lk)``
    additive key bias (``NEG_INF`` masks a key); scale defaults to
    ``D ** -0.5``. CUDA tensors run the kernels (or raise), CPU tensors the
    plain versions.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.to(torch.float32)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, float(scale))
