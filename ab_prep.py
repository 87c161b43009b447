#!/usr/bin/env python3
"""A/B of the attention kernels on an earlier tree's port and on this one:
the fp32 times of K1f (with stats), K3f, K1b and K3b, of K2f and K2b at
the adapter's shapes and the per-branch route's r = 2 branch, of K4f and
K4b at TITAN's shapes, the ``--bf16 0`` train step of GigaPath on the
default and the per-branch route and of TITAN, and the bits of the bf16
families and of the fp32 dilated and key-bias kernels.

    python3 ab_prep.py PARENT_DIR

PARENT_DIR holds an earlier tree (unpack it with ``git archive`` into
``_checkout/``, which git ignores). Runs in turns parent, this, this,
parent, each a process of its own that builds and imports its tree's
package, and prints:

* fp32: K1f's, K3f's, K1b's and K3b's median ms (CUDA events) at
  (3, 2048, 16, 48) and (3, 10240, 16, 48) on random fp32 inputs with
  1,919 and 9,000 valid tokens, with the 3xTF32 bounds of the forward and
  the backward (their products at fp32 accuracy as three TF32 products
  each at 495 TFLOP/s, or the bytes at 3.35 TB/s);
* k2 fp32: K2f's and K2b's median ms (CUDA events) and card ms (the
  profiler's) at the adapter's Injector (36 x 10,239 x 65) and Extractor
  (36 x 65 x 10,239, 1,239 keys masked, a dead bh) and at the per-branch
  route's r = 2 branch (96 x 2,896 x 2,896 at D = 48, 12 % of the keys
  masked) on random fp32 inputs, with the family that ran (K2b of the
  CUDA-core family includes the delta its wrapper makes in torch);
* k4 fp32: K4f's and K4b's median ms (CUDA events) and card ms (the
  profiler's) at ``chip_smoke.K4_SHAPES``, (3, 12, 4096, 64) and
  (3, 12, 16384, 64), on ``chip_smoke.k4_inputs`` at fp32, with the family
  that ran (an older tree's fp32 K4 ran on the CUDA cores, its K4b with the
  delta its wrapper makes in torch) and the 3xTF32 bounds;
* step: the ``--bf16 0`` user's train step (chip_smoke.py's GigaPath
  model with the frozen backbone in fp32, ``"flash"``) on the default
  route at the 10,239 and the 2,047 bucket and on the per-branch route
  (``chip_smoke.GIGAPATH_BRANCH``, the CLI's ``--fused_attention 0``) at
  10,239: the median ms of 9 steps after 2, and the peak allocated GiB;
  and TITAN's (``chip_smoke.TITAN``, 16,383 cells, 6 K4f and 6 K4b a
  step): the median of 5 steps after 2;
* bits: a SHA-256 digest of every output of K1f (with stats), K3f, K1b
  and K3b at bf16, of K1f (with stats) and K3f at fp32, and of K1b and
  K3b at fp32 fed the plain version's statistics (so that a change of
  the fp32 forward does not reach them), at (3, 2048, 16, 48), and of K2f
  and K2b at bf16 in the short-side family (36 x 2,047 x 65, 36 x 65 x
  2,047, 36 x 65 x 65) and the wgmma family (96 x 1,024 x 1,024, D = 48),
  of K2f and K2b at fp32 in the 3xTF32 family at D = 48 (the same shape),
  and of K4f and K4b at bf16 (the wgmma family, (3, 12, 2048, 64) with the
  holes mask); the run fails unless every run's digests are the same.

Needs one GPU.
"""

import subprocess
import sys
from pathlib import Path

CODE = r'''
import hashlib, importlib, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from modaltune_tpu_torch.configs import SlideEncoderConfig
from modaltune_tpu_torch.ops import _build
_build.build_library()
_build.load_library()
dm = importlib.import_module("modaltune_tpu_torch.ops.dilated_mega")
df = importlib.import_module("modaltune_tpu_torch.ops.dilated_fused")
ln = SlideEncoderConfig().longnet()
seg, rat, scale = ln.segment_lengths, ln.dilated_ratios, 48 ** -0.5
dev, out = torch.device("cuda:0"), []
for shape, n_valid in (((3, 2048, 16, 48), 1919), ((3, 10240, 16, 48), 9000)):
    (q, k, v, dmix), mask = cs.k1_inputs(shape, n_valid, dev, torch.float32,
                                         seed=9, n_tensors=4)

    def k1f():
        return dm.mega_dilated_attention_cuda(q, k, v, mask, seg, rat, scale,
                                              with_stats=True)

    def k3f():
        return df.fused_dilated_attention_cuda(q, k, v, mask, seg, rat, scale)
    out_, stats = k1f()
    k1b = cs.time_ms(lambda: dm.mega_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, stats, seg, rat, scale), 5, 1)
    _, _, lse_c, st = k3f()
    k3b = cs.time_ms(lambda: df.fused_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, lse_c, st, seg, rat, scale), 5, 1)
    pairs = shape[0] * cs.dilated_pairs(shape[1], n_valid, seg, rat, shape[2])
    fwd_bound = cs.bound_ms(3 * 4 * pairs * shape[3], cs.tensor_bytes(
        (q, k, v, mask, out_, stats)), 495e12)[0]
    bwd_bound = cs.bound_ms(3 * 10 * pairs * shape[3], cs.tensor_bytes(
        (q, k, v, mask, dmix, stats, q, k, v)), 495e12)[0]
    out.append(f"{shape[1]} tokens: K1f {cs.time_ms(k1f, 5, 1):.4f} ms, "
               f"K3f {cs.time_ms(k3f, 5, 1):.4f} ms, K1b {k1b:.4f} ms, K3b "
               f"{k3b:.4f} ms (3xTF32 bounds: forward {fwd_bound:.4f}, "
               f"backward {bwd_bound:.4f} ms)")
    del q, k, v, dmix, stats, lse_c, st, out_
    torch.cuda.empty_cache()
print("fp32: " + "; ".join(out), flush=True)

# K2 at fp32: the adapter's Injector and Extractor at 10,239, the r = 2
# branch of the per-branch route
fa = importlib.import_module("modaltune_tpu_torch.ops.flash_attention")
out = []
for name, bh, lq, lk, d, masked, dead in (
        ("Injector", 36, 10239, 65, 16, 0.0, False),
        ("Extractor", 36, 65, 10239, 16, 1239 / 10239, True),
        ("r = 2", 96, 2896, 2896, 48, 0.12, False)):
    q, k, v, bias = cs.k2_inputs(bh, lq, lk, d, masked, dead, torch.float32,
                                 dev, seed=7)
    o, lse = fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)
    do = torch.randn_like(o)

    def k2f():
        return fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)

    def k2b():
        return fa.flash_attention_backward_cuda(q, k, v, bias, o, lse, do,
                                                d ** -0.5)
    out.append(f"{name} ({fa.card_family(lq, lk, d, torch.float32)}) K2f "
               f"{cs.time_ms(k2f, 20):.4f} ms (card "
               f"{cs.fmt_ms(cs.device_ms(k2f))}), K2b {cs.time_ms(k2b, 20):.4f}"
               f" ms (card {cs.fmt_ms(cs.device_ms(k2b))})")
print("k2 fp32: " + "; ".join(out), flush=True)

# K4 at fp32: TITAN's shapes
af = importlib.import_module("modaltune_tpu_torch.ops.alibi_flash")
out = []
for name, b, h, n, d, _ in cs.K4_SHAPES:
    q, k, v, do, coords3, slopes, km = cs.k4_inputs(b, h, n, d, torch.float32,
                                                    dev, seed=400)
    o, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes, km,
                                           d ** -0.5)

    def k4f():
        return af.alibi_flash_attention_cuda(q, k, v, coords3, slopes, km,
                                             d ** -0.5)

    def k4b():
        return af.alibi_flash_attention_backward_cuda(
            q, k, v, coords3, slopes, km, o, lse, do, d ** -0.5)
    pairs = float(h * n * int(km.sum()))
    fwd_bound = cs.bound_ms(3 * 4 * pairs * d, cs.tensor_bytes(
        (q, k, v, coords3, slopes, km, o, lse)), 495e12)[0]
    bwd_bound = cs.bound_ms(3 * 10 * pairs * d, cs.tensor_bytes(
        (q, k, v, coords3, slopes, km, o, lse, do, q, k, v)), 495e12)[0]
    fam = getattr(af, "card_family", lambda x: "cuda_cores")(q)
    iters = 5 if fam == "tf32x3" or n < 16384 else 2
    out.append(f"{name} ({fam}) K4f {cs.time_ms(k4f, iters, 1):.4f} ms (card "
               f"{cs.fmt_ms(cs.device_ms(k4f, 1, 1))}), K4b "
               f"{cs.time_ms(k4b, iters, 1):.4f} ms (card "
               f"{cs.fmt_ms(cs.device_ms(k4b, 1, 1))}); 3xTF32 bounds "
               f"{fwd_bound:.4f}, {bwd_bound:.4f} ms")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
print("k4 fp32: " + "; ".join(out), flush=True)

# the --bf16 0 train step: the default route at two buckets, the
# per-branch route at 10,239
import statistics, time
from modaltune_tpu_torch import make_train_step
steps = []
for route, model_kw, n_steps in (
        ("default", cs.GIGAPATH, 9),
        ("default", dict(cs.GIGAPATH, **cs.GIGAPATH_2047), 9),
        ("per-branch", cs.GIGAPATH_BRANCH, 9), ("TITAN", cs.TITAN, 5)):
    model, tcfg, opt, text, batch = cs.build_train(
        dev, frozen="float32", **model_kw)
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        step(batch, text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n_steps):
        t = time.perf_counter()
        step(batch, text, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    steps.append(f"{route} {batch['bag'].shape[1]}: "
                 f"{statistics.median(times):.2f} "
                 f"ms/step, peak "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del model, opt, batch, step
    torch.cuda.empty_cache()
print("step (--bf16 0): " + "; ".join(steps), flush=True)

# the bits: bf16 K1f, K3f, K1b, K3b; fp32 K1f, K3f, and K1b, K3b on the
# plain statistics; K2 in the bf16 families and fp32 tf32x3; bf16 K4
from modaltune_tpu_torch.ops.dilated import dilated_attention_stats
digest = hashlib.sha256()


def note(*tensors):
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())


for dtype in (torch.bfloat16, torch.float32):
    (q, k, v, dmix), mask = cs.k1_inputs((3, 2048, 16, 48), 1919, dev, dtype,
                                         seed=5, n_tensors=4)
    out_, stats = dm.mega_dilated_attention_cuda(q, k, v, mask, seg, rat,
                                                 scale, with_stats=True)
    fused = df.fused_dilated_attention_cuda(q, k, v, mask, seg, rat, scale)
    note(out_, stats, *fused)
    if dtype == torch.bfloat16:
        lse_c, st = fused[2], fused[3]
    else:
        stats = dilated_attention_stats(q, k, v, segment_lengths=seg,
                                        dilated_ratios=rat, mask=mask)
        n = len(seg)
        lses = [df.fused_branch_reference(q, k, v, mask, w, r, scale)[1]
                for w, r in zip(seg, rat)]
        lse_c = torch.cat(lses, dim=2).contiguous()
        st = stats[:, n:].reshape(3, 16, 2, 2048).permute(2, 0, 1, 3)
        st = st.contiguous()
    note(*dm.mega_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, stats, seg, rat, scale))
    note(*df.fused_dilated_attention_backward_cuda(
        q, k, v, mask, dmix, lse_c, st, seg, rat, scale))
for bh, lq, lk, d in ((36, 2047, 65, 16), (36, 65, 2047, 16), (36, 65, 65, 16),
                      (96, 1024, 1024, 48)):   # bf16 K2: short side, wgmma
    q, k, v, bias = cs.k2_inputs(bh, lq, lk, d, 0.12, True, torch.bfloat16,
                                 dev, seed=11)
    o, lse = fa.flash_attention_cuda(q, k, v, bias, d ** -0.5)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(12))
    note(o, lse, *fa.flash_attention_backward_cuda(
        q, k, v, bias, o, lse, do.to(dev, torch.bfloat16), d ** -0.5))
q, k, v, bias = cs.k2_inputs(96, 1024, 1024, 48, 0.12, True, torch.float32,
                             dev, seed=13)             # fp32 K2: tf32x3
o, lse = fa.flash_attention_cuda(q, k, v, bias, 48 ** -0.5)
do = torch.randn(o.shape, generator=torch.Generator().manual_seed(14))
note(o, lse, *fa.flash_attention_backward_cuda(q, k, v, bias, o, lse,
                                               do.to(dev), 48 ** -0.5))
q, k, v, do, coords3, slopes, km = cs.k4_inputs(   # bf16 K4: wgmma
    3, 12, 2048, 64, torch.bfloat16, dev, seed=15, holes=True)
o, lse = af.alibi_flash_attention_cuda(q, k, v, coords3, slopes, km, 0.125)
note(o, lse, *af.alibi_flash_attention_backward_cuda(
    q, k, v, coords3, slopes, km, o, lse, do, 0.125))
torch.cuda.synchronize()
print("bits: " + digest.hexdigest(), flush=True)
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]), "this": Path(__file__).parent}
    bits = set()
    for name in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", CODE], cwd=trees[name],
                             capture_output=True, text=True)
        if run.returncode:
            print(f"{name}: failed\n{run.stderr[-3000:]}", file=sys.stderr)
            return 1
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith(("fp32:", "k2 fp32:", "k4 fp32:", "step (",
                                   "bits:"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        bits.add(lines[-1])
    print(f"bits: {'the same in every run' if len(bits) == 1 else 'DIFFER'}",
          flush=True)
    return 0 if len(bits) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
