#!/usr/bin/env python3
"""A/B of the dilated attention kernels on an earlier tree's port and on
this one: the fp32 times of K1f (with stats), K3f, K1b and K3b, and the
bits of the bf16 family and of the fp32 backward.

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
* step: the ``--bf16 0`` user's train step (chip_smoke.py's GigaPath
  model with the frozen backbone in fp32, the default route, ``"flash"``)
  at the 10,239 and the 2,047 bucket: the median ms of 5 steps after 2,
  and the peak allocated GiB;
* bits: a SHA-256 digest of every output of K1f (with stats), K3f, K1b
  and K3b at bf16, and of K1b and K3b at fp32 fed the plain version's
  statistics (so that a change of the fp32 forward does not reach them),
  at (3, 2048, 16, 48); the run fails unless every run's digests are the
  same.

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

# the --bf16 0 train step at two buckets
import statistics, time
from modaltune_tpu_torch import make_train_step
steps = []
for bucket_kw in ({}, cs.GIGAPATH_2047):
    model, tcfg, opt, text, batch = cs.build_train(
        dev, frozen="float32", **dict(cs.GIGAPATH, **bucket_kw))
    step = make_train_step(model, tcfg, opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        step(batch, text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step(batch, text, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    steps.append(f"{batch['bag'].shape[1]}: {statistics.median(times):.2f} "
                 f"ms/step, peak "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del model, opt, batch, step
    torch.cuda.empty_cache()
print("step (--bf16 0): " + "; ".join(steps), flush=True)

# the bits: bf16 K1f, K3f, K1b, K3b; fp32 K1b, K3b on the plain statistics
from modaltune_tpu_torch.ops.dilated import dilated_attention_stats
digest = hashlib.sha256()


def note(*tensors):
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())


for dtype in (torch.bfloat16, torch.float32):
    (q, k, v, dmix), mask = cs.k1_inputs((3, 2048, 16, 48), 1919, dev, dtype,
                                         seed=5, n_tensors=4)
    if dtype == torch.bfloat16:
        out_, stats = dm.mega_dilated_attention_cuda(q, k, v, mask, seg, rat,
                                                     scale, with_stats=True)
        fused = df.fused_dilated_attention_cuda(q, k, v, mask, seg, rat, scale)
        note(out_, stats, *fused)
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
                 if ln.startswith(("fp32:", "step (", "bits:"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        bits.add(lines[-1])
    print(f"bits: {'the same in every run' if len(bits) == 1 else 'DIFFER'}",
          flush=True)
    return 0 if len(bits) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
