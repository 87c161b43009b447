#!/usr/bin/env python3
"""A/B of the fp32 dilated attention kernels on an earlier tree's port and
on this one: K1b and K3b (the 3xTF32 family at D = 48 since it came; the
CUDA-core family, whose prep rebuilds delta row by row, before), and the
forwards K1f (with stats) and K3f on the CUDA cores.

    python3 ab_prep.py PARENT_DIR

PARENT_DIR holds an earlier tree (unpack it with ``git archive`` into
``_checkout/``, which git ignores). Runs in turns parent, this, this,
parent, each a process of its own that builds and imports its tree's
package, and prints K1f's, K3f's, K1b's and K3b's median ms (CUDA events)
at (3, 2048, 16, 48) and (3, 10240, 16, 48) on random fp32 inputs with
1,919 and 9,000 valid tokens, with the 3xTF32 bounds of the forward and
the backward (their products at fp32 accuracy as three TF32 products each
at 495 TFLOP/s, or the bytes at 3.35 TB/s). Needs one GPU.
"""

import subprocess
import sys
from pathlib import Path

CODE = r'''
import importlib, sys
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
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]), "this": Path(__file__).parent}
    for name in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", CODE], cwd=trees[name],
                             capture_output=True, text=True)
        if run.returncode:
            print(f"{name}: failed\n{run.stderr[-3000:]}", file=sys.stderr)
            return 1
        print(f"{name}: {run.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
