"""K1's share of its roofline in the traced train epoch, %: the least time
of every K1f and K1b call of its steps (``roofline.attention_bound_s``
over the call's (query, unmasked key) pairs, valid queries only, and its
inputs and outputs in bf16, the statistics plane in fp32) over the
device time of K1's kernels, by name."""

# K1's kernels: csrc/dilated_attention_{fwd,bwd}.cu, the shared cores
# dilated_{fwd,bwd}_{wg,tf32}, and K3's mix and combine, which K1 runs
K1 = ("dilated_fwd", "dilated_bwd", "fused_mix", "fused_combine")
BF16, FP32 = 2, 4


def bound_s(view, bucket, length, backward):
    c = view.config["longnet"]
    rows = view.config["train"]["num_tasks"]
    n, heads = bucket + 1, c["num_heads"]
    d = c["embed_dim"] // heads
    pairs = rows * view.roofline.dilated_pairs(
        n, length + 1, tuple(c["segment_lengths"]),
        tuple(c["dilated_ratios"]), heads, (0, length + 1))
    qkv = rows * n * heads * d * BF16
    stats = rows * heads * (len(c["dilated_ratios"]) + 2) * n * FP32
    mask = rows * n
    nbytes = (8 * qkv + stats + mask) if backward else \
        (4 * qkv + stats + mask)
    return view.roofline.attention_bound_s(pairs, d, nbytes, backward)


def read(view):
    if view.kind != "train" or view.trace is None or \
            "longnet" not in view.config:
        return None
    spent = view.trace.seconds(lambda name: any(k in name for k in K1))
    if spent <= 0:
        return None
    layers = view.config["longnet"]["num_layers"]
    need = sum(layers * (bound_s(view, s.bucket, s.length, False)
                         + bound_s(view, s.bucket, s.length, True))
               for s in view.traced_steps)
    return 100.0 * need / spent
