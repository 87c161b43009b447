"""Model FLOPs of the window's untraced train steps over the untraced
epochs' seconds, as a share of one H100's bf16 peak (989 TFLOP/s at
700 W), %. The FLOPs are the configuration's counter's
(``benchmark/flops/``): products and attention pairs over the valid
tokens, forward and backward, no recompute."""


def read(view):
    steps = view.untraced_steps
    if view.kind != "train" or not steps or not view.untraced_pass_s:
        return None
    f = sum(view.flops.train(view.config, s.bucket, s.length) for s in steps)
    return 100.0 * f / (sum(view.untraced_pass_s) * view.roofline.PEAK_FLOPS)
