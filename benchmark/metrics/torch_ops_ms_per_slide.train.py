"""Device ms a traced train step spends in kernels that are not the
port's own (GEMMs, LayerNorm, GELU, dropout, casts, the optimizer: the
library's), by kernel name."""

# name parts of the port's hand-written kernels (csrc/*.cu)
PORT = ("alibi_", "dilated_", "flash_", "fused_", "gelu_ln_",
        "range_fill_kernel")
COPIES = ("Memcpy", "Memset")


def read(view):
    if view.kind != "train" or view.trace is None or not view.traced_steps:
        return None
    s = view.trace.seconds(lambda n: not any(p in n for p in PORT)
                           and not n.startswith(COPIES))
    return 1e3 * s / len(view.traced_steps)
