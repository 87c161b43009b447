"""The trace's reduction and the per-layer readers' kernel grouping, on
kernel names the profiler recorded on the card."""

import pytest

from benchmark.entries.train import Step
from benchmark.harness import roofline
from benchmark.harness.cell import View
from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Trace, union_us
from benchmark.tests import tiny

# names as the profiler gives them on the card (PERF.md's splits)
RECORDED = {
    "void dilated_fwd_wg_kernel<2>(DilatedArgs)": "K1f",
    "fused_mix_kernel": "K1f",
    "void dilated_bwd_dq_wg_kernel(BwdArgs)": "K1b",
    "dilated_bwd_compact_prep_kernel": "K1b",
    "fused_combine_kernel": "K1b",
    "flash_fwd_short_keys_kernel": "K2",
    "flash_bwd_short_queries_kernel": "K2",
    "alibi_fwd_wg_kernel": "K4f",
    "alibi_bwd_dkv_wg_kernel": "K4b",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "torch",
    "void at::native::vectorized_layer_norm_kernel<float, float>": "torch",
    "void at::native::elementwise_kernel<128, 2>": "torch",
    "Memcpy HtoD (Pinned -> Device)": "copy",
}


def _trace():
    events, t = [], 0.0
    for name in RECORDED:
        events.append((name, t, t + 1000.0))     # 1 ms each, 1 ms apart
        t += 2000.0
    host = [("aten::item", 500.0, 10000.0), ("aten::copy_", 1200.0, 1800.0)]
    return Trace(window_s=t / 1e6, device=events, host=host)


def _view(kind, config, steps, pass_s=(1.0,), traced_pass=None):
    import benchmark.flops.gigapath_modaltune as flops
    return View(kind, {"steps": steps, "seconds": sum(pass_s),
                       "pass_s": list(pass_s), "traced_pass": traced_pass,
                       "loader_ms": [1.0], "trace": _trace()}, config, flops)


def test_union_and_idle_gaps():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    t = _trace()
    assert t.busy_s() == pytest.approx(len(RECORDED) * 1e-3)
    gaps = t.idle_gaps()
    assert sum(gaps.values()) == pytest.approx((len(RECORDED) - 1) * 1e-3)
    # the gap at 1.5 ms lies inside aten::copy_, nested in aten::item
    assert gaps["aten::copy_"] == pytest.approx(1e-3)
    assert gaps["aten::item"] == pytest.approx(4e-3)


def _reader(name):
    return Manifest.load(tiny.REPO).reader(name)


def test_torch_ops_reader_leaves_the_ports_kernels_and_copies_out():
    cfg = tiny.gigapath_config()
    steps = [Step("a", 63, 40, traced=True), Step("b", 63, 50, traced=True)]
    ms = _reader("torch_ops_ms_per_slide.train")(_view("train", cfg, steps))
    torch_n = sum(1 for g in RECORDED.values() if g == "torch")
    assert ms == torch_n * 1.0 / 2


def test_k1_roofline_reader_counts_k1_kernels_only():
    cfg = tiny.gigapath_config()
    steps = [Step("a", 63, 40, traced=True)]
    share = _reader("dilated_attn_roofline.train")(_view("train", cfg, steps))
    k1_s = sum(1 for g in RECORDED.values() if g in ("K1f", "K1b")) * 1e-3
    read = _reader("dilated_attn_roofline.train").__globals__["bound_s"]
    view = _view("train", cfg, steps)
    need = cfg["longnet"]["num_layers"] * (read(view, 63, 40, False)
                                           + read(view, 63, 40, True))
    assert share == 100.0 * need / k1_s
    assert _reader("dilated_attn_roofline.train")(
        _view("embed", cfg, steps)) is None


def test_idle_share_and_mfu_readers_leave_the_traced_epoch_out():
    cfg = tiny.gigapath_config()
    steps = [Step("a", 63, 40), Step("b", 63, 50, traced=True),
             Step("c", 127, 90)]
    # epochs of 1 s, the traced one (stretched by the profiler), 3 s
    view = _view("train", cfg, steps, pass_s=(1.0, 9.0, 3.0), traced_pass=1)
    idle = _reader("device_idle_share.train")(view)
    assert idle == pytest.approx(100.0 * (1 - len(RECORDED) * 1e-3 / 2.0))
    mfu = _reader("train_mfu")(view)
    import benchmark.flops.gigapath_modaltune as flops
    want = flops.train(cfg, 63, 40) + flops.train(cfg, 127, 90)
    assert mfu == pytest.approx(100.0 * want / (4.0 * roofline.PEAK_FLOPS))
    assert _reader("loader_wait_ms.train")(view) == 1.0


def test_idle_share_reads_nothing_without_an_untraced_epoch():
    cfg = tiny.gigapath_config()
    view = _view("train", cfg, [Step("a", 63, 40, traced=True)],
                 pass_s=(2.0,), traced_pass=0)
    assert _reader("device_idle_share.train")(view) is None
    assert _reader("train_mfu")(view) is None
