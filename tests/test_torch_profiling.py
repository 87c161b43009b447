"""The port's profiling helpers on the CPU: ``utils.profiling.trace`` and
``StepTimer`` around two steps of the tiny ModalTune grad step, then
``tools/trace_report`` over the trace it wrote (the CPU lane: the
outermost CPU ops, classes present, totals positive, ``--breakdown`` by
the recorded input shapes, the CLI), its device-lane rules on a
hand-made Chrome trace of the form the card's profiler writes (kernel
events, their launching op's shapes by ``External id``), and
``StepTimer.summary`` against the JAX package's on the same times.
``chip_smoke.phase_profile`` runs the same on the card, where the report
takes the kernel events and is held to ``device_times``."""

import gzip
import io
import json
import os
import time
from contextlib import redirect_stdout

import pytest
import torch

import _torch_mp as tmp_ranks
from modaltune_tpu.utils.profiling import StepTimer as JStepTimer
from modaltune_tpu_torch.tools import trace_report
from modaltune_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two grad steps of the tiny model under ``trace``, each timed by a
    ``StepTimer`` that stops on the step's loss."""
    from modaltune_tpu_torch import freeze_backbone, make_grad_step
    from modaltune_tpu_torch.configs import TrainConfig
    packer, batch, text = tmp_ranks.tiny_data(1, bag_range=(150, 200))
    model = tmp_ranks.port_model(tmp_ranks.tiny_config(), packer)
    freeze_backbone(model)
    step = make_grad_step(model, TrainConfig())
    batch = {k: tmp_ranks._t(v) for k, v in batch.items()}
    targets = tmp_ranks.text_targets(text)
    log_dir = tmp_path_factory.mktemp("trace")
    timer = StepTimer()
    with trace(str(log_dir)):
        for i in range(2):
            timer.start()
            loss, _ = step(batch, targets, torch.Generator().manual_seed(i))
            timer.stop(loss)
    return log_dir, timer


def test_trace_writes_a_chrome_trace(traced):
    log_dir, _ = traced
    (path,) = list(log_dir.iterdir())
    assert path.name.endswith(".pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert trace_report.newest_trace(str(log_dir)) == path


def test_step_timer(traced):
    _, timer = traced
    s = timer.summary()
    assert s["steps"] == 2 and s["total_s"] > 0
    assert s["p50_s"] == max(timer.times)
    j = JStepTimer()
    j.times = list(timer.times)
    assert j.summary() == s
    assert StepTimer().summary() == {}


def test_report_of_a_cpu_trace(traced):
    log_dir, _ = traced
    rep = trace_report.summarize(trace_report.load_events(str(log_dir)),
                                 steps=2, shapes="aten::linear")
    assert rep["lane"] == "cpu"
    ms = rep["ms_per_step"]
    assert {"aten::linear", "aten::layer_norm"} <= set(ms)
    assert all(v > 0 for v in ms.values())
    assert rep["total_ms_per_step"] == pytest.approx(sum(ms.values()))
    # outermost ops only: aten::addmm runs inside aten::linear
    assert "aten::addmm" not in ms
    assert rep["by_shape"] and all(s.startswith("[[") for s in
                                   rep["by_shape"])
    assert sum(rep["by_shape"].values()) == pytest.approx(
        ms["aten::linear"])


def test_report_cli(traced):
    log_dir, _ = traced
    out = io.StringIO()
    with redirect_stdout(out):
        rc = trace_report.main([str(log_dir), "--steps", "2", "--top", "5",
                                "--breakdown", "aten::linear"])
    text = out.getvalue()
    assert rc == 0
    assert text.startswith("cpu events") and "TOTAL" in text
    assert "-- 'aten::linear' by shape --" in text
    assert len([ln for ln in text.splitlines() if "ms  [[" in ln]) >= 1


def _event(name, cat, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, pid=1, tid=7, ts=ts, dur=dur,
                args=args)


def test_report_of_device_events(tmp_path):
    """Kernel, copy and set events are taken and the CPU ops left out;
    a kernel's shape is its launching op's."""
    events = [
        _event("aten::mm", "cpu_op", 0, 50, **{"External id": 3,
                                              "Input Dims": [[4, 8], [8, 2]]}),
        _event("void mt::dwg::dilated_fwd_wg_kernel<64, 2>(mt::dwg::P)",
               "kernel", 10, 300, **{"External id": 3}),
        _event("void mt::dwg::dilated_fwd_wg_kernel<64, 2>(mt::dwg::P)",
               "kernel", 400, 100, **{"External id": 9}),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 40),
        _event("Memset (Device)", "gpu_memset", 30, 20),
        _event("cudaLaunchKernel", "cuda_runtime", 5, 4),
    ]
    path = tmp_path / "x.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    older = tmp_path / "y.pt.trace.json"
    older.write_text(json.dumps({"traceEvents": []}))
    os.utime(older, (time.time() - 60, time.time() - 60))
    rep = trace_report.summarize(trace_report.load_events(str(tmp_path)),
                                 steps=1,
                                 shapes="mt::dwg::dilated_fwd_wg_kernel")
    assert rep["lane"] == "device"
    assert rep["ms_per_step"] == {"mt::dwg::dilated_fwd_wg_kernel": 0.4,
                                  "Memcpy HtoD": 0.04, "Memset": 0.02}
    assert rep["count_per_step"]["mt::dwg::dilated_fwd_wg_kernel"] == 2
    assert rep["by_shape"] == {"[[4, 8], [8, 2]]": 0.3, "?": 0.1}


@pytest.mark.parametrize("name,cls", [
    ("aten::addmm", "aten::addmm"),
    ("void mt::fwg::flash_fwd_wg_kernel<48>(mt::fwg::Params)",
     "mt::fwg::flash_fwd_wg_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_execute",
     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_execute"),
    ("fused_op_12", "fused_op"),
])
def test_op_class(name, cls):
    assert trace_report.op_class(name) == cls


def test_report_refuses_an_empty_trace(tmp_path):
    (tmp_path / "z.pt.trace.json").write_text('{"traceEvents": []}')
    assert trace_report.main([str(tmp_path)]) == 1
    with pytest.raises(FileNotFoundError):
        trace_report.load_events(str(tmp_path / "none"))
