"""The port's spans (``utils/tracing.py``) on the CPU.

* ``span`` is the one shared null context while no profiler records, and
  an unprofiled epoch creates no ``record_function``;
* under ``torch.profiler.profile`` one epoch of a tiny ``ModalTuneTrainer``
  opens every ``mt.train.*`` and ``mt.step.*`` span once a step (the
  loader's ``mt.train.next`` once more, for the wait that ends the epoch),
  the ``mt.step.*`` spans inside ``mt.train.step``, and the backbone's
  spans once a layer, once more where a remat policy's recompute runs the
  function that opens them; the adapter's once an injector or extractor,
  the gene mixer's once;
* every ``lib.mt_*`` launch in ``ops/*.py`` sits inside its ``mt.op.*``
  span, in a launcher that counts it in a ``*LAUNCHES`` counter;
* ``tools/trace_report --spans`` on a hand-made Chrome trace of the card's
  form puts a kernel under the span around its launch, a backward kernel
  under its forward op's span and an unlinked one under
  ``(outside any span)``, and runs on a CPU trace of the trainer.
"""

import ast
import collections
import dataclasses
import io
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modaltune_tpu_torch import create_aggregator, init_weights
from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
from modaltune_tpu_torch.data import SyntheticSlideDataset
from modaltune_tpu_torch.models.adapter import Extractor, Injector
from modaltune_tpu_torch.tools import trace_report
from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
from modaltune_tpu_torch.utils import profiling, tracing
from _one_thread import one_thread  # noqa: F401

OPS = Path(__file__).resolve().parent.parent / "modaltune_tpu_torch" / "ops"
STEPS = 2
TRAIN_SPANS = ("mt.train.h2d", "mt.train.text", "mt.train.step",
               "mt.train.loss_read")
STEP_SPANS = ("mt.step.forward", "mt.step.loss", "mt.step.backward",
              "mt.step.optimizer")
# remat policy -> how often a layer's spans open a step
OPENS = {"off": 1, "flash": 2, "flash_ffn": 1, "full": 2}
# every kernel launcher of ops/ and the span around its launch
LAUNCHERS = {
    ("dilated_mega.py", "mega_dilated_attention_cuda"): "mt.op.k1f",
    ("dilated_mega.py", "mega_dilated_attention_backward_cuda"): "mt.op.k1b",
    ("dilated_mega.py", "mega_dilated_attention_backward_part_cuda"):
        "mt.op.k1b",
    ("dilated_fused.py", "fused_dilated_attention_cuda"): "mt.op.k3f",
    ("dilated_fused.py", "fused_forward_part_cuda"): "mt.op.k3f",
    ("dilated_fused.py", "fused_dilated_attention_backward_cuda"):
        "mt.op.k3b",
    ("flash_attention.py", "flash_attention_cuda"): "mt.op.k2f",
    ("flash_attention.py", "flash_attention_backward_cuda"): "mt.op.k2b",
    ("alibi_flash.py", "alibi_flash_attention_cuda"): "mt.op.k4f",
    ("alibi_flash.py", "alibi_flash_attention_backward_cuda"): "mt.op.k4b",
    ("gelu_ln.py", "gelu_ln_cuda"): "mt.op.k5f",
    ("gelu_ln.py", "gelu_ln_backward_cuda"): "mt.op.k5b",
}
# library calls that launch nothing (the row frame's constants)
QUERIES = {"mt_gelu_ln_row_frame"}


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = tracing.span("mt.a"), tracing.span("mt.b")
    assert a is b is tracing._NULL
    with a, b:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("mt.a") as got:
            assert got is not tracing._NULL
    names = [e.name for e in prof.events()]
    assert names.count("mt.a") == 1


def _trainer(tmp_path, policy="flash"):
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, remat=policy != "off",
        remat_policy="flash" if policy == "off" else policy))
    packer = SyntheticSlideDataset(n_cases=1).packer
    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=cfg, n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    init_weights(model, torch.Generator().manual_seed(0))
    data = SyntheticSlideDataset(n_cases=STEPS, in_chans=64,
                                 bag_range=(40, 80))
    trainer = ModalTuneTrainer(model, TrainConfig(), {"train": data},
                               str(tmp_path), buckets=(96,), model_cfg=cfg,
                               device="cpu")
    trainer.init_state(model.state_dict())
    return trainer, cfg


def test_an_unprofiled_epoch_creates_no_range(tmp_path, monkeypatch):
    trainer, _ = _trainer(tmp_path)

    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer.train_one_epoch()
    assert len(trainer.step_ms) == STEPS


@pytest.mark.parametrize("policy", sorted(OPENS))
def test_a_profiled_epoch_opens_every_span(tmp_path, policy):
    trainer, cfg = _trainer(tmp_path, policy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_one_epoch()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("mt.")]
    n = collections.Counter(name for name, _, _ in spans)
    model = trainer.model
    assert n["mt.train.next"] == STEPS + 1
    for name in TRAIN_SPANS + STEP_SPANS:
        assert n[name] == STEPS, name
    steps = [(a, b) for name, a, b in spans if name == "mt.train.step"]
    for name, a, b in spans:
        if name.startswith("mt.step."):
            assert any(s <= a and b <= e for s, e in steps), name
    layers = cfg.backbone.depth
    assert n["mt.backbone.attention"] == STEPS * layers * OPENS[policy]
    assert n["mt.backbone.ffn"] == STEPS * layers * OPENS[policy]
    count = lambda cls: sum(isinstance(m, cls) for m in model.modules())
    assert n["mt.adapter.injector"] == STEPS * count(Injector) > 0
    assert n["mt.adapter.extractor"] == STEPS * count(Extractor) > 0
    assert n["mt.gene.mixer"] == STEPS
    assert not {k for k in n if k.startswith("mt.op.")}   # plain versions


def _with_span(node) -> str:
    """The ``mt.op.*`` name a ``with`` statement opens, or ''."""
    for item in node.items:
        c = item.context_expr
        if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "span" \
                and isinstance(c.args[0], ast.Constant):
            return c.args[0].value
    return ""


def _launches(tree):
    """(function, span, library call, names) for each ``lib.mt_*`` call:
    the innermost ``mt.op.*`` span around it ('' where none) and the names
    its function reads."""
    out = []

    def walk(node, fn, opened, names):
        if isinstance(node, ast.FunctionDef):
            fn, names = node, {n.id for n in ast.walk(node)
                               if isinstance(n, ast.Name)}
        if isinstance(node, ast.With):
            opened = _with_span(node) or opened
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                getattr(node.func.value, "id", "") == "lib" and \
                node.func.attr.startswith("mt_"):
            out.append((fn.name if fn else "", opened, node.func.attr,
                        names))
        for child in ast.iter_child_nodes(node):
            walk(child, fn, opened, names)

    walk(tree, None, "", set())
    return out


def test_every_kernel_launch_opens_its_op_span():
    found = {}
    for path in sorted(OPS.glob("*.py")):
        for fn, opened, call, names in _launches(ast.parse(path.read_text())):
            if call in QUERIES:
                continue
            assert opened.startswith("mt.op."), (path.name, fn, call)
            assert fn.endswith("_cuda"), (path.name, fn, call)
            assert any(n.endswith("LAUNCHES") for n in names), (path.name, fn)
            found[(path.name, fn)] = opened
    assert found == LAUNCHERS


def _x(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, pid=1, tid=tid, ts=ts, dur=dur,
                args=args)


def _flow(ph, ts, tid, flow_id=1):
    return dict(ph=ph, cat="fwdbwd", name="fwdbwd", id=flow_id, pid=1,
                tid=tid, ts=ts, **({"bp": "e"} if ph == "f" else {}))


def _card_trace():
    """A forward on thread 1 (K1f in ``mt.op.k1f`` in
    ``mt.backbone.attention``; a GEMM in ``mt.backbone.ffn``), its GEMM's
    backward on the autograd thread 2 (linked by the ``fwdbwd`` flow), a
    launch in no span, and two device events with no launch."""
    return [
        _x("mt.backbone.attention", "user_annotation", 0, 100),
        _x("mt.op.k1f", "user_annotation", 10, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 5, correlation=7),
        _x("mt.backbone.ffn", "user_annotation", 100, 100),
        _x("aten::mm", "cpu_op", 110, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 115, 3, correlation=8),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op",
           300, 50, tid=2),
        _x("MmBackward0", "cpu_op", 301, 45, tid=2),
        _x("aten::mm", "cpu_op", 305, 30, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 306, 4, tid=2,
           correlation=9),
        _x("cudaLaunchKernel", "cuda_runtime", 400, 2, tid=2,
           correlation=10),
        _flow("s", 110, 1), _flow("f", 301, 2),
        _x("void mt::dwg::dilated_fwd_wg_kernel<2>", "kernel", 20, 50,
           tid=7, correlation=7),
        _x("nvjet_gemm", "kernel", 120, 40, tid=7, correlation=8),
        _x("nvjet_gemm", "kernel", 320, 60, tid=7, correlation=9),
        _x("elementwise_kernel", "kernel", 410, 5, tid=7, correlation=10),
        _x("elementwise_kernel", "kernel", 420, 6, tid=7, correlation=99),
        _x("Memcpy HtoD", "gpu_memcpy", 430, 4, tid=8),
        _x("mt.op.k1f", "gpu_user_annotation", 20, 50, tid=7),
    ]


def test_span_report_attributes_kernels_by_launch_and_backward_link():
    rep = trace_report.span_summary(_card_trace(), steps=1)
    dev, host = rep["device_ms_per_step"], rep["host_ms_per_step"]
    assert dev == pytest.approx({"mt.op.k1f": 0.05, "mt.backbone.ffn": 0.1,
                                 trace_report.OUTSIDE: 0.015,
                                 "mt.backbone.attention": 0.0})
    # self times: k1f 15 + its launch 5; ffn 70 + mm 27 + launch 3, and
    # the backward's MmBackward0 15, mm 26, launch 4; outside: the engine's
    # evaluate_function 5 and the lone launch 2
    assert host == pytest.approx({"mt.op.k1f": 0.02, "mt.backbone.ffn": 0.145,
                                  "mt.backbone.attention": 0.08,
                                  trace_report.OUTSIDE: 0.007})
    assert rep["count_per_step"] == {"mt.op.k1f": 1, "mt.backbone.ffn": 1,
                                     "mt.backbone.attention": 1,
                                     trace_report.OUTSIDE: 0}
    assert list(dev)[:2] == ["mt.backbone.ffn", "mt.op.k1f"]


def test_span_report_cli_on_a_trainer_trace(tmp_path):
    trainer, _ = _trainer(tmp_path)
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        trainer.train_one_epoch()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = trace_report.main([str(log_dir), "--steps", str(STEPS),
                                "--spans", "--top", "40"])
    assert rc == 0
    rows = {ln.split()[0]: ln.split()[1:] for ln in
            out.getvalue().split("\n\n", 1)[1].splitlines()[1:]}
    for name in TRAIN_SPANS + STEP_SPANS + ("mt.backbone.attention",
                                            "mt.gene.mixer"):
        assert float(rows[name][1]) > 0, name
    assert float(rows["mt.train.step"][2]) == 1
    assert "(outside" in rows
    rep = trace_report.span_summary(trace_report.load_events(str(log_dir)),
                                    STEPS)
    assert all(v == 0 for v in rep["device_ms_per_step"].values())
