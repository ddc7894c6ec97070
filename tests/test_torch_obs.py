"""The port's observability copies (``repro_torch.obs``) behave as the
reference's do, and the port's serving layer feeds them: traced dispatches
publish ``DispatchRecord``s from the span stream, whole-model dispatches
record per-layer spans, and the drift monitor buckets by the port's own
cost-model classes.  Also: the kernel library cannot be built without a
CUDA toolchain, and says so."""
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.core.mapping import ai_band, class_key, select_schedule
from repro_torch.kernels import cuda_build
from repro_torch.kernels import mg3m_conv as K
from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.plan import registry as registry_mod
from repro_torch.serve.conv import ConvRequest, server_from_scenes
from repro_torch.serve.sched import ConvScheduler, SchedConfig

PACKAGES = {"reference": jobs, "port": tobs}
TINY = cnn_chain_scenes("resnet", max_hw=8, max_ch=4, layers_per_net=1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    def reset():
        tobs.set_default_metrics(None)
        tobs.set_default_tracer(None)
        tobs.set_default_monitor(None)
        registry_mod.set_default_registry(None)
    reset()
    yield
    reset()


def _exercise_metrics(obs):
    m = obs.MetricRegistry()
    with pytest.raises(ValueError, match="scheme"):
        m.counter("nodots")
    c = m.counter("repro.test.c")
    h = m.histogram("repro.test.h_s", bounds=(1e-3, 1e-2, 1e-1))
    g = m.gauge("repro.test.depth")
    c.inc(5)
    h.observe(5e-4)
    before = m.snapshot()
    c.inc(2)
    for v in (2e-3, 3e-3, 5e-2, math.nan):
        h.observe(v)
    g.set(9)
    win = obs.snapshot_delta(before, m.snapshot())
    return {
        "c": obs.snapshot_value(win, "repro.test.c"),
        "h_count": win["repro.test.h_s"]["count"],
        "h_sum": round(win["repro.test.h_s"]["sum"], 12),
        "depth": win["repro.test.depth"]["value"],
        "p50": round(obs.summarize_histogram(h._snapshot())["p50"], 12),
        "names": m.names(),
    }


def test_metrics_copy_behaves_like_the_reference():
    got = {name: _exercise_metrics(obs) for name, obs in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"]["c"] == 2.0 and got["port"]["h_count"] == 3


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_tracer_nesting_and_chrome_export(name, tmp_path):
    tr = PACKAGES[name].Tracer(enabled=True)
    with tr.span("repro.test.outer", k=1):
        with tr.span("repro.test.inner"):
            assert tr.current() == "repro.test.inner"
    assert tr.current() is None
    events = tr.events()
    assert [e["name"] for e in events] == ["repro.test.inner",
                                           "repro.test.outer"]
    assert events[0]["args"]["parent"] == "repro.test.outer"
    doc = json.loads(Path(tr.export(str(tmp_path / "t.json"))).read_text())
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])


def test_drift_classes_are_the_port_cost_model_classes():
    sc = TINY["resnet/L0"]
    choice = select_schedule(sc)
    cls = tobs.scene_class(sc, choice)
    assert cls == class_key(choice.schedule, choice.bound,
                            ai_band(sc.arithmetic_intensity))
    mon = tobs.DriftMonitor(threshold=0.5, min_samples=2,
                            metrics=tobs.MetricRegistry())
    for _ in range(3):
        mon.observe(cls, 1.0, 10.0)
    assert mon.flagged() == [cls]
    assert mon.observe(cls, 1.0, math.inf) is None


def test_traced_server_publishes_records_from_the_span_stream():
    records = []
    tracer = tobs.Tracer(enabled=True)
    drift = tobs.DriftMonitor(metrics=tobs.MetricRegistry())
    server = server_from_scenes(TINY, max_batch=4, ladder_slack=0.0,
                                device="cpu", tracer=tracer, drift=drift,
                                on_dispatch=records.append)
    server.prewarm()
    sc = TINY["resnet/L0"]
    xs = [torch.randn(sc.in_shape()[:3] + (1,)) for _ in range(3)]
    server.serve([ConvRequest(rid=i, layer="resnet/L0", x=x)
                  for i, x in enumerate(xs)])
    assert len(records) == 1 and records[0].occupied == 3
    assert records[0].schedule in ("TB11", "TB18", "TB88")
    spans = [e for e in tracer.events() if e["name"] == "repro.serve.dispatch"]
    assert len(spans) == 1 and spans[0]["args"]["requests"] == 3
    assert sum(s.n for s in drift.stats().values()) == 1


def test_traced_model_dispatch_records_layer_spans():
    chain = cnn_chain_scenes("resnet", max_hw=8, max_ch=4, layers_per_net=3)
    tracer = tobs.Tracer(enabled=True)
    sched = ConvScheduler(max_batch=4, ladder_slack=0.0, strict=True,
                          device="cpu", tracer=tracer,
                          drift=tobs.DriftMonitor(
                              metrics=tobs.MetricRegistry()),
                          config=SchedConfig(occupancy_target=2))
    sched.register_net("resnet", chain, seed=5, activation=torch.relu)
    sc0 = next(iter(chain.values()))
    x = torch.randn(sc0.in_shape()[:3] + (2,))
    out = sched.session("resnet").serve([x])[0]
    layers = [e["args"]["layer"] for e in tracer.events()
              if e["name"] == "repro.serve.layer_dispatch"]
    assert layers == list(chain)
    assert out.shape[-1] == 2 and bool((out >= 0).all())
    assert sched.stats()["dispatches"] == 1


def test_kernel_library_needs_the_cuda_toolchain(tmp_path, monkeypatch):
    """Without nvcc the first launch fails loudly, and nothing is left in
    the build directory."""
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolchain is present here")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    K.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        K.library()
    assert not (tmp_path / "build").exists()
