"""``repro_torch.launch.obsreport`` (port of ``scripts/obsreport.py``): on
a metrics dump and a trace export from a port ``ConvScheduler`` burst on
the CPU, and on a dump written by the reference's ``MetricRegistry``, the
port's report equals the reference script's, dict for dict and printed
line for line; ``--json`` prints the report and an unrecognized artifact
exits 2."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.launch import obsreport
from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.plan import registry as registry_mod
from repro_torch.serve.sched import ConvScheduler, Overloaded, SchedConfig

ROOT = Path(__file__).resolve().parent.parent


def _reference_script():
    """``scripts/obsreport.py``, loaded by path (as tests/test_obs.py
    does)."""
    path = ROOT / "scripts" / "obsreport.py"
    spec = importlib.util.spec_from_file_location("obsreport_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REFERENCE = _reference_script()


def _port_artifacts(tmp: Path):
    """A traced, deadline-carrying scheduler burst with an overload on the
    CPU: its metrics dump (with the drift snapshot) and its trace."""
    registry_mod.set_default_registry(None)
    chain = cnn_chain_scenes("resnet", max_hw=8, max_ch=4, layers_per_net=3)
    tracer = tobs.Tracer(enabled=True)
    drift = tobs.DriftMonitor(min_samples=1, metrics=tobs.MetricRegistry())
    sched = ConvScheduler(max_batch=4, ladder_slack=0.0, strict=True,
                          device="cpu", tracer=tracer, drift=drift,
                          config=SchedConfig(max_queue=4,
                                             occupancy_target=4,
                                             flush_margin_s=0.01))
    sched.register_net("resnet", chain, seed=3)
    sched.prewarm()
    session = sched.session("resnet")
    sc0 = next(iter(chain.values()))
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(sc0.in_shape()[:3], generator=gen) for _ in range(7)]
    reqs = [session.submit(x, deadline_s=0.5) for x in xs[:3]]
    sched.drain()
    sched.wait(reqs)
    shed = 0
    for x in xs[3:]:          # a stopped queue of 4 takes 4: none shed
        session.submit(x)
    try:
        session.submit(xs[0])
    except Overloaded:
        shed += 1
    sched.drain()
    assert shed == 1
    metrics = sched.metrics.dump(str(tmp / "metrics.json"),
                                 extra={"drift": drift.snapshot()})
    trace = tracer.export(str(tmp / "trace.json"))
    return Path(metrics), Path(trace), sched.stats()


def _reference_dump(tmp: Path) -> Path:
    """A dump from the reference's ``MetricRegistry`` and drift monitor."""
    m = jobs.MetricRegistry()
    m.counter("repro.serve.requests").inc(10)
    m.counter("repro.serve.dispatches").inc(4)
    m.counter("repro.serve.occupied_lanes").inc(10)
    m.counter("repro.serve.bucket_lanes").inc(16)
    m.counter("repro.serve.shed_total").inc(2)
    m.counter("repro.serve.deadline_requests").inc(8)
    m.counter("repro.serve.deadline_misses").inc(1)
    m.gauge("repro.serve.queue_depth").set(3)
    for v in (1e-4, 2e-3, 3e-3, 5e-2):
        m.histogram("repro.serve.dispatch_s").observe(v)
        m.histogram("repro.serve.queue_wait_s").observe(v / 2)
    mon = jobs.DriftMonitor(threshold=0.5, min_samples=1,
                            metrics=jobs.MetricRegistry())
    mon.observe("TB88|compute|hi", 1.0, 10.0)
    mon.observe("TB11|memory|lo", 1.0, 1.1)
    return Path(m.dump(str(tmp / "reference_metrics.json"),
                       extra={"drift": mon.snapshot()}))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    metrics, trace, stats = _port_artifacts(tmp)
    try:
        yield {"metrics": metrics, "trace": trace,
               "reference": _reference_dump(tmp), "stats": stats}
    finally:
        registry_mod.set_default_registry(None)


def _doc(path: Path) -> dict:
    return json.loads(path.read_text())


def test_port_burst_report_has_every_section(artifacts):
    m = obsreport.build_report(_doc(artifacts["metrics"]))
    assert m["kind"] == "metrics"
    assert {"serving", "slo", "drift"} <= set(m)
    stats = artifacts["stats"]
    assert m["slo"]["deadline_requests"] == stats["deadline_requests"] == 3
    assert m["slo"]["shed_total"] == stats["shed"] == 1
    assert m["serving"]["requests"] == stats["requests"]
    assert m["drift"]["classes"], "the dispatches fed the drift monitor"
    assert m["slo"]["queue_wait"]["count"] == stats["requests"]
    t = obsreport.build_report(_doc(artifacts["trace"]))
    assert t["kind"] == "trace" and t["events"] > 0
    assert set(t["layers"]) == set(cnn_chain_scenes(
        "resnet", max_hw=8, max_ch=4, layers_per_net=3))


@pytest.mark.parametrize("which", ["metrics", "trace", "reference"])
def test_report_equals_the_reference_script(artifacts, which):
    doc = _doc(artifacts[which])
    got, want = obsreport.build_report(doc), REFERENCE.build_report(doc)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("which", ["metrics", "trace", "reference"])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_printed_report_equals_the_reference_script(artifacts, capsys,
                                                    which, as_json):
    argv = [str(artifacts[which])] + (["--json"] if as_json else [])
    assert obsreport.main(argv) == 0
    got = capsys.readouterr().out
    assert REFERENCE.main(argv) == 0
    assert got == capsys.readouterr().out and got
    if as_json:
        assert json.loads(got) == json.loads(json.dumps(
            obsreport.build_report(_doc(artifacts[which]))))


def test_unrecognized_artifact_exits_2(tmp_path, capsys):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"kind": "something-else"}))
    assert obsreport.main([str(path)]) == 2
    assert "unrecognized artifact" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unrecognized artifact"):
        obsreport.build_report({"kind": "something-else"})
