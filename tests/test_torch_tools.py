"""The port's operator tools (``tools/*_torch.py``) against the JAX tools.

``loadgen_torch`` draws the JAX ``loadgen``'s traces event for event from
the same seeds; ``render_bundle`` renders a bundle of either package's
engine to the JAX renderer's text; ``dkt_top_torch`` renders the JAX
table from the same samples, and its ``--once``/``--ps`` faces and
``dkt_postmortem_torch``'s file, directory and verb faces run against
the port's servers on loopback. Each twin imports neither JAX, the JAX
package nor a JAX tool (checked in a subprocess over every import
statement of its file), and without ``--cpu`` on a machine with no card
each exits non-zero with the device contract's message.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import dkt_postmortem  # noqa: E402
import dkt_postmortem_torch  # noqa: E402
import dkt_top  # noqa: E402
import dkt_top_torch  # noqa: E402
import loadgen  # noqa: E402
import loadgen_torch  # noqa: E402

torch.set_num_threads(2)

TWINS = ("loadgen_torch", "dkt_postmortem_torch", "dkt_top_torch",
         "soak_training_torch", "soak_serving_torch", "soak_fleet_torch")

PROCESSES = {
    "poisson": {},
    "bursty": {"period": 0.5},
    "diurnal": {"period": 2.0},
    "heavy_tail": {},
    "ramp": {"period": 1.5, "ramp_steps": 3},
    "storm": {"burst_start": 0.5, "burst_len": 0.5, "burst_factor": 5.0},
}
PRESETS = (None, "interactive", "decode_heavy", "storm", "prefix_fleet")


def _tenants(mod, preset):
    return mod.DEFAULT_TENANTS if preset is None else mod.PRESETS[preset](64)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_loadgen_trace_and_summaries_equal_jax(process, preset):
    """Same spec and seed: the same arrivals, tenants, prompts, steps and
    stream flags; the same summaries (with and without phases); and the
    JSON round trip gives back the trace."""
    kw = dict(process=process, rate=40.0, duration=1.5, vocab=97, seed=7,
              **PROCESSES[process])
    mine = loadgen_torch.make_trace(tenants=_tenants(loadgen_torch, preset),
                                    **kw)
    ref = loadgen.make_trace(tenants=_tenants(loadgen, preset), **kw)
    assert mine, "an empty trace checks nothing"
    rows = loadgen_torch.trace_to_jsonable(mine)
    assert rows == loadgen.trace_to_jsonable(ref)
    for a, b in zip(mine, ref):
        assert a["prompt"].dtype == b["prompt"].dtype == np.int32
    for phases in (0, 3):
        assert (loadgen_torch.summarize(mine, phases=phases)
                == loadgen.summarize(ref, phases=phases))
    back = loadgen_torch.trace_from_jsonable(json.loads(json.dumps(rows)))
    assert loadgen_torch.trace_to_jsonable(back) == rows
    for a, b in zip(back, mine):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        assert a["prompt"].dtype == np.int32


def test_loadgen_arrivals_counts_and_outcomes_equal_jax():
    """``arrivals`` bounded by a count, its refusals, and
    ``summarize_outcomes`` over every outcome kind."""
    for proc in ("poisson", "heavy_tail", "ramp"):
        np.testing.assert_array_equal(
            loadgen_torch.arrivals(proc, 25.0, n=50, seed=3, period=1.0),
            loadgen.arrivals(proc, 25.0, n=50, seed=3, period=1.0))
    for bad in (dict(rate=0.0, n=3), dict(rate=1.0)):
        with pytest.raises(ValueError):
            loadgen_torch.arrivals("poisson", **bad)
    with pytest.raises(ValueError):
        loadgen_torch.arrivals("storm", 1.0, n=3)
    outcomes = ["ok", "shed", "ok", "budget_refused", "error:internal",
                "error:overloaded", "error:internal", "weird"]
    assert (loadgen_torch.summarize_outcomes(outcomes)
            == loadgen.summarize_outcomes(outcomes))


def test_loadgen_main_prints_the_jax_summary(capsys):
    args = ["--process", "storm", "--rate", "20", "--duration", "3",
            "--seed", "2", "--phases", "3", "--preset", "storm"]
    assert loadgen.main(args) == 0
    want = capsys.readouterr().out
    assert loadgen_torch.main([*args, "--cpu"]) == 0
    assert capsys.readouterr().out == want


# ------------------------------------------------------ post-mortem bundles


def _tiny_lm_kw():
    return dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2,
                depth=2, seed=0)


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    """A port engine behind a port server, with a post-mortem directory
    holding one bundle (a manual dump after one request)."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.serving import ServingEngine, ServingServer

    pm = str(tmp_path_factory.mktemp("pm"))
    eng = ServingEngine(zoo.transformer_lm(**_tiny_lm_kw(), device="cpu"),
                        num_slots=2, prefill_chunk=4, postmortem_dir=pm,
                        device="cpu").start()
    srv = ServingServer(eng).start()
    eng.generate(np.arange(1, 8, dtype=np.int32), 3)
    bundle, path = eng.dump_postmortem("manual", detail={"via": "test"})
    yield srv, bundle, path, pm
    srv.shutdown()


def _jax_bundle():
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.serving import ServingEngine as JEngine

    eng = JEngine(jzoo.transformer_lm(**_tiny_lm_kw()), num_slots=2,
                  prefill_chunk=4).start()
    try:
        eng.generate(np.arange(1, 8, dtype=np.int32), 3)
        bundle, _ = eng.dump_postmortem("manual", detail={"via": "test"})
    finally:
        eng.stop()
    return bundle


@pytest.mark.parametrize("source", ["port", "jax"])
def test_render_bundle_equals_jax(port_server, source):
    bundle = port_server[1] if source == "port" else _jax_bundle()
    bundle = json.loads(json.dumps(bundle, default=str))
    out = dkt_postmortem_torch.render_bundle(bundle)
    assert out == dkt_postmortem.render_bundle(bundle)
    assert "POST-MORTEM  serving_engine  reason=manual" in out
    assert "via=test" in out
    assert dkt_postmortem_torch.render_bundle(bundle, width=40) == (
        dkt_postmortem.render_bundle(bundle, width=40))


def test_dkt_postmortem_main_reads_file_dir_and_verb(port_server, capsys):
    srv, bundle, path, pm = port_server
    want = dkt_postmortem.render_bundle(
        json.loads(json.dumps(bundle, default=str)))
    assert dkt_postmortem_torch.main([path, "--cpu"]) == 0
    assert capsys.readouterr().out.rstrip("\n") == want
    assert dkt_postmortem_torch.main([pm, "--cpu"]) == 0  # the dir form
    assert "reason=manual" in capsys.readouterr().out
    assert dkt_postmortem_torch.main(
        ["--host", "127.0.0.1", "--port", str(srv.port), "--cpu"]) == 0
    assert "reason=manual" in capsys.readouterr().out
    assert dkt_postmortem_torch.main(
        ["--host", "127.0.0.1", "--port", str(srv.port), "--json",
         "--cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["reason"] == "manual"


def test_postmortem_verb_serves_a_qos_engines_bundle(capsys):
    """The ``postmortem`` verb carries the bundle as JSON: an engine
    configured with a ``QosPolicy`` (not JSON) serves its config value as
    the repr its file holds, and the tool renders it (this verb failed
    with a TypeError before)."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.serving import (
        QosPolicy,
        ServingClient,
        ServingEngine,
        ServingServer,
    )

    eng = ServingEngine(zoo.transformer_lm(**_tiny_lm_kw(), device="cpu"),
                        num_slots=2, qos=QosPolicy(preempt=True),
                        device="cpu").start()
    srv = ServingServer(eng).start()
    try:
        eng.generate(np.arange(1, 6, dtype=np.int32), 2)
        bundle, _ = eng.dump_postmortem("manual")
        assert "QosPolicy" in bundle["config"]["qos"]
        with ServingClient("127.0.0.1", srv.port, timeout=10.0) as c:
            assert c.postmortem()["config"] == bundle["config"]
        assert dkt_postmortem_torch.main(
            ["--host", "127.0.0.1", "--port", str(srv.port), "--cpu"]) == 0
        assert "qos=" in capsys.readouterr().out
    finally:
        srv.shutdown()


def test_dkt_postmortem_empty_dir_exits_nonzero(tmp_path, capsys):
    assert dkt_postmortem_torch.main([str(tmp_path), "--cpu"]) == 1
    assert "no postmortem_" in capsys.readouterr().err


# ------------------------------------------------------------------ dkt_top

#: the samples of ``tests/test_autoscale.py``'s dkt_top fleet column
FLEET_SAMPLES = [
    {"name": "fleet_replicas", "kind": "gauge", "value": 2,
     "labels": {"replica": "router"}},
    {"name": "fleet_autoscale_scale_ups", "kind": "counter",
     "value": 3, "labels": {"replica": "router"}},
    {"name": "fleet_autoscale_scale_downs", "kind": "counter",
     "value": 1, "labels": {"replica": "router"}},
]
FLEET_SERIES = {
    ("router", "fleet_replicas", ()): {
        "points": [1, 1, None, 2, 2], "rate": None, "trend": 0.1,
    },
}


@pytest.mark.parametrize("case", ["plain", "series", "never_scaled",
                                  "narrow"])
def test_dkt_top_format_table_equals_jax(case):
    samples, kw = FLEET_SAMPLES, {}
    if case == "series":
        kw = {"series": FLEET_SERIES}
    elif case == "never_scaled":
        samples = [dict(FLEET_SAMPLES[0])]
    elif case == "narrow":
        kw = {"width": 40, "series": FLEET_SERIES}
    out = dkt_top_torch.format_table([dict(s) for s in samples], **kw)
    assert out == dkt_top.format_table([dict(s) for s in samples], **kw)
    header = out.splitlines()[0]
    assert "replicas=2" in header
    assert ("↑3↓1" in header) == (case != "never_scaled")


def test_dkt_top_tables_of_a_live_server_equal_jax(port_server):
    """A port server's samples and timeseries reply: the same index and
    the same table through both tools."""
    from distkeras_tpu_torch.serving import ServingClient

    srv = port_server[0]
    with ServingClient("127.0.0.1", srv.port, timeout=10.0) as c:
        samples = c.metrics()
        ts = c.timeseries(window=60)
    assert dkt_top_torch.series_index(ts) == dkt_top.series_index(ts)
    series = dkt_top_torch.series_index(ts)
    for kw in ({}, {"series": series}):
        assert (dkt_top_torch.format_table([dict(s) for s in samples], **kw)
                == dkt_top.format_table([dict(s) for s in samples], **kw))


def test_dkt_top_once_against_port_server(port_server, capsys):
    from distkeras_tpu_torch.obs import parse_prometheus

    srv = port_server[0]
    args = ["127.0.0.1", str(srv.port), "--once", "--cpu"]
    assert dkt_top_torch.main(args) == 0
    out = capsys.readouterr().out
    assert "serving_scheduler_completed" in out
    assert dkt_top_torch.main([*args, "--no-series"]) == 0
    assert "serving_scheduler_completed" in capsys.readouterr().out
    assert dkt_top_torch.main([*args, "--prometheus"]) == 0
    parse_prometheus(capsys.readouterr().out)


def test_dkt_top_ps_against_port_parameter_server(capsys):
    from distkeras_tpu_torch.parameter_servers import (
        DeltaParameterServer,
        RemoteParameterServerClient,
        SocketParameterServer,
    )

    srv = SocketParameterServer(
        DeltaParameterServer({"w": np.zeros(3, np.float32)}),
        host="127.0.0.1")
    srv.start()
    try:
        cli = RemoteParameterServerClient("127.0.0.1", srv.port)
        for seq in range(3):
            cli.commit({"w": np.ones(3, np.float32)}, commit_id=(0, seq))
        cli.close()
        args = ["127.0.0.1", str(srv.port), "--once", "--ps", "--cpu"]
        assert dkt_top_torch.main(args) == 0
        out = capsys.readouterr().out
        assert "training_ps_commits" in out and "(primary)" in out
        assert dkt_top_torch.main([*args, "--prometheus"]) == 0
        assert "training_ps_commits" in capsys.readouterr().out
    finally:
        srv.stop()


# ------------------------------------------------------ hygiene and device


def _imports_of(path):
    """Every module an import statement of ``path`` names, at any depth
    (the soaks import inside their functions)."""
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


@pytest.mark.parametrize("twin", TWINS)
def test_twin_imports_nothing_of_jax(twin):
    """In a fresh interpreter: import the twin and every module any of its
    import statements names; neither JAX, the JAX package nor a JAX tool
    module may be loaded afterwards."""
    path = os.path.join(TOOLS, f"{twin}.py")
    mods = _imports_of(path)
    assert not any(m.split(".")[0] in ("jax", "distkeras_tpu") for m in mods)
    jax_tools = [f[:-3] for f in os.listdir(TOOLS)
                 if f.endswith(".py") and not f.endswith("_torch.py")]
    assert not set(mods) & set(jax_tools), set(mods) & set(jax_tools)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {TOOLS!r})\n"
        f"importlib.import_module({twin!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"('jax', 'distkeras_tpu', *{jax_tools!r})]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _cli(twin, tmp_path):
    bundle = tmp_path / "b.json"
    bundle.write_text(json.dumps({"component": "x", "reason": "manual",
                                  "ts": 0.0, "events": []}))
    return {
        "loadgen_torch": ["--duration", "1"],
        "dkt_postmortem_torch": [str(bundle)],
        "dkt_top_torch": ["127.0.0.1", "1", "--once"],
        "soak_training_torch": ["--smoke"],
        "soak_serving_torch": ["--duration", "1"],
        "soak_fleet_torch": ["--smoke"],
    }[twin]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("twin", TWINS)
def test_twin_without_a_card_exits_nonzero(twin, tmp_path):
    """No ``--cpu`` and no card: the twin stops before it does anything,
    non-zero, with ``resolve_device``'s message (no fallback)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(TOOLS, f"{twin}.py"),
         *_cli(twin, tmp_path)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=env)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout == ""
