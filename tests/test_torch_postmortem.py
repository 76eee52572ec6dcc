"""The port's postmortem (``deeplearning4j_tpu_torch/profiling/
postmortem.py``) against the JAX package's ``tools/postmortem.py``, on the
CPU: the self-check round-trips a synthetic bundle through the port's own
watchdog, tracer, flight recorder and atomic write; ``summarize`` renders
a bundle the port's watchdog wrote as the JAX package's tool does; and
the command line reads bundles, refuses what is not one, and exits as the
tool does. ``tools/postmortem.py`` is loaded by path."""

import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.profiling import postmortem, watchdog
from deeplearning4j_tpu_torch.profiling.flightrec import (
    FlightRecorder, record, set_flightrec,
)
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, set_registry,
)
from deeplearning4j_tpu_torch.profiling.tracer import Tracer, set_tracer

REPO = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "postmortem_tool", REPO / "tools" / "postmortem.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def bundle():
    """A bundle the port's watchdog assembles over a wedged thread: two
    open spans, a stale heartbeat, flight events and a metric."""
    prev = (set_tracer(Tracer()), set_flightrec(FlightRecorder(64)),
            set_registry(MetricsRegistry()))
    watchdog.clear_beats()
    from deeplearning4j_tpu_torch.profiling.metrics import get_registry
    from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
    get_registry().counter("resilience_skipped_batches_total").inc(3)
    record("serving", "admit", rows=4)
    record("serving", "wedged", step=7)
    wedged, release = threading.Event(), threading.Event()

    def _wedge():
        with get_tracer().span("decode_loop"):
            with get_tracer().span("decode_loop:dispatch"):
                watchdog.beat("serving_decode")
                wedged.set()
                release.wait(10.0)

    t = threading.Thread(target=_wedge, name="decode-wedge")
    t.start()
    try:
        assert wedged.wait(5.0)
        time.sleep(0.02)
        age = watchdog.heartbeat_ages()["serving_decode"]
        with watchdog._beats_lock:
            tid = watchdog._beats["serving_decode"][1]
        b = watchdog.assemble_bundle(
            reason="test", stale={"subsystem": "serving_decode",
                                  "age_s": age, "deadline_s": 0.01,
                                  "tid": tid})
    finally:
        release.set()
        t.join(10.0)
        set_tracer(prev[0])
        set_flightrec(prev[1])
        set_registry(prev[2])
        watchdog.clear_beats()
    return json.loads(json.dumps(b, default=repr))


def test_self_check_passes(capsys):
    assert postmortem.self_check() == 0
    assert "bundle round-trip OK" in capsys.readouterr().out


@pytest.mark.parametrize("max_flight,max_frames", [(20, 12), (1, 2)])
def test_summarize_equals_the_jax_packages_tool(bundle, max_flight,
                                                max_frames):
    got = postmortem.summarize(bundle, max_flight, max_frames)
    assert got == _tool().summarize(bundle, max_flight, max_frames)
    assert "CULPRIT: span 'decode_loop:dispatch'" in got
    assert "resilience_skipped_batches_total = 3" in got


def test_load_bundle_and_the_command_line(bundle, tmp_path):
    good = tmp_path / "bundle-1.json"
    good.write_text(json.dumps(bundle))
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"format": "something/v1"}))
    assert postmortem.load_bundle(str(good)) == bundle
    with pytest.raises(ValueError, match="not a diagnostic bundle"):
        postmortem.load_bundle(str(other))
    run = [sys.executable, "-m", "deeplearning4j_tpu_torch.profiling."
           "postmortem"]
    proc = subprocess.run(run + [str(good)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == postmortem.summarize(bundle)
    proc = subprocess.run(run + [str(good), str(other)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "not a diagnostic bundle" in proc.stderr
