"""Read a diagnostic bundle (the stall watchdog's black box): the JAX
package's ``tools/postmortem.py``, kept as the port's own copy.

    python -m deeplearning4j_tpu_torch.profiling.postmortem bundle-*.json
    python -m deeplearning4j_tpu_torch.profiling.postmortem --self-check

A bundle is the JSON ``profiling/watchdog.StallWatchdog`` writes when a
heartbeat goes stale (or on SIGTERM / atexit): thread stacks, each
thread's open spans, a metrics snapshot and the flight recorder's tail,
in the format both packages share (``dl4j-tpu-diagnostic-bundle/v1``).
:func:`summarize` answers the on-call question first, WHO is stuck (the
culprit: the deepest open span of the stalest heartbeat's thread), then
lays out the evidence newest first; it renders a bundle as the JAX
package's tool does.

``--self-check`` round-trips a synthetic bundle through the port's own
pipeline (a wedged thread's open spans and stale heartbeat ->
``watchdog.assemble_bundle`` -> ``resilience/atomic`` write -> load ->
summarize) and exits nonzero if any leg breaks; ``analysis/analyze``
runs it as the ``postmortem`` layer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List

# metrics worth surfacing in the summary even when nothing is stale
_KEY_METRIC_PREFIXES = ("resilience_", "tracer_", "serving_", "input_",
                        "elastic_")


def _fmt_age(seconds: float) -> str:
    if seconds < 120:
        return f"{seconds:.1f}s"
    if seconds < 7200:
        return f"{seconds / 60:.1f}m"
    return f"{seconds / 3600:.1f}h"


def summarize(bundle: Dict[str, Any], max_flight: int = 20,
              max_frames: int = 12) -> str:
    """Render one bundle as the on-call text report."""
    lines: List[str] = []
    add = lines.append
    fmt = bundle.get("format", "?")
    add(f"diagnostic bundle [{fmt}]")
    add(f"  reason : {bundle.get('reason', '?')}")
    when = bundle.get("written_at_unix")
    if when:
        add(f"  written: {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(when))}"
            f"  (pid {bundle.get('pid', '?')})")

    culprit = bundle.get("culprit")
    if culprit:
        add(f"  CULPRIT: span {culprit.get('span')!r} "
            f"(subsystem={culprit.get('subsystem')}, "
            f"tid={culprit.get('tid')}, via={culprit.get('via')})")
    else:
        add("  CULPRIT: none identified (no open spans)")

    stale = bundle.get("stale")
    if stale:
        add(f"  stale  : {stale.get('subsystem')} silent "
            f"{_fmt_age(stale.get('age_s', 0.0))} "
            f"(deadline {stale.get('deadline_s')}s, tid {stale.get('tid')})")

    beats = bundle.get("heartbeats") or {}
    if beats:
        add("  heartbeats (stalest first):")
        for name in sorted(beats, key=lambda n: -beats[n]["age_s"]):
            hb = beats[name]
            add(f"    {name:<24} {_fmt_age(hb['age_s']):>8}  "
                f"tid {hb['tid']}")

    spans = bundle.get("open_spans") or {}
    if spans:
        add("  open spans (deepest last per thread):")
        for tid in sorted(spans):
            chain = " > ".join(s["name"] for s in spans[tid])
            add(f"    tid {tid}: {chain}")
    err = bundle.get("error_spans") or []
    if err:
        add(f"  last error unwound through: {' > '.join(err)}")

    threads = bundle.get("threads") or []
    if threads:
        add(f"  threads ({len(threads)}):")
        for t in threads:
            add(f"    [{t.get('tid')}] {t.get('name', '?')}")
            for fs in (t.get("stack") or [])[-max_frames:]:
                add(f"      {fs['file']}:{fs['line']} in {fs['func']}"
                    + (f"  -- {fs['code']}" if fs.get("code") else ""))

    metrics = bundle.get("metrics") or {}
    key = {k: v for k, v in metrics.items()
           if k.startswith(_KEY_METRIC_PREFIXES)
           and not isinstance(v, dict)}
    if key:
        add("  key metrics:")
        for k in sorted(key):
            add(f"    {k} = {key[k]}")

    tail = bundle.get("flight_tail") or []
    total = bundle.get("flight_total", len(tail))
    if tail:
        add(f"  flight recorder (last {min(max_flight, len(tail))} of "
            f"{total} events):")
        for ev in tail[-max_flight:]:
            detail = ev.get("detail") or {}
            kv = " ".join(f"{k}={v}" for k, v in detail.items())
            add(f"    {ev.get('ts', 0):.3f} {ev.get('subsystem')}:"
                f"{ev.get('kind')}" + (f"  {kv}" if kv else ""))
    return "\n".join(lines)


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("format") != "dl4j-tpu-diagnostic-bundle/v1":
        raise ValueError(
            f"{path}: not a diagnostic bundle (format="
            f"{bundle.get('format')!r})")
    return bundle


# ------------------------------------------------------------ self-check

def self_check() -> int:
    """Round-trip a synthetic bundle through the REAL pipeline: stale
    heartbeat + open span -> assemble_bundle -> atomic write -> load ->
    summarize, asserting the culprit names the stalled span."""
    import tempfile
    import threading

    from deeplearning4j_tpu_torch.profiling.flightrec import (FlightRecorder,
                                                        set_flightrec)
    from deeplearning4j_tpu_torch.profiling.tracer import Tracer, set_tracer
    from deeplearning4j_tpu_torch.profiling import watchdog as wd
    from deeplearning4j_tpu_torch.resilience.atomic import atomic_write_bytes

    failures: List[str] = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)

    prev_tracer = set_tracer(Tracer())
    prev_rec = set_flightrec(FlightRecorder(max_events=64))
    wd.clear_beats()
    try:
        from deeplearning4j_tpu_torch.profiling.flightrec import record
        from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

        record("selfcheck", "probe_started", rung="synthetic")
        record("selfcheck", "probe_wedged", step=3)
        stalled = threading.Event()
        release = threading.Event()

        def _wedge():
            with get_tracer().span("selfcheck:outer"):
                with get_tracer().span("selfcheck:wedged_phase"):
                    wd.beat("selfcheck")
                    stalled.set()
                    release.wait(10.0)

        t = threading.Thread(target=_wedge, name="selfcheck-wedge")
        t.start()
        try:
            check(stalled.wait(5.0), "wedge thread never started")
            time.sleep(0.05)    # let the heartbeat age past zero
            ages = wd.heartbeat_ages()
            check(ages.get("selfcheck", 0) > 0, "heartbeat did not age")
            with wd._beats_lock:
                tid = wd._beats["selfcheck"][1]
            bundle = wd.assemble_bundle(
                reason="self_check",
                stale={"subsystem": "selfcheck",
                       "age_s": ages.get("selfcheck", 0.0),
                       "deadline_s": 0.01, "tid": tid})
        finally:
            release.set()
            t.join(10.0)

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "bundle-selfcheck.json")
            atomic_write_bytes(
                path, json.dumps(bundle, indent=2, default=repr).encode())
            loaded = load_bundle(path)

        culprit = loaded.get("culprit") or {}
        check(culprit.get("span") == "selfcheck:wedged_phase",
              f"culprit is {culprit.get('span')!r}, wanted the deepest "
              f"open span 'selfcheck:wedged_phase'")
        check(culprit.get("subsystem") == "selfcheck",
              f"culprit subsystem {culprit.get('subsystem')!r}")
        check(any(ev["kind"] == "probe_wedged"
                  for ev in loaded.get("flight_tail", [])),
              "flight tail lost the probe_wedged event")
        check(any(th.get("name") == "selfcheck-wedge"
                  for th in loaded.get("threads", [])),
              "thread dump missing the wedged thread")
        check(isinstance(loaded.get("metrics"), dict),
              "metrics snapshot missing")

        report = summarize(loaded)
        check("CULPRIT" in report and "selfcheck:wedged_phase" in report,
              "summary does not name the culprit span")
        check("probe_wedged" in report,
              "summary does not include the flight tail")
    finally:
        set_tracer(prev_tracer)
        set_flightrec(prev_rec)
        wd.clear_beats()

    if failures:
        for msg in failures:
            print(f"postmortem self-check FAIL: {msg}", file=sys.stderr)
        return 2
    print("postmortem self-check: bundle round-trip OK "
          "(assemble -> atomic write -> load -> summarize)")
    return 0


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.profiling.postmortem",
        description="pretty-print stall-watchdog diagnostic bundles")
    ap.add_argument("bundles", nargs="*", help="bundle JSON path(s)")
    ap.add_argument("--self-check", action="store_true",
                    help="round-trip a synthetic bundle; exit nonzero "
                         "on failure")
    ap.add_argument("--flight", type=int, default=20,
                    help="flight-recorder tail lines to show")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check()
    if not args.bundles:
        ap.error("no bundle paths given (or use --self-check)")
    rc = 0
    for i, path in enumerate(args.bundles):
        if i:
            print()
        try:
            print(summarize(load_bundle(path), max_flight=args.flight))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"postmortem: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
