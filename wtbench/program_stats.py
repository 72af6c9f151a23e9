"""The program's own counters and spans, as the per-layer readers
(wtbench/metrics/<name>.py) take them: the registry of
wave_tracer_tpu_torch/util/stats.py in the run's process. `run.py` makes
one run a process, so the registry holds set-up and the window; spans
are recorded only while the traced window's profiler runs. A program
without the counter or span read gives None."""

from __future__ import annotations


def report():
    from wave_tracer_tpu_torch.util.stats import registry
    return registry.report()


def stream_pct(names):
    """The stream seconds of the spans `names` over those of `wt.frame`,
    in percent; None where the registry holds neither."""
    rep = report()
    frame = rep.get("wt.frame")
    parts = [rep[n]["stream_s"] for n in names if n in rep]
    if not isinstance(frame, dict) or frame["stream_s"] <= 0 or not parts:
        return None
    return 100.0 * sum(parts) / frame["stream_s"]
