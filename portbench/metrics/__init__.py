"""One reader a metric, found by the metric's name in BENCHMARK.json.

Each module holds `read(run)`: the metric's value from a harness.Run
(the window's steps on the host clock, the profiled steps' device trace,
the reference's work counts), or a (value, extra keys) pair, or None
where the run holds nothing to read, and the harness then leaves the
metric out.  A share of a roofline is never made up as 0.
"""
