"""Runner toolkit of the port: the parts of ``sparkdl_tpu/runner`` the
serving engine reaches — the flight recorder (``events``), the metrics
registry (``telemetry``), the anomaly sentinel (``sentinel``) and fault
injection at the serving sites (``chaos``). The launcher, checkpointing,
training loop, SLO monitor and the rest of the telemetry plane come
with the slices that port their callers (ROADMAP.md)."""
