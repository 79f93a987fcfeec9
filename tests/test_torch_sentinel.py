"""The port's online anomaly sentinel (``runner/sentinel.py``), on the CPU.

Twins of the 14 tests of ``tests/test_sentinel.py`` (``TestRollingBaseline``,
``TestSentinelPlane``, ``TestOffIsFree``, ``TestBenchLedger``,
``TestConcurrency``): each drives the port and, where the test has an
output (an anomaly record, counts, stats, the armed knobs), the JAX
package on the same observations, and the outputs must be equal. One more
test feeds a single seeded stream of observations over four metrics
through both packages' sentinels and holds their anomaly events and
counts equal.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import threading

import numpy as np
import pytest

from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import sentinel as ref_sentinel
from sparkdl_tpu.runner import telemetry as ref_telemetry
from sparkdl_tpu.runner.metrics import ThroughputMeter as RefMeter
from sparkdl_tpu_torch.runner import events, sentinel, telemetry
from sparkdl_tpu_torch.runner.metrics import ThroughputMeter

# (sentinel, events, telemetry) of each package, the port first
PKGS = ((sentinel, events, telemetry),
        (ref_sentinel, ref_events, ref_telemetry))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Every test starts disarmed with clean recorders and registries, in
    both packages; env arming from one test must not leak."""
    for k in (sentinel.SENTINEL_ENV, sentinel.RATIO_ENV,
              sentinel.WINDOW_ENV, sentinel.MIN_N_ENV):
        monkeypatch.delenv(k, raising=False)
    for sen, ev, tel in PKGS:
        sen.disarm()
        tel.reset()
        ev.reset()
    yield
    for sen, ev, tel in PKGS:
        sen.disarm()
        tel.reset()
        ev.reset()


def _anomalies(ev) -> list:
    return [{k: v for k, v in e.items() if k != "t"}
            for e in ev.get_recorder().tail() if e["name"] == "anomaly"]


class TestRollingBaseline:
    def test_detects_5x_slowdown_within_one_window(self):
        got = []
        for sen, _, _ in PKGS:
            b = sen.RollingBaseline("step_time", ratio=2.0, window=8,
                                    min_n=8)
            for _ in range(16):
                assert b.observe(0.01) is None
            fired = [(i, a) for i in range(8) if (a := b.observe(0.05))]
            assert len(fired) == 1
            i, a = fired[0]
            assert i < 8
            assert a["metric"] == "step_time"
            assert a["window_p95"] >= 0.05
            assert a["baseline_p95"] == pytest.approx(0.01)
            got.append(fired)
        assert got[0] == got[1]

    def test_anomalous_samples_do_not_poison_baseline(self):
        got = []
        for sen, _, _ in PKGS:
            b = sen.RollingBaseline("m", ratio=2.0, window=8, min_n=8)
            for _ in range(16):
                b.observe(0.01)
            n_before = len(b._baseline)
            for _ in range(50):
                b.observe(0.05)
            assert len(b._baseline) == n_before
            assert b.summary()["anomalous"] is True
            assert b.baseline_p95() == pytest.approx(0.01)
            got.append(b.summary())
        assert got[0] == got[1]

    def test_recovery_rearms_the_edge(self):
        got = []
        for sen, _, _ in PKGS:
            b = sen.RollingBaseline("m", ratio=2.0, window=4, min_n=8)
            for _ in range(16):
                b.observe(0.01)
            assert any(b.observe(0.05) for _ in range(4))
            assert not any([b.observe(0.01) for _ in range(8)])
            assert b.summary()["anomalous"] is False
            assert any(b.observe(0.05) for _ in range(4))
            assert b.summary()["anomalies"] == 2
            got.append(b.summary())
        assert got[0] == got[1]

    def test_zero_baseline_never_divides_or_fires(self):
        for sen, _, _ in PKGS:
            b = sen.RollingBaseline("queue_depth", ratio=2.0, window=4,
                                    min_n=8)
            for _ in range(16):
                assert b.observe(0.0) is None
            for _ in range(8):
                assert b.observe(3.0) is None


class TestSentinelPlane:
    def test_anomaly_emits_event_and_counter(self):
        got = []
        for sen, ev, tel in PKGS:
            sen.arm(ratio=2.0, window=8, min_n=8)
            for _ in range(16):
                sen.observe("step_time", 0.01)
            for _ in range(8):
                sen.observe("step_time", 0.05)
            anomalies = _anomalies(ev)
            assert len(anomalies) == 1
            assert anomalies[0]["metric"] == "step_time"
            assert anomalies[0]["ph"] == "P"
            counters = tel.registry().snapshot()["counters"]
            assert counters["sentinel_anomalies_total"] == 1
            assert sen.anomaly_counts() == {"step_time": 1}
            got.append(anomalies)
        assert got[0] == got[1]

    def test_metrics_are_independent(self):
        got = []
        for sen, _, _ in PKGS:
            sen.arm(ratio=2.0, window=8, min_n=8)
            for _ in range(16):
                sen.observe("ttft", 0.01)
                sen.observe("decode_step", 0.002)
            for _ in range(8):
                sen.observe("ttft", 0.05)
                sen.observe("decode_step", 0.002)
            assert sen.anomaly_counts() == {"ttft": 1}
            assert sen.stats()["decode_step"]["anomalies"] == 0
            got.append(sen.stats())
        assert got[0] == got[1]

    def test_throughput_meter_feeds_step_time(self, monkeypatch):
        """A metered loop whose steps suddenly run 5x slower trips the
        sentinel through ThroughputMeter alone, in both packages."""
        for (sen, _, _), meter_cls in zip(PKGS, (ThroughputMeter,
                                                 RefMeter)):
            sen.arm(ratio=2.0, window=8, min_n=8)
            now = [100.0]
            monkeypatch.setattr(
                "sparkdl_tpu_torch.runner.metrics.time.perf_counter",
                lambda: now[0])
            meter = meter_cls(warmup_steps=0)
            for _ in range(20):
                now[0] += 0.01
                meter.update(8)
            for _ in range(8):
                now[0] += 0.05
                meter.update(8)
            monkeypatch.undo()
            assert sen.anomaly_counts().get("step_time") == 1

    def test_arm_from_env_and_knobs(self, monkeypatch):
        got = []
        for sen, _, _ in PKGS:
            monkeypatch.delenv(sen.SENTINEL_ENV, raising=False)
            assert sen.maybe_arm_from_env() is None
            assert not sen.armed()
            monkeypatch.setenv(sen.SENTINEL_ENV, "1")
            monkeypatch.setenv(sen.RATIO_ENV, "3.5")
            monkeypatch.setenv(sen.WINDOW_ENV, "16")
            monkeypatch.setenv(sen.MIN_N_ENV, "10")
            s = sen.maybe_arm_from_env()
            assert s is not None and sen.armed()
            assert s.ratio == 3.5 and s.window == 16 and s.min_n == 10
            got.append((s.ratio, s.window, s.min_n))
            monkeypatch.delenv(sen.SENTINEL_ENV)
        assert got[0] == got[1]

    def test_bad_env_values_degrade_to_defaults(self, monkeypatch):
        monkeypatch.setenv(sentinel.SENTINEL_ENV, "1")
        monkeypatch.setenv(sentinel.RATIO_ENV, "fast")
        monkeypatch.setenv(sentinel.WINDOW_ENV, "abc")
        for sen, _, _ in PKGS:
            s = sen.maybe_arm_from_env()
            assert s is not None
            assert s.ratio == sen._DEFAULT_RATIO
            assert s.window == sen._DEFAULT_WINDOW
            rb = sen.RollingBaseline("m", ratio=2.0, window=-3, min_n=4)
            for _ in range(16):
                rb.observe(0.01)
            assert rb.observe(0.05) is not None
        assert sentinel._DEFAULT_RATIO == ref_sentinel._DEFAULT_RATIO
        assert sentinel._DEFAULT_WINDOW == ref_sentinel._DEFAULT_WINDOW


class TestOffIsFree:
    def test_off_registers_nothing(self):
        for sen, ev, tel in PKGS:
            for _ in range(16):
                sen.observe("step_time", 0.01)
            for _ in range(8):
                sen.observe("step_time", 0.05)
            assert sen._SENTINEL is None
            assert sen.anomaly_counts() == {}
            assert _anomalies(ev) == []
            assert "sentinel_anomalies_total" not in \
                tel.registry().snapshot()["counters"]

    def test_off_adds_no_per_step_overhead(self):
        """Disarmed observe() is one global read and a return: nothing
        executes before the read of ``_SENTINEL``."""
        import dis
        for sen, _, _ in PKGS:
            ops = list(dis.get_instructions(sen.observe))
            idx = next(i for i, op in enumerate(ops)
                       if op.argval == "_SENTINEL")
            assert not any("CALL" in op.opname for op in ops[:idx])

    def test_disarm_after_arm_really_disarms(self):
        for sen, _, _ in PKGS:
            sen.arm(ratio=2.0, window=8, min_n=8)
            assert sen.armed()
            sen.disarm()
            assert not sen.armed()
            sen.observe("step_time", 99.0)
            assert sen.anomaly_counts() == {}


class TestBenchLedger:
    def test_anomaly_counts_shape_rides_failure_stats(self):
        got = []
        for sen, _, _ in PKGS:
            sen.arm(ratio=2.0, window=8, min_n=8)
            for _ in range(16):
                sen.observe("ttft", 0.01)
            for _ in range(8):
                sen.observe("ttft", 0.05)
            counts = sen.anomaly_counts()
            assert counts == json.loads(json.dumps(counts))
            assert all(isinstance(k, str) and isinstance(v, int)
                       for k, v in counts.items())
            got.append(counts)
        assert got[0] == got[1]


class TestConcurrency:
    def test_concurrent_observe_is_safe(self):
        for sen, _, _ in PKGS:
            sen.arm(ratio=2.0, window=8, min_n=8)
            for _ in range(32):
                sen.observe("queue_depth", 1.0)

            def hammer():
                for _ in range(200):
                    sen.observe("queue_depth", 5.0)

            threads = [threading.Thread(target=hammer) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert sen.anomaly_counts() == {"queue_depth": 1}


def test_one_seeded_stream_gives_equal_anomalies():
    """One seeded stream of 2,000 observations over four metrics, with
    slow episodes and recoveries, through both packages' sentinels: the
    same anomaly events (all but the wall time), counts and stats."""
    rng = np.random.default_rng(1234)
    names = ("step_time", "ttft", "decode_step", "queue_depth")
    base = {"step_time": 0.075, "ttft": 0.2, "decode_step": 0.01,
            "queue_depth": 3.0}
    stream = []
    for i in range(2000):
        m = names[int(rng.integers(4))]
        slow = (i // 250) % 3 == 2  # one slow episode in three
        v = base[m] * rng.lognormal(0.0, 0.1) * (5.0 if slow else 1.0)
        stream.append((m, float(v)))
    got = []
    for sen, ev, tel in PKGS:
        sen.arm(ratio=2.0, window=16, min_n=16)
        for m, v in stream:
            sen.observe(m, v)
        got.append((_anomalies(ev), sen.anomaly_counts(), sen.stats(),
                    tel.registry().snapshot()["counters"]
                    ["sentinel_anomalies_total"]))
    port, ref = got
    assert port[1] and sum(port[1].values()) >= 4  # the episodes fired
    assert [{k: v for k, v in a.items() if k != "rank"} for a in port[0]] \
        == [{k: v for k, v in a.items() if k != "rank"} for a in ref[0]]
    assert port[1:] == ref[1:]
