"""The port's flight recorder, step-time statistics, heartbeats, metrics
logger and profiler helpers (``runner/events.py``, ``runner/metrics.py``),
on the CPU.

Twins of ``tests/test_events.py``'s ``TestRecorder``, ``TestStepTimeStats``,
``TestPostmortem``, ``TestOverheadBounded``, ``TestMergeTimeline``,
``TestHeartbeatSatellite``, ``TestMetricsLoggerSatellite``,
``TestTraceSatellite`` and ``TestDegradations``. Where a test has an output
(a merged timeline, its rendering, a postmortem's keys, a step-time
summary, a log line), the same inputs go through the JAX package and the
port and the outputs are compared; they must be equal, but for wall
times. The fits train a 4×3 linear softmax model on seeded numpy batches
(the reference's problem), the port's on the CPU.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import sys
import time
import types

import numpy as np
import optax
import pytest
import torch

import jax
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu.runner import chaos as ref_chaos
from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import launcher as ref_launcher
from sparkdl_tpu.runner import metrics as ref_metrics
from sparkdl_tpu.runner import softmax_cross_entropy_loss as jax_sce
from sparkdl_tpu_torch.runner import (Fault, FaultPlan, StepTimeStats,
                                      ThroughputMeter, XlaRunner, chaos,
                                      events, sgd,
                                      softmax_cross_entropy_loss)
from sparkdl_tpu_torch.runner import launcher as port_launcher
from sparkdl_tpu_torch.runner import metrics as metrics_lib
from sparkdl_tpu_torch.runner.metrics import MetricsLogger

_ENV = ("SPARKDL_EVENT_DIR", "SPARKDL_EVENT_RING", "SPARKDL_PEAK_FLOPS",
        "SPARKDL_HEARTBEAT_DIR", "SPARKDL_BATCH_LEDGER",
        "SPARKDL_EVENT_MAX_MB", "SPARKDL_PROCESS_ID", "SPARKDL_TRACE_ID",
        "SPARKDL_MFU_ESTIMATE", "SPARKDL_FEED_LOOKAHEAD")


def _reset_both():
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    for mod in (events, ref_events):
        mod.reset()
    for mod in (metrics_lib, ref_metrics):
        mod.global_step_stats.reset()
        mod.run_stats.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every test starts with fresh recorders, no stream dir, no plan and
    zeroed process-wide stats, in both packages."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    _reset_both()
    yield
    _reset_both()


class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))

    def forward(self, x):
        return x @ self.w


def _params(seed=0):
    return {"w": np.random.RandomState(seed).randn(4, 3).astype(np.float32)}


def _data(n_batches=64, seed=1):
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        x = rng.randn(16, 4).astype(np.float32)
        yield {"image": x, "label": rng.randint(0, 3, (16,))}


def _fit(ctx, **kw):
    kw.setdefault("num_steps", 4)
    kw.setdefault("log_every", 100)
    return ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                   model=Linear(_params()["w"]), tx=sgd(0.1), data=_data(),
                   **kw)


def _jax_fit(ctx, **kw):
    kw.setdefault("num_steps", 4)
    kw.setdefault("log_every", 100)
    return ctx.fit(loss_fn=jax_sce(), params=_params(), tx=optax.sgd(0.1),
                   apply_fn=lambda p, x: x @ p["w"], data=_data(), **kw)


def _port_run(fn):
    return XlaRunner(device="cpu").run(fn)


def _ref_run(fn):
    return JaxRunner(np=1).run(fn)


def _no_times(x):
    """``x`` with every wall-clock value (``t``, ``dur_s``, ``mtime``,
    ``time``) dropped, recursively."""
    if isinstance(x, dict):
        return {k: _no_times(v) for k, v in x.items()
                if k not in ("t", "dur_s", "mtime", "time")}
    if isinstance(x, list):
        return [_no_times(v) for v in x]
    return x


# --- TestRecorder ------------------------------------------------------------

class TestRecorder:
    def test_ring_is_bounded(self):
        tails = []
        for mod in (events, ref_events):
            rec = mod.reset(ring_size=16)
            for i in range(100):
                rec.event("e", i=i)
            tail = rec.tail()
            assert len(tail) == 16
            assert tail[0]["i"] == 84 and tail[-1]["i"] == 99
            tails.append([e["i"] for e in tail])
        assert tails[0] == tails[1]

    def test_span_records_duration_and_error(self):
        ends = []
        for mod in (events, ref_events):
            rec = mod.reset()
            with mod.span("ok", step=3):
                time.sleep(0.002)
            with pytest.raises(ValueError, match="boom"):
                with mod.span("bad"):
                    raise ValueError("boom")
            ok_end = [e for e in rec.tail() if e["name"] == "ok"
                      and e["ph"] == "E"][0]
            assert ok_end["dur_s"] >= 0.002 and ok_end["step"] == 3
            bad_end = [e for e in rec.tail() if e["name"] == "bad"
                       and e["ph"] == "E"][0]
            assert bad_end["error"] == "ValueError: boom"
            ends.append(_no_times(rec.tail()))
        assert ends[0] == ends[1]

    def test_data_exhaustion_is_not_an_error(self):
        for mod in (events, ref_events):
            rec = mod.reset()
            it = iter([])
            try:
                with mod.span("data_fetch", step=0):
                    next(it)
            except StopIteration:
                pass
            end = rec.tail()[-1]
            assert end["ph"] == "E" and end.get("end_of_data") is True
            assert "error" not in end

    def test_block_on_error_does_not_mask_region_error(self, monkeypatch):
        """The wait for the device failing while the region also raised:
        the region's exception propagates, the wait's is recorded as
        ``block_error``; from a clean region the wait's error surfaces."""
        rec = events.reset()

        def broken(tree):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(events, "_block_until_ready", broken)
        with pytest.raises(ValueError, match="diverged-ish"):
            with events.span("step", block_on=torch.zeros(1)):
                raise ValueError("diverged-ish user error")
        end = rec.tail()[-1]
        assert end["error"].startswith("ValueError")
        assert end["block_error"].startswith("RuntimeError")
        with pytest.raises(RuntimeError, match="illegal memory"):
            with events.span("step", block_on=torch.zeros(1)):
                pass
        assert rec.tail()[-1]["error"].startswith("RuntimeError")

    def test_no_dir_means_no_io(self, tmp_path):
        rec = events.reset()
        for i in range(50):
            rec.event("e", i=i)
        assert rec._file is None  # never opened a stream
        assert list(tmp_path.iterdir()) == []

    def test_streams_jsonl_per_rank(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "3")
        streams = []
        for mod, d in ((events, tmp_path / "port"),
                       (ref_events, tmp_path / "ref")):
            monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d))
            rec = mod.reset()
            rec.event("alpha", step=1)
            with rec.span("beta"):
                pass
            rec.close()
            recs = [json.loads(ln) for ln in
                    (d / "events_rank3.jsonl").read_text().splitlines()]
            assert [r["name"] for r in recs] == ["alpha", "beta", "beta"]
            assert [r["ph"] for r in recs] == ["P", "B", "E"]
            assert all(r["rank"] == 3 for r in recs)
            streams.append(_no_times(recs))
        assert streams[0] == streams[1]

    def test_stream_cap_bounds_file_ring_keeps_recording(self, tmp_path,
                                                         monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        monkeypatch.setenv("SPARKDL_EVENT_MAX_MB", "0.0005")  # ~520 bytes
        counts = []
        for mod, d in ((events, tmp_path / "port"),
                       (ref_events, tmp_path / "ref")):
            monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d))
            rec = mod.reset()
            for i in range(100):
                rec.event("e", i=i)
            path = d / "events_rank0.jsonl"
            recs = [json.loads(ln) for ln in path.read_text().splitlines()]
            assert recs[-1]["name"] == "event_stream_truncated"
            assert len(recs) < 100
            assert len(rec.tail()) > len(recs)
            size = path.stat().st_size
            rec.event("after")
            assert path.stat().st_size == size
            rec.close()
            counts.append(len(recs))
        assert counts[0] == counts[1]

    def test_stream_cap_survives_recorder_reset(self, tmp_path,
                                                monkeypatch):
        monkeypatch.setenv("SPARKDL_EVENT_DIR", str(tmp_path))
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        monkeypatch.setenv("SPARKDL_EVENT_MAX_MB", "0.0005")
        rec = events.reset()
        for i in range(100):
            rec.event("e", i=i)
        size = (tmp_path / "events_rank0.jsonl").stat().st_size
        rec2 = events.reset()  # fresh recorder, same dir, same file
        for i in range(100):
            rec2.event("e", i=i)
        assert (tmp_path / "events_rank0.jsonl").stat().st_size == size

    def test_enable_flight_recorder(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        # setenv first so monkeypatch restores the pre-test absence
        monkeypatch.setenv("SPARKDL_EVENT_DIR", "overwritten")
        monkeypatch.setenv("SPARKDL_EVENT_RING", "overwritten")
        from sparkdl_tpu_torch.runner.api import enable_flight_recorder
        rec = enable_flight_recorder(str(tmp_path), ring_size=32)
        assert os.environ["SPARKDL_EVENT_DIR"] == str(tmp_path)
        assert os.environ["SPARKDL_EVENT_RING"] == "32"
        rec.event("hello")
        assert (tmp_path / "events_rank0.jsonl").exists()
        assert rec.ring.maxlen == 32

    def test_timer_is_the_span_primitive(self):
        from sparkdl_tpu_torch.utils import Timer
        from sparkdl_tpu_torch.utils.timing import Timer as T2
        assert Timer is events.Timer is T2
        with Timer() as t:
            time.sleep(0.002)
        assert t.seconds >= 0.002
        assert issubclass(type(events.span("x")), Timer)
        # waiting on CPU tensors needs no device: it returns at once
        with Timer(block_on={"a": torch.ones(2), "b": [torch.zeros(1)]}):
            pass


# --- TestStepTimeStats -------------------------------------------------------

class TestStepTimeStats:
    def test_percentiles_on_synthetic_sequence(self):
        sums = []
        for cls in (StepTimeStats, ref_metrics.StepTimeStats):
            st = cls()
            for ms in range(1, 101):
                st.record(ms / 1000.0)
            s = st.summary()
            assert s["n"] == 100
            assert s["p50_s"] == pytest.approx(0.050)
            assert s["p95_s"] == pytest.approx(0.095)
            assert s["p99_s"] == pytest.approx(0.099)
            assert s["max_s"] == pytest.approx(0.100)
            assert s["mean_s"] == pytest.approx(0.0505)
            sums.append(s)
        assert sums[0] == sums[1]

    def test_reservoir_bounds_memory_keeps_max_exact(self):
        got = []
        for cls in (StepTimeStats, ref_metrics.StepTimeStats):
            st = cls(capacity=50)
            for i in range(1000):
                st.record(0.001 * (i % 97 + 1))
            assert len(st._sample) == 50
            assert st.count == 1000
            assert st.summary()["max_s"] == pytest.approx(0.097)
            assert 0.001 <= st.percentile(50) <= 0.097
            got.append((st._sample, st.percentile(50), st.summary()))
        assert got[0] == got[1]  # the same seeded reservoir

    def test_meter_summary_carries_percentiles_and_mfu(self, monkeypatch):
        out = []
        for cls in (ThroughputMeter, ref_metrics.ThroughputMeter):
            monkeypatch.delenv("SPARKDL_PEAK_FLOPS", raising=False)
            m = cls(n_chips=4, warmup_steps=0)
            for _ in range(10):
                m.step_stats.record(0.1)
            assert m.summary()["mfu"] is None  # FLOPs unknown: null
            monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "1e12")
            m.flops_per_step = 4e10  # 4e10 / 0.1 s / (1e12 · 4 chips)
            s = m.summary()
            assert s["mfu"] == pytest.approx(0.1)
            assert s["step_time"]["p50_s"] == pytest.approx(0.1)
            out.append(s)
        assert set(out[0]) == set(out[1])
        assert out[0]["step_time"] == out[1]["step_time"]
        assert out[0]["mfu"] == out[1]["mfu"]

    def test_fit_populates_step_time(self):
        counts = []
        for run, fit, mod in ((_port_run, _fit, metrics_lib),
                              (_ref_run, _jax_fit, ref_metrics)):
            res = run(fit)
            s = res["meter"].summary()
            assert s["step_time"]["n"] == 3  # 4 steps - 1 warmup
            assert s["step_time"]["p99_s"] >= s["step_time"]["p50_s"] > 0
            assert s["mfu"] is None
            counts.append(mod.global_step_stats.count)
        assert counts == [3, 3]

    def test_fit_mfu_from_flops_per_step(self, monkeypatch):
        """A FLOP count given to ``fit`` gives the MFU in both packages
        (without one, ``SPARKDL_MFU_ESTIMATE`` counts it: TestFlopEstimate
        below)."""
        monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "1e12")
        for run, fit in ((_port_run, _fit), (_ref_run, _jax_fit)):
            m = run(lambda ctx: fit(ctx, flops_per_step=1e6))["meter"]
            assert m.flops_per_step == 1e6
            assert m.summary()["mfu"] is not None


# --- TestFlopEstimate --------------------------------------------------------
#
# SPARKDL_MFU_ESTIMATE: the reference asks XLA's cost analysis for the
# step's FLOPs, the port counts the first step's aten ops
# (FlopCounterMode) and its kernels' own reports (utils.flops).

MLP_BATCH, MLP_IN, MLP_HIDDEN, MLP_OUT = 256, 512, 1024, 10


class MLP(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        for k, v in p.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(MLP_IN, MLP_HIDDEN) / np.sqrt(MLP_IN)
                   ).astype(np.float32),
            "b1": np.zeros(MLP_HIDDEN, np.float32),
            "w2": (rng.randn(MLP_HIDDEN, MLP_OUT) / np.sqrt(MLP_HIDDEN)
                   ).astype(np.float32),
            "b2": np.zeros(MLP_OUT, np.float32)}


def _mlp_data(n=2, seed=1):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(MLP_BATCH, MLP_IN).astype(np.float32),
             "label": rng.randint(0, MLP_OUT, MLP_BATCH)} for _ in range(n)]


def _mlp_port_fit(ctx):
    return ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                   model=MLP(_mlp_params()), tx=sgd(0.1), data=_mlp_data(),
                   num_steps=2, log_every=1)


def _mlp_jax_fit(ctx):
    def apply(p, x):
        return jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return ctx.fit(loss_fn=jax_sce(), params=_mlp_params(),
                   tx=optax.sgd(0.1), apply_fn=apply, data=_mlp_data(),
                   num_steps=2, log_every=1)


def _live_pairs(mask, causal):
    """Live (query row, key) pairs by brute force: key col is live for
    row when mask[b, col] > 0 and, causal, col <= row."""
    b, s = mask.shape
    return sum(1 for i in range(b) for row in range(s) for col in range(s)
               if mask[i, col] > 0 and (not causal or col <= row))


class TestFlopEstimate:
    def test_mlp_estimate_matches_xla_cost_analysis(self, monkeypatch):
        """(a) A model whose FLOPs are matmuls: the port's estimate is the
        step's matmuls exactly (the forward's two, then dW1, dW2 and dH;
        the input takes no gradient), at most the reference's and within
        1 % of it: XLA also counts the bias adds, the ReLU, the softmax
        and SGD's update (measured 552,599,552 against 555,040,512,
        0.44 % apart)."""
        monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", "1")
        port = _port_run(_mlp_port_fit)["meter"].flops_per_step
        ref = _ref_run(_mlp_jax_fit)["meter"].flops_per_step
        b, i, h, o = MLP_BATCH, MLP_IN, MLP_HIDDEN, MLP_OUT
        assert port == 2 * (2 * b * i * h + 3 * b * h * o)
        assert port <= ref
        assert (ref - port) / ref < 0.01, (port, ref)

    @pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                          ("1", True), ("true", True),
                                          ("YES ", True), ("on", False)])
    def test_knob_truth_table(self, monkeypatch, value, on):
        """(d) Twin of tests/test_events.py's cost-analysis test: the
        knob's truth table is the reference's (``1``, ``true``, ``yes``
        on; ``0``, unset and the rest off). On, both packages set the
        meter's FLOPs and MFU; off, both stay None."""
        monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "1e12")
        if value is not None:
            monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", value)
        for run, fit in ((_port_run, _fit), (_ref_run, _jax_fit)):
            m = run(fit)["meter"]
            mfu = m.summary()["mfu"]
            if on:
                assert m.flops_per_step > 0 and mfu is not None
            else:
                assert m.flops_per_step is None and mfu is None

    def test_counted_step_changes_nothing_and_emits_the_event(
            self, monkeypatch):
        """The count comes from the first step as it runs, no extra step:
        the fit's losses and parameters equal an uncounted fit's bit for
        bit; ``flops_estimate`` follows ``compile`` with the count and the
        step's wall time; the counted step stays out of the step times."""
        out = []
        for value in ("1", "0"):
            monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", value)
            rec = events.reset()
            res = _port_run(_mlp_port_fit)
            names = [e["name"] for e in rec.tail()]
            est = [e for e in rec.tail() if e["name"] == "flops_estimate"]
            if value == "1":
                assert est and est[0]["flops"] == \
                    res["meter"].flops_per_step and est[0]["dur_s"] > 0
                assert names.index("compile") < names.index("flops_estimate")
            else:
                assert not est
            assert res["state"].step == 2
            assert res["meter"].summary()["step_time"]["n"] == 1
            out.append(([h["loss"] for h in res["history"]],
                        {k: v.clone() for k, v in
                         res["state"].model.state_dict().items()}))
        assert out[0][0] == out[1][0]
        for k, v in out[0][1].items():
            assert torch.equal(v, out[1][1][k]), k

    def test_a_count_of_zero_leaves_the_mfu_null(self, monkeypatch):
        """A step without a counted op (an elementwise model) counts 0:
        ``flops_per_step`` stays None and MFU null, as the reference's
        ``or None``."""
        class Scale(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Parameter(torch.ones(4))

            def forward(self, x):
                return x * self.w

        monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", "1")
        monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "1e12")
        data = [{"image": np.ones((2, 4), np.float32),
                 "label": np.zeros(2, np.int64)}] * 2
        m = _port_run(lambda ctx: ctx.fit(
            loss_fn=softmax_cross_entropy_loss(), model=Scale(),
            tx=sgd(0.1), data=data, num_steps=2))["meter"]
        assert m.flops_per_step is None and m.summary()["mfu"] is None

    @pytest.mark.parametrize("value,want", [(None, 0), ("2", 2)])
    def test_feed_lookahead_knob_is_the_default(self, monkeypatch, value,
                                                want):
        """``SPARKDL_FEED_LOOKAHEAD`` is ``fit(feed_lookahead=)``'s
        default, 0 unset, as in the reference; an explicit argument
        wins."""
        from sparkdl_tpu_torch.runner import xla_runner

        seen = []
        staged = xla_runner._staged

        def spy(ctx, data_it, crop, limit, start_step, lookahead):
            seen.append(lookahead)
            return staged(ctx, data_it, crop, limit, start_step, lookahead)

        monkeypatch.setattr(xla_runner, "_staged", spy)
        if value is not None:
            monkeypatch.setenv("SPARKDL_FEED_LOOKAHEAD", value)
        losses = [[h["loss"] for h in _port_run(
            lambda ctx: _fit(ctx, log_every=1, **kw))["history"]]
            for kw in ({}, {"feed_lookahead": 1})]
        assert seen == [want, 1]
        assert losses[0] == losses[1]

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("case", ["causal", "padded", "causal_padded"])
    def test_flash_count_is_the_formula_once(self, case, d):
        """(c) Under the counter the flash wrappers report 2·D FLOPs a
        product for each live (row, key) pair and head, 2 products
        forward and 5 backward, counted from the mask by brute force
        here; exactly, so the plain version's matmuls, which the mode
        sees on the CPU, are left out."""
        from sparkdl_tpu_torch.ops import flash_attention as fa
        from sparkdl_tpu_torch.utils.flops import count_flops

        b, h, s = 2, 3, 24
        causal = case.startswith("causal")
        mask = None
        if case.endswith("padded"):
            m = np.ones((b, s), np.float32)
            m[0, 17:] = 0          # right pads
            m[1, :5] = 0           # left pads
            mask = torch.from_numpy(m)
        g = torch.Generator().manual_seed(d)
        q, k, v = (torch.randn(b, h, s, d, generator=g, requires_grad=True)
                   for _ in range(3))
        pairs = _live_pairs(np.ones((b, s)) if mask is None
                            else mask.numpy(), causal)
        per_product = 2 * d * h * pairs
        with count_flops() as fwd:
            fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                   causal, kv_mask=mask)
        assert fwd.total == 2 * per_product
        with count_flops() as both:
            o = fa.flash_attention(q, k, v, causal, kv_mask=mask)
            (o * o.detach()).sum().backward()
        assert both.total == both.kernel_flops == 7 * per_product
        # the plain versions' matmuls were seen by the mode, then left out
        assert both.mode.get_total_flops() > both.total

# --- TestPostmortem ----------------------------------------------------------

class TestPostmortem:
    def test_fit_failure_writes_postmortem(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        pms = []
        for run, fit, ch, ev, d in (
                (_port_run, _fit, chaos, events, tmp_path / "port"),
                (_ref_run, _jax_fit, ref_chaos, ref_events,
                 tmp_path / "ref")):
            monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d))
            ev.reset()
            ch.install(ch.FaultPlan([ch.Fault("step_start", "preempt",
                                              at_step=2)]))
            with pytest.raises(Exception, match="UNAVAILABLE"):
                run(fit)
            ch.uninstall()
            ev.get_recorder().close()
            pm = json.loads((d / "postmortem_rank0.json").read_text())
            assert pm["error"]["type"] == "InjectedPreemption"
            assert pm["error"]["kind"] == "retryable"
            assert pm["site"] == "fit" and pm["step"] == 2
            names = {e["name"] for e in pm["events"]}
            assert {"fit_start", "chaos", "step_compute", "compile",
                    "data_fetch", "shard_put"} <= names
            lines = (d / "events_rank0.jsonl").read_text().splitlines()
            assert any(json.loads(ln)["name"] == "chaos" for ln in lines)
            pms.append(pm)
        port, ref = pms
        assert set(port) == set(ref)
        for k in ("site", "step", "batch_index", "epoch", "rank"):
            assert port[k] == ref[k], k
        assert {k: port["error"][k] for k in ("type", "kind")} == \
            {k: ref["error"][k] for k in ("type", "kind")}

    def test_chaos_fire_lands_in_trace(self):
        rec = events.reset()
        chaos.install(FaultPlan([Fault("batch_fetch", "nan", at_step=0)]))
        chaos.fire("batch_fetch", step=0,
                   batch={"x": np.ones(3, np.float32)})
        ev = [e for e in rec.tail() if e["name"] == "chaos"]
        assert ev and ev[0]["site"] == "batch_fetch" \
            and ev[0]["kind"] == "nan" and ev[0]["step"] == 0

    def test_run_with_restarts_keeps_fits_step_bearing_record(
            self, tmp_path, monkeypatch):
        """A fatal failure inside ``fit`` keeps fit's postmortem (site
        ``fit``, its step); one outside ``fit`` gets a step-less one (site
        ``run_with_restarts``) — in both packages."""
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        for runner, fit, ch, ev, d in (
                (XlaRunner(device="cpu"), _fit, chaos, events,
                 tmp_path / "port"),
                (JaxRunner(np=1), _jax_fit, ref_chaos, ref_events,
                 tmp_path / "ref")):
            monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d))
            ev.reset()
            ch.install(ch.FaultPlan([ch.Fault("step_start", "fatal",
                                              at_step=1)]))
            with pytest.raises(ch.InjectedFatal):
                runner.run_with_restarts(fit, max_restarts=2, backoff_s=0)
            ch.uninstall()
            pm = json.loads((d / "postmortem_rank0.json").read_text())
            assert (pm["site"], pm["step"]) == ("fit", 1)

            def outside(ctx):
                raise ValueError("bad config")

            with pytest.raises(ValueError):
                runner.run_with_restarts(outside, backoff_s=0)
            pm = json.loads((d / "postmortem_rank0.json").read_text())
            assert pm["site"] == "run_with_restarts" and "step" not in pm
            assert pm["kind"] == "fatal" and pm["attempt"] == 1


# --- TestOverheadBounded -----------------------------------------------------

class TestOverheadBounded:
    def test_recorder_off_is_ring_only_no_sync(self, tmp_path, monkeypatch):
        """With ``SPARKDL_EVENT_DIR`` unset a recorded fit does no event
        I/O and reads nothing more from the device than the one metrics
        read of its last step; with the recorder streaming, the heartbeat
        and the ledger on, it reads exactly as much (none of them waits
        for the device)."""
        reads, syncs = [], []
        real_float = torch.Tensor.__float__
        monkeypatch.setattr(torch.Tensor, "__float__",
                            lambda t: (reads.append(1), real_float(t))[1])
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: syncs.append(1))
        rec = events.reset()
        res = _port_run(_fit)
        assert int(res["state"].step) == 4
        off = len(reads)
        # one read a metric of the last step, nothing else
        assert off == len([k for k in res["history"][-1]
                           if k not in ("step", "examples_per_sec_per_chip")])
        assert rec._file is None
        assert list(tmp_path.iterdir()) == []
        assert any(e["name"] == "step_compute" for e in rec.tail())
        for k, sub in (("SPARKDL_EVENT_DIR", "ev"),
                       ("SPARKDL_HEARTBEAT_DIR", "hb"),
                       ("SPARKDL_BATCH_LEDGER", "led")):
            monkeypatch.setenv(k, str(tmp_path / sub))
        events.reset()
        reads.clear()
        _port_run(lambda ctx: ctx.fit(
            loss_fn=softmax_cross_entropy_loss(),
            model=Linear(_params()["w"]), tx=sgd(0.1),
            data=list(_data(n_batches=4)), num_steps=4, log_every=100))
        assert len(reads) == off
        assert syncs == []
        assert (tmp_path / "ev" / "events_rank0.jsonl").exists()
        assert (tmp_path / "hb" / "rank0.hb").exists()
        assert (tmp_path / "led" / "ledger_rank0.jsonl").exists()


# --- TestMergeTimeline -------------------------------------------------------

def _write(d, rank, recs):
    with open(os.path.join(d, f"events_rank{rank}.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _both_timelines(d, **kw):
    """merge_timeline of one directory through both packages: they must
    be equal; the port's is returned."""
    port = events.merge_timeline(d, **kw)
    assert port == ref_events.merge_timeline(d, **kw)
    assert events.format_timeline(port) == ref_events.format_timeline(port)
    return port


class TestMergeTimeline:
    def test_merged_order_and_first_failure(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 100.0, "name": "step_compute", "ph": "B", "rank": 0,
             "step": 0},
            {"t": 101.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 1},
            {"t": 102.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 2},
        ])
        _write(d, 1, [
            {"t": 100.1, "name": "step_compute", "ph": "E", "rank": 1,
             "step": 0},
            {"t": 100.6, "name": "chaos", "ph": "P", "rank": 1,
             "site": "step_start", "kind": "preempt", "step": 1},
        ])
        with open(os.path.join(d, "postmortem_rank1.json"), "w") as f:
            json.dump({"t": 100.7, "rank": 1, "site": "fit", "step": 1,
                       "error": {"type": "InjectedPreemption",
                                 "kind": "retryable",
                                 "message": "UNAVAILABLE: injected"}}, f)
        hb = tmp_path / "hb"
        hb.mkdir()
        (hb / "rank0.hb").write_text(json.dumps({"step": 2, "time": 102.0}))
        tl = _both_timelines(d, heartbeat_dir=str(hb))
        assert tl["first_failing_rank"] == 1
        assert tl["first_failure"]["site"] == "step_start"
        assert tl["first_failure"]["step"] == 1
        assert tl["ranks"]["1"]["last_step"] == 1
        assert tl["ranks"]["0"]["last_step"] == 2
        assert tl["ranks"]["0"]["heartbeat"]["step"] == 2
        assert tl["first_stalled_rank"] == 1
        ts = [e["t"] for e in tl["events"]]
        assert ts == sorted(ts)
        text = events.format_timeline(tl)
        assert "rank 1" in text and "step_start" in text

    def test_finished_rank_does_not_mask_real_failure(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 100.0, "name": "data_fetch", "ph": "E", "rank": 0,
             "step": 5, "end_of_data": True, "dur_s": 0.001},
        ])
        _write(d, 1, [
            {"t": 101.0, "name": "chaos", "ph": "P", "rank": 1,
             "site": "step_start", "kind": "preempt", "step": 4},
        ])
        tl = _both_timelines(d)
        assert tl["first_failing_rank"] == 1
        assert tl["first_failure"]["site"] == "step_start"

    def test_recovered_restart_does_not_outrank_terminal_fault(
            self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 100.0, "name": "restart", "ph": "P", "rank": 0,
             "attempt": 1, "kind": "retryable",
             "error": "RuntimeError: UNAVAILABLE (recovered)"},
            {"t": 150.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 40, "dur_s": 0.01},
        ])
        _write(d, 1, [
            {"t": 140.0, "name": "chaos", "ph": "P", "rank": 1,
             "site": "step_start", "kind": "fatal", "step": 30},
        ])
        tl = _both_timelines(d)
        assert tl["first_failing_rank"] == 1
        assert tl["first_failure"]["site"] == "step_start"
        os.unlink(os.path.join(d, "events_rank1.jsonl"))
        tl = _both_timelines(d)
        assert tl["first_failing_rank"] == 0
        assert tl["first_failure"].get("recovered") is True

    def test_recovered_attempts_chaos_evidence_is_demoted_too(
            self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 100.0, "name": "chaos", "ph": "P", "rank": 0,
             "site": "step_start", "kind": "preempt", "step": 3},
            {"t": 100.5, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 3, "dur_s": 0.01,
             "error": "InjectedPreemption: UNAVAILABLE"},
            {"t": 101.0, "name": "restart", "ph": "P", "rank": 0,
             "attempt": 1, "kind": "retryable",
             "error": "InjectedPreemption: UNAVAILABLE"},
        ])
        _write(d, 1, [
            {"t": 140.0, "name": "chaos", "ph": "P", "rank": 1,
             "site": "step_start", "kind": "fatal", "step": 30},
        ])
        tl = _both_timelines(d)
        assert tl["first_failing_rank"] == 1
        assert tl["first_failure"]["step"] == 30
        assert "recovered" not in tl["first_failure"]

    def test_hang_outranks_recovered_error_for_attribution(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 150.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 5, "dur_s": 0.01},
        ])
        _write(d, 1, [
            {"t": 100.0, "name": "restart", "ph": "P", "rank": 1,
             "attempt": 1, "kind": "retryable",
             "error": "RuntimeError: UNAVAILABLE (recovered)"},
            {"t": 190.0, "name": "step_compute", "ph": "E", "rank": 1,
             "step": 30, "dur_s": 0.01},
        ])
        tl = _both_timelines(d)
        assert tl["first_failing_rank"] == 0
        assert tl["first_stalled_rank"] == 0
        text = events.format_timeline(tl)
        assert "rank 0 stalled first" in text
        assert "recovered in-process" in text

    def test_stall_pick_consults_heartbeats(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [{"t": 100.0, "name": "step_compute", "ph": "E",
                       "rank": 0, "step": 1, "dur_s": 0.01}])
        _write(d, 1, [{"t": 200.0, "name": "step_compute", "ph": "E",
                       "rank": 1, "step": 50, "dur_s": 0.01}])
        hb = tmp_path / "hb"
        hb.mkdir()
        (hb / "rank0.hb").write_text(
            json.dumps({"step": 300, "time": 500.0}))
        tl = _both_timelines(d, heartbeat_dir=str(hb))
        assert tl["first_stalled_rank"] == 1

    def test_empty_dir_yields_no_ranks(self, tmp_path):
        tl = _both_timelines(str(tmp_path))
        assert tl["ranks"] == {} and tl["first_failing_rank"] is None

    def test_clear_rank_files_globs_all_ranks(self, tmp_path):
        d = str(tmp_path)
        _write(d, 7, [{"t": 1.0, "name": "chaos", "ph": "P",
                       "rank": 7, "site": "worker", "kind": "fatal"}])
        (tmp_path / "postmortem_rank7.json").write_text("{}")
        (tmp_path / events.TRACE_MANIFEST_FILE).write_text("{}")
        events.clear_rank_files(d)
        # the trace manifest is not a rank file: it stays
        assert [p.name for p in tmp_path.iterdir()] == \
            [events.TRACE_MANIFEST_FILE]
        assert events.TRACE_MANIFEST_FILE == ref_events.TRACE_MANIFEST_FILE

    def test_last_step_ignores_prefetch_feed_events(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, [
            {"t": 1.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 10, "dur_s": 0.01},
            {"t": 1.1, "name": "data_fetch", "ph": "E", "rank": 0,
             "step": 14, "dur_s": 0.001},
        ])
        tl = _both_timelines(d)
        assert tl["ranks"]["0"]["last_step"] == 10

    def test_clear_rank_files_removes_stale_gang_timeline(self, tmp_path):
        assert events.GANG_TIMELINE_FILE == ref_events.GANG_TIMELINE_FILE
        path = events.write_gang_postmortem(str(tmp_path), {"ranks": {}})
        assert os.path.basename(path) == events.GANG_TIMELINE_FILE
        events.clear_rank_files(str(tmp_path))
        assert list(tmp_path.iterdir()) == []

    def test_torn_tail_line_is_skipped(self, tmp_path):
        d = str(tmp_path)
        with open(os.path.join(d, "events_rank0.jsonl"), "w") as f:
            f.write(json.dumps({"t": 1.0, "name": "a", "ph": "P",
                                "rank": 0, "step": 5}) + "\n")
            f.write('{"t": 2.0, "name": "tru')  # killed mid-write
        tl = _both_timelines(d)
        assert tl["ranks"]["0"]["n_events"] == 1
        assert tl["ranks"]["0"]["last_step"] == 5

    def test_timeline_of_a_real_failed_fit(self, tmp_path, monkeypatch):
        """A port fit that fails at step 2 under a streaming recorder:
        the timeline names rank 0, the chaos site and the step, equal
        through both packages' readers."""
        monkeypatch.setenv("SPARKDL_EVENT_DIR", str(tmp_path))
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        events.reset()
        chaos.install(FaultPlan([Fault("step_start", "preempt", at_step=2)]))
        with pytest.raises(chaos.InjectedPreemption):
            _port_run(_fit)
        events.get_recorder().close()
        tl = _both_timelines(str(tmp_path))
        assert tl["first_failing_rank"] == 0
        ff = tl["first_failure"]
        assert (ff["site"], ff["step"]) == ("step_start", 2)
        assert tl["ranks"]["0"]["postmortem"]["step"] == 2


# --- TestHeartbeatSatellite --------------------------------------------------

class TestHeartbeatSatellite:
    def test_touch_heartbeat_is_atomic_json(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "2")
        bodies = []
        for mod, d in ((metrics_lib, tmp_path / "port"),
                       (ref_metrics, tmp_path / "ref")):
            monkeypatch.setenv("SPARKDL_HEARTBEAT_DIR", str(d))
            t0 = time.time()
            mod.touch_heartbeat(7)
            body = json.loads((d / "rank2.hb").read_text())
            assert body["step"] == 7
            assert t0 - 1 <= body["time"] <= time.time() + 1
            assert [p.name for p in d.iterdir()] == ["rank2.hb"]
            bodies.append(set(body))
        assert bodies[0] == bodies[1]

    def test_watchdog_parses_json_and_legacy_bodies(self, tmp_path,
                                                    monkeypatch):
        """The port's heartbeat body read by both packages' watchdogs
        (``launcher._heartbeat_ages``: the same steps, a rank that never
        beat absent), and both bodies through both packages' decoders."""
        monkeypatch.setenv("SPARKDL_HEARTBEAT_DIR", str(tmp_path))
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        metrics_lib.touch_heartbeat(12)
        (tmp_path / "rank1.hb").write_text("34")  # a bare-step body
        now = time.time()
        ages = ref_launcher._heartbeat_ages(str(tmp_path), 3, now)
        assert ages[0][1] == "12"
        assert ages[1][1] == "34"
        assert 2 not in ages
        assert port_launcher._heartbeat_ages(str(tmp_path), 3, now) == ages
        for body in ((tmp_path / "rank0.hb").read_text(), "34", ""):
            assert events.parse_heartbeat_body(body) == \
                ref_events.parse_heartbeat_body(body)
        hb = events._read_heartbeat(str(tmp_path / "rank0.hb"))
        assert hb["step"] == 12 and hb["mtime"] > 0
        assert events._read_heartbeat(str(tmp_path / "none.hb")) is None


# --- TestMetricsLoggerSatellite ----------------------------------------------

def _logged(caplog, logger_name, fn):
    caplog.clear()
    with caplog.at_level("INFO", logger=logger_name):
        fn()
    return [r.getMessage() for r in caplog.records
            if r.name == logger_name]


class TestMetricsLoggerSatellite:
    """The port's text line: each twin holds it to the reference's,
    with TensorBoard absent or beside it (``TestMetricsLoggerTensorBoard``
    reads the event files back)."""

    def test_tb_unavailable_falls_back_to_log(self, tmp_path, monkeypatch,
                                              caplog):
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        ref = ref_metrics.MetricsLogger(str(tmp_path / "tb"))
        assert ref._tb is None
        want = _logged(caplog, "sparkdl_tpu.runner",
                       lambda: ref.log(1, {"loss": 0.5}))
        got = _logged(caplog, "sparkdl_tpu_torch.runner",
                      lambda: MetricsLogger().log(1, {"loss": 0.5}))
        assert got == want and "loss" in got[0]
        ref.close()

    def test_non_numeric_values_do_not_crash(self, caplog):
        m = {"loss": np.float32(1.5), "note": "warmup", "arr": np.ones(3)}
        want = _logged(caplog, "sparkdl_tpu.runner",
                       lambda: ref_metrics.MetricsLogger(None).log(2, m))
        got = _logged(caplog, "sparkdl_tpu_torch.runner",
                      lambda: MetricsLogger().log(
                          2, dict(m, t=torch.tensor(2.5))))
        assert "warmup" in got[0]
        assert json.loads(got[0].split(" ", 2)[2]) == dict(
            json.loads(want[0].split(" ", 2)[2]), t=2.5)

    def test_close_is_idempotent(self, monkeypatch, caplog):
        """Both packages close their writer once however often they are
        closed and then keep logging the same text line."""
        closes = []

        class _FakeWriter:
            def __init__(self, log_dir):
                pass

            def add_scalar(self, *a):
                pass

            def close(self):
                closes.append(1)

        fake = types.ModuleType("tensorboardX")
        fake.SummaryWriter = _FakeWriter
        monkeypatch.setitem(sys.modules, "tensorboardX", fake)
        ref = ref_metrics.MetricsLogger("tb")
        ref.close()
        ref.close()
        assert closes == [1] and ref._tb is None
        port = MetricsLogger("tb")
        port.close()
        port.close()
        assert closes == [1, 1] and port._tb is None
        want = _logged(caplog, "sparkdl_tpu.runner",
                       lambda: ref.log(1, {"loss": 1.0}))
        got = _logged(caplog, "sparkdl_tpu_torch.runner",
                      lambda: port.log(1, {"loss": 1.0}))
        assert got == want

    def test_log_summary_flattens_nested_blocks(self, caplog):
        summ = {"examples_per_sec": 5.0, "mfu": None,
                "step_time": {"p50_s": 0.1},
                "fault_tolerance": {"checkpoint_rollbacks": 1}}
        want = _logged(caplog, "sparkdl_tpu.runner",
                       lambda: ref_metrics.MetricsLogger(None)
                       .log_summary(10, summ))
        got = _logged(caplog, "sparkdl_tpu_torch.runner",
                      lambda: MetricsLogger().log_summary(10, summ))
        assert got == want
        assert "step_time_p50_s" in got[0]
        assert "fault_tolerance_checkpoint_rollbacks" in got[0]
        assert "mfu" not in got[0]


# tensorboard reads its files without TensorFlow where this module
# imports (its no-TensorFlow build's switch): TensorFlow, where installed,
# would take seconds to import and stay in the test process
_NO_TF = {"tensorboard.compat.notf": types.ModuleType(
    "tensorboard.compat.notf")}


def _tb_scalars(log_dir) -> dict:
    """``{tag: [(step, value), ...]}`` of every event file under
    ``log_dir``, read with tensorboard's own reader."""
    from pathlib import Path
    from unittest import mock

    with mock.patch.dict(sys.modules, _NO_TF):
        from tensorboard.backend.event_processing.event_file_loader \
            import EventFileLoader
        from tensorboard.util import tensor_util

        out: dict = {}
        for f in sorted(Path(log_dir).glob("events.out.tfevents.*")):
            for ev in EventFileLoader(str(f)).Load():
                for v in ev.summary.value:
                    out.setdefault(v.tag, []).append(
                        (ev.step, tensor_util.make_ndarray(v.tensor).item()))
    return out


_F32 = lambda v: float(np.float32(v))  # noqa: E731 — TensorBoard's scalars


class TestMetricsLoggerTensorBoard:
    """``MetricsLogger(log_dir)`` writes TensorBoard event files, through
    tensorboardX, else ``torch.utils.tensorboard``, read back here with
    tensorboard's reader; without either it warns once and logs text."""

    def test_scalars_read_back(self, tmp_path, caplog):
        d = tmp_path / "tb"
        m = MetricsLogger(str(d))
        got = _logged(caplog, "sparkdl_tpu_torch.runner", lambda: (
            m.log(1, {"loss": 0.5, "acc": np.float32(0.25),
                      "t": torch.tensor(2.5), "note": "warmup",
                      "arr": np.ones(3)}),
            m.log(2, {"loss": 0.125}),
            m.log_summary(3, {"step_time": {"p50_s": 0.1}, "mfu": None})))
        m.close()
        assert len(got) == 3 and "warmup" in got[0]
        assert _tb_scalars(d) == {
            "loss": [(1, 0.5), (2, 0.125)], "acc": [(1, 0.25)],
            "t": [(1, 2.5)], "step_time_p50_s": [(3, _F32(0.1))]}

    def test_torch_writer_when_tensorboardx_is_absent(self, tmp_path):
        """With tensorboardX blocked the same files come from
        ``torch.utils.tensorboard`` (in a subprocess, so the block holds
        from its first import)."""
        d = tmp_path / "tb"
        code = (
            "import sys, types; sys.modules['tensorboardX'] = None\n"
            "sys.modules['tensorboard.compat.notf'] = "
            "types.ModuleType('notf')\n"
            "from sparkdl_tpu_torch.runner.metrics import MetricsLogger\n"
            f"m = MetricsLogger({str(d)!r})\n"
            "assert type(m._tb).__module__.startswith('torch.utils')\n"
            "m.log(1, {'loss': 0.5}); m.log(2, {'loss': 0.125})\n"
            "m.close()\n")
        import subprocess
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             os.environ.get("PYTHONPATH", "")]))
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       capture_output=True, timeout=120)
        assert _tb_scalars(d) == {"loss": [(1, 0.5), (2, 0.125)]}

    def test_no_writer_warns_once_and_logs_text(self, tmp_path,
                                                monkeypatch, caplog):
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        monkeypatch.setattr(metrics_lib, "_TB_WARNED", [])
        with caplog.at_level("WARNING", logger="sparkdl_tpu_torch.runner"):
            loggers = [MetricsLogger(str(tmp_path / f"tb{i}"))
                       for i in range(2)]
        warned = [r for r in caplog.records if "tensorboard" in
                  r.getMessage().lower()]
        assert len(warned) == 1
        assert all(m._tb is None for m in loggers)
        got = _logged(caplog, "sparkdl_tpu_torch.runner",
                      lambda: loggers[0].log(1, {"loss": 0.5}))
        assert "loss" in got[0]
        assert not list(tmp_path.glob("tb*/events.*"))

    def test_fit_writes_its_losses(self, tmp_path):
        """``XlaRunner(log_dir=)``: ``fit`` writes each logged step's
        metrics and the summary to TensorBoard."""
        d = tmp_path / "tb"
        res = XlaRunner(device="cpu", log_dir=str(d)).run(
            lambda ctx: _fit(ctx, num_steps=3, log_every=1))
        got = _tb_scalars(d)
        assert got["loss"] == [(h["step"], _F32(h["loss"]))
                               for h in res["history"]]
        assert [s for s, _ in got["loss"]] == [1, 2, 3]
        assert "examples_per_sec" in got or "steps" in got

    def test_trace_defaults_to_the_log_dir(self, fake_profiler, tmp_path):
        """``ctx.trace()`` with no directory traces into the runner's
        ``log_dir``, as the reference's."""
        d = str(tmp_path / "tb")
        rec = events.reset()
        with XlaRunner(device="cpu", log_dir=d).make_context().trace():
            pass
        ev = [e for e in rec.tail() if e["name"] == "profile_trace"]
        assert ev[0]["trace_dir"] == d
        assert JaxRunner(np=1, log_dir=d).make_context().log_dir == d


# --- TestTraceSatellite ------------------------------------------------------

class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: records start and stop,
    and its stop raises ``stop_error`` when set."""
    calls: list = []
    stop_error = None

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        _FakeProfile.calls.append("start")
        return self

    def __exit__(self, *a):
        _FakeProfile.calls.append("stop")
        if _FakeProfile.stop_error is not None:
            raise _FakeProfile.stop_error

    def export_chrome_trace(self, path):
        _FakeProfile.calls.append("export")


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.calls = []
    _FakeProfile.stop_error = None
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    yield _FakeProfile
    metrics_lib._PROFILERS.clear()


class TestTraceSatellite:
    def test_region_failure_still_stops_profiler(self, fake_profiler,
                                                 tmp_path):
        fake_profiler.stop_error = RuntimeError("profiler broke")
        with pytest.raises(ValueError, match="user bug"):
            with metrics_lib.trace(str(tmp_path)):
                raise ValueError("user bug")
        assert fake_profiler.calls == ["start", "stop"]
        assert not metrics_lib._PROFILERS

    def test_stop_error_propagates_when_region_succeeded(self,
                                                         fake_profiler,
                                                         tmp_path):
        fake_profiler.stop_error = RuntimeError("profiler broke")
        with pytest.raises(RuntimeError, match="profiler broke"):
            with metrics_lib.trace(str(tmp_path)):
                pass
        with pytest.raises(RuntimeError, match="no profiler trace"):
            metrics_lib.stop_profiler_trace()
        metrics_lib.stop_profiler_trace(failed=True)  # logged, not raised

    def test_trace_emits_event_with_dir(self, fake_profiler, monkeypatch,
                                        tmp_path):
        rec = events.reset()
        d = str(tmp_path / "trace")
        with XlaRunner(device="cpu").make_context().trace(d):
            pass
        assert fake_profiler.calls == ["start", "stop", "export"]
        ev = [e for e in rec.tail() if e["name"] == "profile_trace"]
        monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
        monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
        ref_rec = ref_events.reset()
        with JaxRunner(np=1).make_context().trace(d):
            pass
        want = [e for e in ref_rec.tail() if e["name"] == "profile_trace"]
        assert _no_times(ev) == _no_times(want)
        assert ev[0]["trace_dir"] == d

    def test_fit_trace_has_one_annotation_a_step(self, tmp_path):
        """A real ``torch.profiler`` trace of a 3-step fit: one
        ``train_step#i`` range a step, each holding the step's matmul."""
        out = tmp_path / "prof"
        _port_run(lambda ctx: _fit(ctx, num_steps=3,
                                   profile_dir=str(out)))
        trace = json.loads((out / "trace_rank0.json").read_text())
        evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        steps = sorted((e for e in evs
                        if e["name"].startswith("train_step#")),
                       key=lambda e: e["ts"])
        assert [e["name"] for e in steps] == [f"train_step#{i}"
                                              for i in range(3)]
        for s in steps:
            inside = [e for e in evs if e["name"] == "aten::mm"
                      and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
            assert inside, s["name"]


# --- TestDegradations --------------------------------------------------------

class TestDegradations:
    def _recs(self):
        return [
            {"t": 100.0, "name": "retry", "ph": "P", "rank": 0,
             "stage": "dispatch", "attempt": 1,
             "error": "InjectedPreemption: UNAVAILABLE"},
            {"t": 100.5, "name": "quarantine", "ph": "P", "rank": 0,
             "rows": 3, "error_class": "ValueError", "total": 3},
            {"t": 101.0, "name": "checkpoint_rollback", "ph": "P",
             "rank": 0, "from_step": 4, "to_step": 2},
            {"t": 102.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 3},
        ]

    def test_merge_timeline_collects_degradations(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, self._recs() + [
            {"t": 103.0, "name": "chaos", "ph": "P", "rank": 0,
             "site": "step_start", "kind": "preempt", "step": 4}])
        tl = _both_timelines(d)
        kinds = [dg["kind"] for dg in tl["degradations"]]
        assert kinds == ["retry", "quarantine", "checkpoint_rollback"]
        assert tl["first_failure"]["site"] == "step_start"
        assert tl["first_failure"]["t"] == 103.0
        rendered = events.format_timeline(tl)
        assert "survived degradations" in rendered
        assert "checkpoint_rollback x1" in rendered

    def test_collect_degradations_success_path(self, tmp_path):
        d = str(tmp_path)
        _write(d, 0, self._recs())
        _write(d, 1, [{"t": 99.0, "name": "retry", "ph": "P",
                       "rank": 1, "stage": "fetch", "attempt": 1}])
        out = events.collect_degradations(d)
        assert out == ref_events.collect_degradations(d)
        assert [r["name"] for r in out] == [
            "retry", "retry", "quarantine", "checkpoint_rollback"]
        assert out[0]["rank"] == 1
        assert events.collect_degradations(str(tmp_path / "missing")) == []
        assert events._DEGRADATION_EVENTS == ref_events._DEGRADATION_EVENTS
