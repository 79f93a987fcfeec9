"""Supervised training gangs of the port on the CPU (gloo): real
``torch.distributed`` workers (``tests/test_torch_gang_worker.py``'s
``sup_*`` modes, a 4×3 linear softmax model through ``runner.run`` and
``ctx.fit``) under ``sparkdl_tpu_torch.runner.launcher.supervise`` with a
chaos plan, each the twin of a reference end-to-end test:

- ``tests/test_multiprocess.py::test_supervise_sigkilled_rank_relaunches_to_completion``:
  a 2-rank gang whose rank 1 is SIGKILLed at step 2 relaunches to
  completion;
- ``tests/test_chaos.py::test_supervised_gang_rolls_back_corrupt_checkpoint``:
  a preempted gang whose newest checkpoint is corrupted before the
  relaunch's restore rolls back to the verified step and finishes;
- ``scripts/elastic_smoke.py``: a 4-rank gang over 12 global rows loses
  rank 2 for good (``decimate``), shrinks free to 3, restores the 4-rank
  checkpoint (``SPARKDL_ELASTIC``) and finishes with every batch in the
  ledger exactly once; the same job with ``SPARKDL_ELASTIC=0``
  death-loops.

The expectations are the reference tests' own; the reference's workers
run jax and are not started here.
"""

import glob
import json
import time
from pathlib import Path

import pytest

from sparkdl_tpu_torch.runner import Fault, FaultPlan, GangFailure, supervise
from sparkdl_tpu_torch.runner.data import read_ledger

WORKER = str(Path(__file__).with_name("test_torch_gang_worker.py"))


def _args(mode, d):
    return [mode, str(d), str(d), "cpu"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SPARKDL_EVENT_DIR", "SPARKDL_METRICS_DIR", "SPARKDL_ELASTIC",
              "SPARKDL_BATCH_LEDGER", "SPARKDL_CHAOS", "SPARKDL_TRACE_ID",
              "SPARKDL_SKIP_BATCHES"):
        monkeypatch.delenv(k, raising=False)


def test_supervise_sigkilled_rank_relaunches_to_completion(tmp_path):
    """Rank 1 SIGKILLed at step 2 of a 2-rank gang: the dead rank is found
    within a poll, the gang killed, the death classified retryable, and
    the relaunch finishes (the plan's state dir fires the kill once)."""
    import torch

    plan = FaultPlan([Fault("step_start", "sigkill", at_step=2, rank=1)])
    t0 = time.monotonic()
    res = supervise(WORKER, np=2, args=_args("sup_linear", tmp_path),
                    timeout_s=120.0, max_restarts=2, backoff_s=0.1,
                    poll_s=0.25, plan=plan)
    wall = time.monotonic() - t0
    assert res.restarts == 1, res.failure_kinds
    assert res.failure_kinds == ["retryable"]
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]
    assert [o["step"] for o in outs] == [4, 4]
    assert torch.equal(outs[0]["w"], outs[1]["w"])  # replicated
    assert wall < 60, f"supervise took {wall:.0f}s — timeout-driven?"


def test_supervised_gang_rolls_back_corrupt_checkpoint(tmp_path):
    """Attempt 1 saves steps 2 and 4, then dies on an injected preemption
    at step 5; before attempt 2's restore a ``corrupt`` fault damages step
    4. The restore quarantines it, rolls back to step 2 and finishes
    within the budget, the rollback on the result's degradations."""
    plan = FaultPlan([Fault("step_start", "preempt", at_step=5),
                      Fault("checkpoint_restore", "corrupt", prob=1.0)])
    res = supervise(WORKER, np=1, args=_args("sup_rollback", tmp_path),
                    timeout_s=120.0, max_restarts=2, backoff_s=0.1,
                    poll_s=0.25, plan=plan)
    attempts = [json.loads(ln)
                for ln in open(tmp_path / "attempts.jsonl")]
    assert res.restarts == 1 and res.failure_kinds == ["retryable"]
    assert attempts == [{"final_step": 6, "steps_this_attempt": 4}]
    assert res.rolled_back
    kinds = {d.get("name") for d in res.degradations}
    assert {"checkpoint_rollback", "checkpoint_quarantine"} <= kinds
    rb = [d for d in res.degradations
          if d.get("name") == "checkpoint_rollback"][0]
    assert (rb["from_step"], rb["to_step"]) == (4, 2)
    assert glob.glob(str(tmp_path / "ckpt" / "4.corrupt*"))


def _decimate_plan():
    return FaultPlan([Fault("step_start", "decimate", at_step=5, rank=2)])


def _audit(ledger_dir):
    """(exactly once over steps and batches 0-11, replays consistent, the
    world sizes seen) from rank 0's ledger (``shard=True``: its batch
    indices are the gang's)."""
    by_step, consistent = {}, True
    ledger = read_ledger(ledger_dir)
    for e in ledger:
        prev = by_step.get(e["step"])
        if prev is not None and prev != e["batch_index"]:
            consistent = False
        by_step[e["step"]] = e["batch_index"]
    once = (sorted(by_step.values()) == list(range(12))
            and sorted(by_step) == list(range(12)))
    return once, consistent, sorted({e["world"] for e in ledger})


def test_elastic_gang_shrinks_and_finishes_exactly_once(tmp_path):
    """``scripts/elastic_smoke.py``'s first leg: rank 2 of 4 dies for good
    at step 5; a budgeted restart, rank 2 dies again at once, the free
    shrink to 3 (``max_restarts=1``: a resize that cost budget could not
    finish), the 3-rank gang restores the 4-rank checkpoint and
    finishes; the ledger has every batch exactly once, worlds 4 then 3."""
    ledger = tmp_path / "ledger"
    res = supervise(WORKER, np=4, args=_args("sup_elastic", tmp_path),
                    env={"SPARKDL_BATCH_LEDGER": str(ledger)},
                    plan=_decimate_plan(), elastic=True, max_restarts=1,
                    timeout_s=120.0, backoff_s=0.1, poll_s=0.25)
    survivors = []
    for r in range(3):
        with open(tmp_path / f"result_rank{r}.jsonl") as f:
            survivors += [json.loads(ln) for ln in f]
    assert len(survivors) == 3 and all(
        s["final_step"] == 12 and s["world"] == 3 for s in survivors)
    assert not (tmp_path / "result_rank3.jsonl").exists()
    assert res.resizes == 1 and res.final_np == 3
    assert res.failure_kinds == ["retryable", "resized"]
    assert res.restarts == 2
    names = {d.get("name") for d in res.degradations}
    assert {"gang_resized", "train_resume", "checkpoint_resharded"} <= names
    once, consistent, worlds = _audit(str(ledger))
    assert once and consistent and worlds == [3, 4]


def test_elastic_off_death_loops(tmp_path):
    """The counterfactual leg: ``SPARKDL_ELASTIC=0``, the same dead slot
    burns the whole budget at world size 4."""
    with pytest.raises(GangFailure, match="giving up after 2"):
        supervise(WORKER, np=4, args=_args("sup_elastic", tmp_path),
                  env={"SPARKDL_ELASTIC": "0"}, plan=_decimate_plan(),
                  max_restarts=2, timeout_s=120.0, backoff_s=0.1,
                  poll_s=0.25)
    assert not glob.glob(str(tmp_path / "result_rank*.jsonl"))

