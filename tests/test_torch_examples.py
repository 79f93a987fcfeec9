"""Twins of ``tests/test_examples.py`` for the port's example scripts
(``examples/torch_*.py``), on the CPU (``--device cpu``), at the
reference's env sizes and with its marker lines; the two distributed
scripts run under ``python -m sparkdl_tpu_torch.runner.launcher`` as
gloo gangs of 2 and 8.

And the slice as a whole: ``LlamaConfig.tiny()`` weights from the flax
init, carried across, generate with ring attention on a 4-rank gloo gang
(``tests/torch_parallel_worker.py``, mode ``generate``). The tokens must
equal the JAX package's ``generate`` with its ``ring_attention`` on a
4-device mesh, its dense run and the port's dense run: greedy tokens,
bitwise.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.core import runtime as jax_runtime
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.parallel import ring_attention as jax_ring
from sparkdl_tpu_torch.runner import launcher

ROOT = Path(__file__).resolve().parent.parent
EX = ROOT / "examples"
WORKER = Path(__file__).with_name("torch_parallel_worker.py")


def _run(name: str, extra_env: dict | None = None, np_: int = 0,
         timeout: int = 240) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra_env or {})
    script = [str(EX / name), "--device", "cpu"]
    cmd = ([sys.executable, "-m", "sparkdl_tpu_torch.runner.launcher",
            "--np", str(np_)] + script) if np_ else \
        [sys.executable] + script
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, \
        f"{name} failed:\n{proc.stderr[-1500:]}\n{proc.stdout[-500:]}"
    return proc.stdout


def test_transfer_learning_example():
    out = _run("torch_transfer_learning.py", {"N_IMAGES": "8"})
    assert "train accuracy" in out


def test_distributed_training_example():
    out = _run("torch_distributed_training.py",
               {"STEPS": "3", "BATCH_PER_CHIP": "2"}, np_=2)
    assert "-device DP: loss" in out
    assert out.count("-device DP: loss") == 1  # rank 0 prints
    assert out.startswith("2-device DP")


def test_long_context_serving_example():
    out = _run("torch_long_context_serving.py", np_=8)
    assert "bit-identical" in out
    assert "sharded over 8 devices (8 tokens/device)" in out


def test_generation_serving_example():
    out = _run("torch_generation_serving.py")
    assert "ONE prefill + ONE decode program" in out
    assert "in-repo tokenizer only" in out


def test_example_twins_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import sparkdl_tpu\b|"
                     r"from sparkdl_tpu[ .])", re.M)
    twins = sorted(EX.glob("torch_*.py"))
    assert len(twins) == 4
    for path in twins:
        assert not pat.search(path.read_text()), path


def test_ring_generate_on_a_gang_equals_jax_ring_and_dense(tmp_path):
    cfg = JL.LlamaConfig.tiny()
    S, new = 64, 8
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, S))
    dense = JL.LlamaModel(cfg)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]))
    mesh = jax_runtime.make_mesh({"sp": 4}, devices_=jax.devices()[:4])
    sp = JL.LlamaModel(cfg, attn_fn=functools.partial(jax_ring, mesh=mesh,
                                                      axis="sp"))
    jax_dense = np.asarray(JL.generate(dense, variables, ids, new))
    jax_sp = np.asarray(JL.generate(sp, variables, ids, new))
    np.testing.assert_array_equal(jax_sp, jax_dense)

    torch.save(jax.tree_util.tree_map(np.asarray, variables["params"]),
               tmp_path / "llama_tiny.pt")
    torch.save({"ids": torch.from_numpy(ids), "new": new},
               tmp_path / "prompts.pt")
    launcher.launch(str(WORKER), np=4,
                    args=["generate", str(tmp_path), str(tmp_path)],
                    env={"OMP_NUM_THREADS": "1",
                         "PYTHONPATH": str(ROOT) + os.pathsep
                         + str(ROOT / "tests")},
                    timeout_s=180.0, capture=True)
    for r in range(4):
        out = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        np.testing.assert_array_equal(out["ring"].numpy(), jax_sp)
        np.testing.assert_array_equal(out["dense"].numpy(), jax_dense)
