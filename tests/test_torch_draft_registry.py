"""The LLM half of the port's registry (``models.registry``: ``DRAFT_PAIRS``,
``register_draft_pair``, ``draft_for``, ``llm_config``) and
``serving.draft.DraftModelProvider.from_registry``, held against the JAX
package's: the twins of ``tests/test_spec.py``'s ``TestRegistryPairing``
and ``test_draft_model_provider_registry_pairing``. The draft's weights
are the reference's ``PRNGKey(0)`` draw carried across by
``variables=``, so the drafted tokens are equal; without ``variables``
the port seeds its draft from a ``torch.Generator`` (another draw, a
recorded difference), which is checked for its pairing and determinism
only. Then a paged engine with ``spec_k`` and the registry draft on the
CPU serves the streams of plain greedy decoding."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax
import numpy as np
import pytest

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.models import registry as jregistry
from sparkdl_tpu.serving.draft import DraftModelProvider as JDraft
from sparkdl_tpu_torch import GenerationEngine
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.serving import DraftModelProvider


def test_draft_for_and_register():
    assert registry.DRAFT_PAIRS == jregistry.DRAFT_PAIRS
    assert registry.draft_for("llama3_8b") == "llama_small"
    assert registry.draft_for("llama_small") == "llama_tiny"
    assert registry.draft_for("unknown-family") is None
    registry.register_draft_pair("my_target", "llama_tiny")
    try:
        assert registry.draft_for("my_target") == "llama_tiny"
    finally:
        registry.DRAFT_PAIRS.pop("my_target", None)
    with pytest.raises(ValueError, match="itself"):
        registry.register_draft_pair("x", "x")


def test_llm_config_names():
    for name in ("llama_tiny", "llama_small", "llama3_8b"):
        got, want = registry.llm_config(name), jregistry.llm_config(name)
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "num_kv_heads", "intermediate_size", "rope_theta",
                      "rms_norm_eps"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    assert registry.llm_config("llama_tiny").num_layers == 2
    assert registry.llm_config("llama_small").hidden_size == 2048
    with pytest.raises(ValueError, match="Unknown LLM config"):
        registry.llm_config("gpt5")


@pytest.fixture(scope="module")
def tiny_vars():
    model = JL.LlamaModel(JL.LlamaConfig.tiny())
    return model, jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32)))


def test_draft_model_provider_registry_pairing(tiny_vars):
    """The registry-paired draft drafts k greedy tokens: with the
    reference's weights carried across, the same tokens as the
    reference's registry draft; with the port's own seeded weights,
    deterministic and inside the vocab; history outside the vocab stands
    down."""
    _, variables = tiny_vars
    with pytest.raises(ValueError, match="no draft pairing"):
        DraftModelProvider.from_registry("not-a-family", device="cpu")
    ref = JDraft.from_registry("llama_small", variables=variables,
                               min_bucket=8)
    carried = DraftModelProvider.from_registry(
        "llama_small", variables=variables, device="cpu", min_bucket=8)
    assert carried.model.cfg == L.LlamaConfig.tiny()
    for hist in ([1, 2, 3, 4, 5], list(range(40, 70)), [7]):
        assert carried.propose(hist, 3) == ref.propose(hist, 3), hist
    prov = DraftModelProvider.from_registry("llama_small", device="cpu",
                                            min_bucket=8)
    assert prov.model.cfg.num_layers == 2
    d = prov.propose([1, 2, 3, 4, 5], 3)
    assert len(d) == 3 and all(0 <= t < 512 for t in d)
    assert prov.propose([1, 2, 3, 4, 5], 3) == d
    again = DraftModelProvider.from_registry("llama_small", device="cpu",
                                             min_bucket=8)
    assert again.propose([1, 2, 3, 4, 5], 3) == d       # seeded alike
    assert prov.propose([10 ** 6], 3) == []


def test_engine_with_the_registry_draft_serves_greedy_streams(tiny_vars):
    """``spec_k=3`` with the registry draft of ``llama_small`` (tiny, its
    weights carried across) on a paged engine whose target is the same
    tiny model: every draft is the target's own greedy choice, so the
    verify accepts, and the streams equal ``generate()``'s."""
    _, variables = tiny_vars
    target = L.load_flax_params(
        L.LlamaModel(L.LlamaConfig.tiny(), device="cpu"), variables)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, n).tolist() for n in (6, 13)]
    want = []
    for p in prompts:
        ids, pads = L.left_pad_prompts([p])
        want.append(L.generate(target, ids, 8, pad_lens=pads)[0].tolist()
                    [len(p):])
    draft = DraftModelProvider.from_registry(
        "llama_small", variables=variables, device="cpu", min_bucket=8)
    eng = GenerationEngine.from_model(
        target, num_slots=2, max_len=64, device="cpu", block_size=8,
        prefill_chunk=8, spec_k=3, draft_provider=draft)
    hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run_until_idle()
    assert [h.result(1) for h in hs] == want
    snap = eng.snapshot()
    assert snap["spec_verifies"] >= 1 and snap["spec_tokens_accepted"] >= 1
