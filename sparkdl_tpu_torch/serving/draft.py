"""Draft providers for speculative decoding.

The port's copy of ``sparkdl_tpu/serving/draft.py``;
:class:`DraftModelProvider` drives the port's Llama, and its
``from_registry`` builds the draft the registry pairs with a target.

Speculative decode splits token generation in two: a cheap DRAFT of k
candidate tokens per request, and one batched target-model VERIFY call
that checks all k in a single program dispatch
(``models.llama.slot_verify_step``). This module owns the draft half —
deliberately **jax-free by default**, like the rest of the scheduler:
the engine calls ``provider.propose(history, k)`` with the request's
``prompt + generated-so-far`` token list and commits the longest
prefix of the proposal whose greedy argmax the target agrees with.

Built-in providers:

- :class:`NGramDraft` (the default, ``SPARKDL_SERVE_SPEC_DRAFT=ngram``)
  — prompt-lookup self-drafting (Saxena's prompt-lookup decoding; the
  zero-extra-weights corner of the Medusa/EAGLE self-drafting family):
  match the history's newest n-gram against its own earlier tokens and
  propose the run that followed the match. Costs O(len·n) host time
  per call, no model, no device — and chat/RAG serving is exactly the
  traffic where the output restates spans of the prompt (or of its own
  earlier output), so acceptance is high where speculation pays most.
- :class:`HistoryDraft` (``SPARKDL_SERVE_SPEC_DRAFT=history``) — the
  retrieval variant (REST-style, He et al. 2023): the same suffix
  match, extended over a bounded corpus of recently COMPLETED
  requests (the engine feeds retirements through ``observe``).
  Greedy decode is deterministic, so on repeated-prompt traffic — the
  FAQ/retry-storm shape — the previous completion predicts the new
  one token for token and acceptance approaches 100%; the verify call
  is what makes the retrieved draft *safe* rather than assumed.
- :class:`DraftModelProvider` — a small *draft model* greedily decodes
  k tokens per proposal (Leviathan et al. 2023). Pairing is registry-
  driven, not hardcoded: :func:`models.registry.draft_for` names the
  draft config for a target family and
  :meth:`DraftModelProvider.from_registry` builds it.

A provider may return FEWER than k tokens (or none): the engine pads
the verify window and still always commits >= 1 token per iteration —
a fully-rejected proposal degrades to exactly the k=0 decode step's
output, and an iteration where NO slot drafted anything skips the
verify dispatch and runs the plain decode step, so speculation can
never emit less (or run slower per token) than baseline.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Protocol, Sequence

__all__ = ["DraftProvider", "NGramDraft", "HistoryDraft",
           "DraftModelProvider", "make_provider", "SPEC_DRAFT_ENV"]

SPEC_DRAFT_ENV = "SPARKDL_SERVE_SPEC_DRAFT"


class DraftProvider(Protocol):
    """What the engine needs from a draft source."""

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        """Up to ``k`` candidate continuation tokens for ``history``
        (the request's prompt + tokens generated so far). May return
        fewer (or ``[]``) when it has nothing confident to offer."""
        ...


class NGramDraft:
    """Prompt-lookup self-drafting: propose the continuation of the
    most recent earlier occurrence of the history's newest n-gram.

    Longest n first (``max_ngram`` down to ``min_ngram``): a longer
    match is a stronger signal, so its continuation wins. Within one n
    the MOST RECENT occurrence *with a full k-token continuation* wins
    (repetition is usually local — the model restating its own recent
    output); when no occurrence has k tokens after it, the longest
    available continuation wins. The full-k preference matters for
    token RUNS: the newest occurrence of ``aaa`` inside ``aaaaaa``
    overlaps the suffix and has only the final token after it — a
    1-token draft where the run supports k. Stateless and shared
    safely across requests/engines: every call re-derives from the
    history alone, so preemption-resume (history rebuilt from
    ``prompt + tokens``) needs no provider bookkeeping.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        hist = list(history)
        if k <= 0 or len(hist) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(hist) - 1),
                       self.min_ngram - 1, -1):
            best = _match_continuation(hist, hist[len(hist) - n:], k,
                                       exclude_suffix=True)
            if best:
                return best
        return []


def _match_continuation(seq, pat, k: int,
                        exclude_suffix: bool = False) -> list[int]:
    """Longest continuation (up to ``k`` tokens) following an
    occurrence of ``pat`` in ``seq`` — right-to-left scan: the first
    (most recent) full-k match wins, otherwise the longest
    continuation seen. ``exclude_suffix`` skips the match that IS the
    sequence's own suffix (self-lookup would propose nothing)."""
    n = len(pat)
    if n == 0 or k <= 0:
        return []
    last = len(seq) - n - (1 if exclude_suffix else 0)
    best: list[int] = []
    for start in range(last, -1, -1):
        if seq[start:start + n] == pat:
            cont = seq[start + n:start + n + k]
            if len(cont) > len(best):
                best = cont
            if len(best) == k:
                break
    return best


class HistoryDraft(NGramDraft):
    """Retrieval drafting over completed requests (REST-style): the
    prompt-lookup match runs first over the request's OWN history
    (inherited), then over a bounded LRU corpus of recently COMPLETED
    ``prompt + output`` sequences the engine feeds through
    :meth:`observe` at retirement.

    Why it works: greedy decode is deterministic, so on repeated
    prompts — the FAQ/retry-storm traffic class — the cached previous
    completion predicts the new stream token for token; the batched
    verify is what turns that retrieval into *proven* output instead
    of a stale-cache answer (weight swaps, sampling changes and hash
    collisions all surface as rejection, never as wrong tokens).
    Thread-safe; memory bounded by ``max_entries`` sequences."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_entries: int = 256):
        super().__init__(max_ngram, min_ngram)
        self.max_entries = max(1, int(max_entries))
        self._corpus: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def observe(self, prompt: Sequence[int], tokens: Sequence[int]):
        """Record one completed request (engine retirement hook)."""
        key = tuple(prompt)
        seq = [int(t) for t in prompt] + [int(t) for t in tokens]
        with self._lock:
            self._corpus[key] = seq
            self._corpus.move_to_end(key)
            while len(self._corpus) > self.max_entries:
                self._corpus.popitem(last=False)

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        hist = list(history)
        if k <= 0 or not hist:
            return []
        with self._lock:
            corpus = list(reversed(self._corpus.values()))  # newest 1st
        # Exact REPLAY first — the retry-storm case: the request's
        # whole history is a prefix of a cached completion (greedy
        # determinism makes the continuation exact, not similar), and
        # a short n-gram would mis-align inside a repetitive cached
        # stream where the full-prefix match cannot.
        m = len(hist)
        for seq in corpus:
            if len(seq) > m and seq[:m] == hist:
                return seq[m:m + k]
        own = super().propose(hist, k)
        if len(own) >= k:
            return own
        if m < self.min_ngram:
            return own
        for n in range(min(self.max_ngram, m), self.min_ngram - 1, -1):
            pat = hist[m - n:]
            best: list[int] = []
            for seq in corpus:
                cont = _match_continuation(seq, pat, k)
                if len(cont) > len(best):
                    best = cont
                if len(best) == k:
                    break
            if best:
                # longer own-history match beats an equal corpus match
                # (local repetition is fresher evidence)
                return best if len(best) > len(own) else own
        return own


class DraftModelProvider:
    """Draft-model speculation: a small model (the port's
    ``models.llama.LlamaModel``, which holds its weights) greedily
    decodes ``k`` candidates per proposal through the static
    ``generate()`` path, on the model's device.

    The draft prompt is the history's newest ``max_history`` tokens,
    left-padded to a power-of-two bucket (the same bucketing rule the
    blocking engine uses). ``variables``, when given, is a JAX-package
    parameter tree loaded into ``model`` (``load_flax_params``)."""

    def __init__(self, model, variables=None, *, max_history: int = 64,
                 min_bucket: int = 16):
        if variables is not None:
            from ..models import llama as L
            L.load_flax_params(model, variables)
        self.model = model
        self.max_history = max(2, int(max_history))
        self.min_bucket = max(1, int(min_bucket))

    @classmethod
    def from_registry(cls, target_name: str, *, variables=None,
                      device=None, dtype=None, attn_fn="auto",
                      **kw) -> "DraftModelProvider":
        """Build the registry-paired draft model for ``target_name``
        (``models.registry.draft_for``) on ``device`` (None: the card,
        as every entry point of the port), in ``dtype`` (default f32)
        with ``attn_fn`` as ``LlamaModel`` takes it. Its weights are
        ``variables`` (a JAX-package tree, carried across by
        ``load_flax_params``) or, when None, drawn from a
        ``torch.Generator`` seeded with 0 — not the reference's
        ``PRNGKey(0)`` draw, so only carried weights equal the
        reference's draft. Raises ``ValueError`` when the family has no
        draft pairing."""
        import torch

        from ..models import llama as L
        from ..models import registry
        from ..utils.platform import resolve_device
        draft_name = registry.draft_for(target_name)
        if draft_name is None:
            raise ValueError(
                f"no draft pairing registered for {target_name!r}; "
                f"add one via models.registry.register_draft_pair")
        device = resolve_device(device)
        model = L.LlamaModel(
            registry.llm_config(draft_name),
            dtype=torch.float32 if dtype is None else dtype,
            attn_fn=attn_fn, device=device,
            generator=torch.Generator(device=device).manual_seed(0))
        return cls(model, variables, **kw)

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        if k <= 0 or not history:
            return []
        from ..models import llama as L
        hist = [int(t) for t in history][-self.max_history:]
        vocab = int(self.model.cfg.vocab_size)
        if any(t < 0 or t >= vocab for t in hist):
            return []  # target vocab wider than the draft's: stand down
        b = self.min_bucket
        while b < len(hist):
            b <<= 1
        ids, lens = L.left_pad_prompts([hist], pad_to=b)
        out = L.generate(self.model, ids, int(k), pad_lens=lens,
                         pad_to=b + int(k))
        return out[0, b:].tolist()


def make_provider(spec: str | None = None):
    """Resolve ``SPARKDL_SERVE_SPEC_DRAFT`` (or an explicit ``spec``)
    to a provider: ``"ngram"`` (default) -> :class:`NGramDraft`;
    ``"history"`` -> :class:`HistoryDraft` (cross-request retrieval);
    ``"<name>:<N>"`` tunes the match length (ngram) or corpus size
    (history); ``"none"``/``"off"`` -> a null provider (draftless
    iterations fall through to the plain decode step — exactly the
    k=0 engine, the measurement baseline for drafting quality).
    Draft-MODEL providers carry weights, so they are
    constructor-injected (``GenerationEngine(draft_provider=...)``),
    not env-selected."""
    spec = (spec if spec is not None
            else os.environ.get(SPEC_DRAFT_ENV, "ngram")).strip().lower()
    if spec in ("none", "off", "0"):
        return _NullDraft()
    name, _, arg = spec.partition(":")
    argn = None
    if arg:
        # a malformed tuning suffix must fail loudly, exactly like an
        # unknown provider name — a silently-defaulted typo would leave
        # the operator believing their tuning took effect
        try:
            argn = int(arg)
        except ValueError:
            raise ValueError(
                f"bad {SPEC_DRAFT_ENV} argument {arg!r} in {spec!r} "
                f"(expected an integer >= 1)") from None
        if argn < 1:
            raise ValueError(f"bad {SPEC_DRAFT_ENV} argument {argn} in "
                             f"{spec!r} (expected an integer >= 1)")
    if name == "ngram":
        return NGramDraft(max_ngram=argn or 3)
    if name == "history":
        return HistoryDraft(max_entries=argn or 256)
    raise ValueError(f"unknown {SPEC_DRAFT_ENV} value {spec!r} "
                     f"(expected 'ngram[:N]', 'history[:N]' or 'none')")


class _NullDraft:
    """Proposes nothing: every iteration falls through to the plain
    decode step (the engine skips the verify dispatch entirely when no
    slot drafted) — the honest k=0 baseline a drafting experiment
    compares against."""

    def propose(self, history: Sequence[int], k: int) -> list[int]:
        return []
