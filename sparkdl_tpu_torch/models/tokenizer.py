"""Self-contained byte-level BPE tokenizer — the port's copy of
``sparkdl_tpu/models/tokenizer.py`` (pure Python, no device). It puts
the string-column path of ``registerTextGenerationUDF`` within reach
without a downloaded tokenizer: it trains offline on any local text,
and its saved files are the JAX package's (same format tag, same
merges and ids from the same corpus).

Design: GPT-2-style byte fallback without the download. Ids 0..255 are
the raw bytes (every string round-trips losslessly, trained or not);
PAD/BOS/EOS are fixed ids 256/257/258 so special-token ids never shift
as the learned vocabulary grows; merge tokens start at 259 in learned
order. Training is classic BPE — count adjacent-pair frequencies over
whitespace-attached pretoken chunks, greedily merge the most frequent —
which is exactly the published algorithm (Sennrich et al. 2016 / GPT-2's
byte variant), implemented from scratch.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Iterable, Sequence

# Pretokens keep their LEADING whitespace attached (GPT-2 convention):
# merges then never straddle a word boundary, and " the" can become one
# token while the plain concatenation of decoded token bytes still
# reproduces the input exactly.
_PRETOKEN = re.compile(r"\s*\S+|\s+$")


class ByteBPETokenizer:
    """Byte-level BPE: ``encode`` str → ids, ``decode`` ids → str, with
    ``train``/``save``/``load``. Zero external assets; an UNtrained
    instance is already a valid (byte-only) tokenizer."""

    PAD, BOS, EOS = 256, 257, 258
    _N_SPECIAL_BASE = 259  # merge ids start here

    def __init__(self, merges: Sequence[Sequence[int]] = ()):  # noqa: D401
        self.merges: list[tuple[int, int]] = []
        self._ranks: dict[tuple[int, int], int] = {}
        # id → raw bytes, for O(1) decode of any id (merges expand to the
        # concatenation of their parts; built incrementally so each merge
        # may reference earlier merge ids)
        self._bytes: list[bytes] = [bytes([i]) for i in range(256)]
        self._bytes += [b"", b"", b""]  # PAD/BOS/EOS decode to nothing
        for pair in merges:
            self._add_merge((int(pair[0]), int(pair[1])))

    def _add_merge(self, pair: tuple[int, int]) -> int:
        a, b = pair
        if not (0 <= a < len(self._bytes) and 0 <= b < len(self._bytes)):
            raise ValueError(f"merge {pair} references unknown ids")
        if a in (self.PAD, self.BOS, self.EOS) or \
                b in (self.PAD, self.BOS, self.EOS):
            raise ValueError(f"merge {pair} references special ids")
        new_id = len(self._bytes)
        self.merges.append(pair)
        self._ranks[pair] = len(self.merges) - 1
        self._bytes.append(self._bytes[a] + self._bytes[b])
        return new_id

    @property
    def vocab_size(self) -> int:
        return len(self._bytes)

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 512,
              min_freq: int = 2) -> "ByteBPETokenizer":
        """Learn merges until ``vocab_size`` ids exist or no pair reaches
        ``min_freq``. Works on pretoken chunks so merges never cross
        whitespace boundaries.

        Pair statistics update INCREMENTALLY: each merge rewrites only
        the chunks that contain the merged pair (found via a pair→chunks
        index), so per-merge cost is proportional to affected chunks —
        not a full corpus recount, which would make a vocab_size=8192
        training quadratic. A merged pair can never reappear later (a
        merge only creates adjacencies involving its NEW id), so popping
        its index entry is safe."""
        from collections import defaultdict

        if vocab_size < cls._N_SPECIAL_BASE:
            raise ValueError(
                f"vocab_size must be >= {cls._N_SPECIAL_BASE} "
                f"(256 bytes + 3 specials), got {vocab_size}")
        tok = cls()
        # chunk (as tuple of ids) → corpus occurrence count
        chunks: Counter = Counter()
        for text in texts:
            for m in _PRETOKEN.finditer(text):
                chunks[tuple(m.group().encode("utf-8"))] += 1

        pair_counts: Counter = Counter()
        where: dict = defaultdict(set)  # pair → chunks that contain it

        def add_stats(seq, cnt):
            for p in zip(seq, seq[1:]):
                pair_counts[p] += cnt
                where[p].add(seq)

        def sub_stats(seq, cnt):
            for p in zip(seq, seq[1:]):
                pair_counts[p] -= cnt
                if pair_counts[p] <= 0:
                    del pair_counts[p]

        for seq, cnt in chunks.items():
            add_stats(seq, cnt)

        while tok.vocab_size < vocab_size and pair_counts:
            # deterministic: max count, ties by smallest pair ids
            best, cnt = min(pair_counts.items(),
                            key=lambda kv: (-kv[1], kv[0]))
            if cnt < min_freq:
                break
            new_id = tok._add_merge(best)
            # stale index entries (chunks rewritten by earlier merges)
            # filter out via the membership check
            affected = [s for s in where.pop(best, ()) if s in chunks]
            for seq in affected:
                c = chunks.pop(seq)
                sub_stats(seq, c)
                new_seq = cls._apply_one(seq, best, new_id)
                chunks[new_seq] += c
                add_stats(new_seq, c)
        return tok

    @staticmethod
    def _apply_one(seq: tuple, pair: tuple[int, int], new_id: int) -> tuple:
        out, i, n = [], 0, len(seq)
        while i < n:
            if i < n - 1 and seq[i] == pair[0] and seq[i + 1] == pair[1]:
                out.append(new_id)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return tuple(out)

    # -- encode / decode ---------------------------------------------------

    def _bpe(self, ids: list[int]) -> list[int]:
        """Apply learned merges lowest-rank-first (the standard BPE encode
        loop) until no adjacent pair has a rank."""
        while len(ids) > 1:
            ranked = [(self._ranks[p], i) for i, p in
                      enumerate(zip(ids, ids[1:])) if p in self._ranks]
            if not ranked:
                break
            rank, _ = min(ranked)
            pair = self.merges[rank]
            ids = list(self._apply_one(tuple(ids), pair,
                                       self._N_SPECIAL_BASE + rank))
        return ids

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        out: list[int] = [self.BOS] if add_bos else []
        for m in _PRETOKEN.finditer(text):
            out.extend(self._bpe(list(m.group().encode("utf-8"))))
        if add_eos:
            out.append(self.EOS)
        return out

    def decode(self, ids: Iterable[int]) -> str:
        buf = b"".join(
            self._bytes[i] for i in (int(x) for x in ids)
            if 0 <= i < len(self._bytes))
        return buf.decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "sparkdl_tpu.byte_bpe.v1",
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != "sparkdl_tpu.byte_bpe.v1":
            raise ValueError(
                f"{path}: not a sparkdl_tpu byte-BPE file "
                f"(format={blob.get('format')!r})")
        return cls(blob["merges"])
