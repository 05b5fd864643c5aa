"""Span-finding and text-chunking utilities: a copy of
llama_pipeline_parallel_tpu/data/text_utils.py (`re` only).

Capability-equivalent re-design of the reference's `data/data_utils.py`
helpers (find_span :80-94, span_chunk :97-180, get_unused_tokens :273-294,
char/subword alignment :381-430) that back its entity-span datasets. Written
dependency-free (the reference needs nltk; here a regex word splitter covers
the same ground) and with explicit semantics instead of warning-and-continue:

- `find_spans(text, span)`: every word-boundary-aligned occurrence.
- `chunk_by_spans(text, spans)`: split text into pieces with a 0/1 indicator
  per piece marking which pieces are (parts of) target spans. Nested spans
  collapse to the outermost; overlapping spans are clipped to the previous
  span's end (the reference's resolution rule, data/data_utils.py:135-137).
- `char_to_token_spans`: map char spans onto tokenizer offsets.
"""

from __future__ import annotations

import re
from typing import Sequence

_WORD_RE = re.compile(r"\w+(?:'\w+)?|[^\w\s]")


def word_tokenize(text: str) -> list[str]:
    """Whitespace/punctuation word split keeping contractions together
    (the reference's whitespace_tokenize intent without nltk)."""
    return _WORD_RE.findall(text)


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def find_spans(text: str, span: str, start: int = 0) -> list[tuple[int, int]]:
    """All occurrences of `span` in `text` that sit on word boundaries."""
    span = span.strip()
    out: list[tuple[int, int]] = []
    if not span:
        return out
    pos = start
    while True:
        s = text.find(span, pos)
        if s == -1:
            return out
        e = s + len(span)
        left_ok = s == 0 or not (_is_word_char(text[s - 1]) and _is_word_char(span[0]))
        right_ok = e == len(text) or not (_is_word_char(text[e]) and _is_word_char(span[-1]))
        if left_ok and right_ok:
            out.append((s, e))
        pos = e


def resolve_spans(positions: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sort; drop spans nested inside others; clip partial overlaps to the
    previous span's end."""
    pos = sorted(positions)
    # drop nested
    kept: list[tuple[int, int]] = []
    for s, e in pos:
        if any(os_ <= s and e <= oe and (os_, oe) != (s, e) for os_, oe in pos):
            continue
        kept.append((s, e))
    # clip partial overlaps
    out: list[tuple[int, int]] = []
    for s, e in kept:
        if out and s < out[-1][1]:
            s = out[-1][1]
            if s >= e:
                continue
        out.append((s, e))
    return out


def chunk_by_spans(text: str, spans: Sequence[str], word_split: bool = False
                   ) -> tuple[list[str], list[int]]:
    """Split `text` into pieces; indicator 1 marks pieces that are target
    spans (reference span_chunk contract: `(text_spans, indicate_mask)`).

    `word_split=True` further splits the non-span pieces into words."""
    positions: list[tuple[int, int]] = []
    for span in spans:
        positions.extend(find_spans(text, span))
    positions = resolve_spans(positions)

    pieces: list[str] = []
    mask: list[int] = []

    def add_plain(fragment: str) -> None:
        if word_split:
            words = word_tokenize(fragment)
            pieces.extend(words)
            mask.extend([0] * len(words))
        else:
            fragment = fragment.strip()
            if fragment:
                pieces.append(fragment)
                mask.append(0)

    last = 0
    for s, e in positions:
        add_plain(text[last:s])
        pieces.append(text[s:e].strip())
        mask.append(1)
        last = e
    add_plain(text[last:])
    return pieces, mask


def get_unused_tokens(tokenizer, num: int = 4, prefix: str = "unused") -> list[str]:
    """Reserve marker tokens absent from the vocab (reference
    get_unused_tokens, data/data_utils.py:273-294): returns `[unused0]`-style
    strings not currently in the tokenizer, for callers to add as specials."""
    vocab = tokenizer.get_vocab() if hasattr(tokenizer, "get_vocab") else {}
    out = []
    i = 0
    while len(out) < num:
        cand = f"[{prefix}{i}]"
        if cand not in vocab:
            out.append(cand)
        i += 1
        if i > num + 10_000:
            raise RuntimeError("could not find unused token names")
    return out


def char_to_token_spans(offsets: Sequence[tuple[int, int]],
                        char_spans: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """Map char-level spans to token index ranges given tokenizer offsets
    (reference char/subword alignment, data/data_utils.py:381-430, rebuilt on
    fast-tokenizer `offset_mapping`s). Returns [t_start, t_end) per span;
    (0, 0) when a span covers no tokens."""
    out: list[tuple[int, int]] = []
    for cs, ce in char_spans:
        t_start, t_end = None, None
        for ti, (ts, te) in enumerate(offsets):
            if ts == te:  # special tokens have empty offsets
                continue
            if te > cs and ts < ce:
                if t_start is None:
                    t_start = ti
                t_end = ti + 1
        out.append((t_start, t_end) if t_start is not None else (0, 0))
    return out
