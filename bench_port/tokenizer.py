"""A word-level tokenizer: the traffic's text is seeded words `w<k>`, one token each.

It answers the calls the port's collators make of a Hugging Face tokenizer
(`tokenizer(texts, max_length=, truncation=, return_length=)`, `eos_token`,
`len()`), and the reference calls it the same way. Ids: 0 `<unk>`, 1 `<s>`,
2 `</s>`, 3 `<pad>`, then word k at 4 + k (`words[k]` is its text). Every
text starts with `<s>`; an `</s>` glued to a word (the collators'
`f"{input} {target}{eos}"`) is its own token; anything else is `<unk>`.
"""

from __future__ import annotations

from typing import Sequence

SPECIALS = ("<unk>", "<s>", "</s>", "<pad>")
FIRST_WORD = len(SPECIALS)


class WordTokenizer:
    unk_token, bos_token, eos_token, pad_token = SPECIALS
    padding_side = "right"

    def __init__(self, vocab_size: int):
        if vocab_size <= FIRST_WORD:
            raise ValueError(f"vocab_size {vocab_size} leaves no room for words")
        self.vocab_size = vocab_size
        self.words = [f"w{k}" for k in range(vocab_size - FIRST_WORD)]
        self._ids = {w: FIRST_WORD + k for k, w in enumerate(self.words)}
        self._ids.update({t: i for i, t in enumerate(SPECIALS) if t != self.unk_token})

    @property
    def num_words(self) -> int:
        return self.vocab_size - FIRST_WORD

    def __len__(self) -> int:
        return self.vocab_size

    def add_special_tokens(self, special: dict) -> int:
        raise ValueError(f"the word tokenizer has fixed specials; asked to add {special}")

    def encode(self, text: str) -> list[int]:
        """One dict lookup a piece: a stand-in for a tokenizer whose work runs
        outside the interpreter lock, so that the prefetch thread takes little
        of it from the thread that launches the kernels."""
        get = self._ids.get
        return [1] + [get(p, 0) for p in text.replace(self.eos_token, " " + self.eos_token).split()]

    def __call__(self, texts: Sequence[str], max_length: int | None = None,
                 truncation: bool = False, return_length: bool = False, **unused) -> dict:
        if unused.get("padding") not in (None, False) or unused.get("return_tensors"):
            raise ValueError("the word tokenizer neither pads nor returns tensors")
        ids = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            ids = [x[:max_length] for x in ids]
        out = {"input_ids": ids}
        if return_length:
            out["length"] = [len(x) for x in ids]
        return out


