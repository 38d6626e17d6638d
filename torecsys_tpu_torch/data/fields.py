"""Vocabulary fields: token ↔ index maps for categorical and text data
(counterpart of ``torecsys_tpu/data/fields.py``).

* :class:`IndexField`: an incremental token → index vocabulary with an
  unknown bucket (``build_vocab``, grow-on-the-fly ``fit_predict``);
* :class:`SentenceField`: a tokenizer and a vocabulary with a count
  threshold and pad/unk tokens; ``to_index`` pads to a fixed length and
  returns the lengths, ``from_index`` inverts it.

Host-side Python: vocabularies are built before training; the card only
sees fixed-shape integer arrays.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class IndexField:
    """Incremental token → index vocabulary with an unknown bucket."""

    def __init__(self, unk_token: str = "<unk>", unk_index: int = 0):
        self.unk_token = unk_token
        self.unk_index = unk_index
        self.vocab: Dict[object, int] = {unk_token: unk_index}
        self.inverse: Dict[int, object] = {unk_index: unk_token}

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def current_max_index(self) -> int:
        return max(self.inverse) if self.inverse else -1

    def build_vocab(self, tokens: Iterable) -> "IndexField":
        """Add every unseen token with the next free index."""
        for tok in tokens:
            if tok not in self.vocab:
                idx = self.current_max_index + 1
                self.vocab[tok] = idx
                self.inverse[idx] = tok
        return self

    def fit_predict(self, tokens: Sequence) -> List[int]:
        """Grow the vocab with unseen tokens, then index them."""
        self.build_vocab(tokens)
        return [self.vocab[t] for t in tokens]

    def to_index(self, tokens: Sequence) -> List[int]:
        return [self.vocab.get(t, self.unk_index) for t in tokens]

    def from_index(self, indices: Sequence[int]) -> List:
        return [self.inverse.get(i, self.unk_token) for i in indices]


def _default_tokenizer(text: str) -> List[str]:
    return text.lower().split()


class SentenceField:
    """Tokenizing vocabulary with count threshold and pad/unk tokens."""

    def __init__(
        self,
        tokenizer: Callable[[str], List[str]] = _default_tokenizer,
        threshold: int = 0,
        pad_token: str = "<pad>",
        unk_token: str = "<unk>",
    ):
        self.tokenizer = tokenizer
        self.threshold = threshold
        self.pad_token = pad_token
        self.unk_token = unk_token
        self.counter: Counter = Counter()
        self.vocab: Dict[str, int] = {pad_token: 0, unk_token: 1}
        self.inverse: Dict[int, str] = {0: pad_token, 1: unk_token}

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def pad_index(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def unk_index(self) -> int:
        return self.vocab[self.unk_token]

    def build_vocab(self, sentences: Iterable[str]) -> "SentenceField":
        """Count tokens over ``sentences``; admit those above ``threshold``."""
        for s in sentences:
            self.counter.update(self.tokenizer(s))
        for tok, cnt in self.counter.items():
            if cnt >= self.threshold and tok not in self.vocab:
                idx = len(self.vocab)
                self.vocab[tok] = idx
                self.inverse[idx] = tok
        return self

    def to_index(
        self, sentences: Sequence[str], max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize + index + pad to a fixed length.

        Returns ``(indices (B, L) int32, lengths (B,) int32)`` — fixed-shape
        (every batch of a CUDA graph takes one shape).
        """
        tokenized = [self.tokenizer(s) for s in sentences]
        lengths = np.asarray([len(t) for t in tokenized], dtype=np.int32)
        L = max_length if max_length is not None else int(lengths.max(initial=1))
        out = np.full((len(tokenized), L), self.pad_index, dtype=np.int32)
        for i, toks in enumerate(tokenized):
            for j, tok in enumerate(toks[:L]):
                out[i, j] = self.vocab.get(tok, self.unk_index)
        return out, np.minimum(lengths, L)

    def from_index(self, indices: np.ndarray) -> List[List[str]]:
        """Inverse of :meth:`to_index` (pads stripped)."""
        result = []
        for row in np.asarray(indices):
            toks = [self.inverse.get(int(i), self.unk_token) for i in row]
            result.append([t for t in toks if t != self.pad_token])
        return result
