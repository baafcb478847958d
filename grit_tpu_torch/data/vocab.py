"""Caption vocabulary.

Compatible with the reference's ``vocab.json`` format (datasets/caption/vocab.py):
``{"itos": [...], "freqs": {...}}`` with specials
``['<unk>', '<pad>', '<bos>', '<eos>']`` at ids 0..3 and out-of-vocabulary
tokens mapping to ``<unk>`` (id 0).  Build order parity: tokens sorted by
frequency descending, ties alphabetical (vocab.py:67-68).
"""

from __future__ import annotations

import json
import os
from collections import Counter

SPECIALS = ["<unk>", "<pad>", "<bos>", "<eos>"]


class Vocab:
    def __init__(
        self,
        counter: Counter | None = None,
        max_size: int | None = None,
        min_freq: int = 1,
        specials: list[str] = SPECIALS,
        vocab_path: str | None = None,
    ):
        if vocab_path is not None and os.path.exists(vocab_path):
            data = json.load(open(vocab_path))
            self.itos = data["itos"]
            self.freqs = data.get("freqs", {})
        else:
            assert counter is not None
            self.freqs = dict(counter)
            counter = counter.copy()
            for tok in specials:
                del counter[tok]
            self.itos = list(specials)
            limit = None if max_size is None else max_size + len(self.itos)
            pairs = sorted(counter.items(), key=lambda kv: kv[0])
            pairs.sort(key=lambda kv: kv[1], reverse=True)
            for word, freq in pairs:
                if freq < max(min_freq, 1) or len(self.itos) == limit:
                    break
                self.itos.append(word)
        self._stoi = {tok: i for i, tok in enumerate(self.itos)}

    def stoi(self, token: str) -> int:
        return self._stoi.get(token, 0)  # OOV -> <unk>

    def __len__(self) -> int:
        return len(self.itos)

    def __contains__(self, token: str) -> bool:
        return token in self._stoi

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"itos": self.itos, "freqs": self.freqs}, f)
