"""Text field: caption preprocessing, padding, numericalization, decoding.

Parity: reference datasets/caption/field.py (TextField).
- preprocess: lowercase -> tokenize -> strip punctuation (:143-152);
- pad: ``<bos> tokens <eos> <pad>*`` to the batch max (or fixed) length (:184-213);
- numericalize via the vocab with OOV -> ``<unk>`` (:236-238);
- decode: map ids to tokens, stop at ``<eos>`` (:258-283).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from grit_tpu_torch.data.tokenizer import caption_tokenize
from grit_tpu_torch.data.vocab import Vocab


class TextField:
    def __init__(
        self,
        vocab_path: str | None = None,
        vocab: Vocab | None = None,
        init_token: str = "<bos>",
        eos_token: str = "<eos>",
        pad_token: str = "<pad>",
        lower: bool = True,
        remove_punctuation: bool = True,
        fix_length: int | None = None,
    ):
        self.vocab = vocab if vocab is not None else Vocab(vocab_path=vocab_path)
        self.init_token = init_token
        self.eos_token = eos_token
        self.pad_token = pad_token
        self.lower = lower
        self.remove_punctuation = remove_punctuation
        self.fix_length = fix_length

    def preprocess(self, caption: str) -> list[str]:
        return caption_tokenize(
            caption, lower=self.lower, remove_punct=self.remove_punctuation
        )

    def pad(self, minibatch: Sequence[list[str]]) -> list[list[str]]:
        if self.fix_length is None:
            max_len = max(len(x) for x in minibatch)
        else:
            max_len = self.fix_length - 2  # room for bos/eos
        out = []
        for x in minibatch:
            x = list(x[:max_len])
            out.append(
                [self.init_token] + x + [self.eos_token]
                + [self.pad_token] * (max_len - len(x))
            )
        return out

    def process(self, captions: Sequence[list[str]]) -> np.ndarray:
        padded = self.pad(captions)
        ids = [[self.vocab.stoi(tok) for tok in ex] for ex in padded]
        return np.asarray(ids, np.int32)

    def decode(self, word_idxs, join_words: bool = True):
        arr = np.asarray(word_idxs)
        if arr.ndim == 1:
            return self.decode(arr[None], join_words)[0]
        if arr.ndim == 3:  # [B, out, L] -> flatten beams
            arr = arr.reshape(-1, arr.shape[-1])
        captions = []
        for row in arr:
            caption = []
            for wi in row:
                word = self.vocab.itos[int(wi)]
                if word == self.eos_token:
                    break
                caption.append(word)
            captions.append(" ".join(caption) if join_words else caption)
        return captions
