"""CLIP's byte-pair-encoding tokenizer (open_clip SimpleTokenizer; a copy
of ``tpuimage.classify.tokenizer``, which the port does not import).

Used only to precompute the text features of the four fixed prompts when
a converted checkpoint and the standard ``bpe_simple_vocab_16e6.txt.gz``
merges are at hand (neither is in the repository: tokenization, like the
weights, is an offline step). The merge algorithm itself is complete and
tested against a synthetic merges list (``synth.prompt_merges``).
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> unicode mapping (used verbatim by CLIP)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# CLIP's pattern uses \p{L}/\p{N} (regex module); the stdlib-re equivalent
# below matches identically for the ASCII prompts this framework ships.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+"""
    r"""|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE)


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer. ``bpe_path`` is the standard merges file
    (gzipped text, one merge per line, first line a comment); pass
    ``merges`` directly for testing."""

    CONTEXT = 77

    def __init__(self, bpe_path: str | None = None,
                 merges: List[Tuple[str, str]] | None = None):
        if merges is None:
            if bpe_path is None:
                raise ValueError("need bpe_path or merges")
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # open_clip slices merges[1 : 49152-256-2+1]
            merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def tokenize(self, texts) -> np.ndarray:
        """open_clip tokenize(): (N, 77) int32, SOT ... EOT, zero-padded,
        truncated with EOT forced at the last slot."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.CONTEXT), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t) + [self.eot]
            if len(toks) > self.CONTEXT:
                toks = toks[:self.CONTEXT]
                toks[-1] = self.eot
            out[i, :len(toks)] = toks
        return out
