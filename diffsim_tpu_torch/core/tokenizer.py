"""CLIP BPE tokenizer (host-side), loading the standard vocab.json + merges.txt format.

Re-implements the published CLIP byte-pair-encoding scheme (lowercase, word-level regex split,
BPE with an end-of-word suffix) so the framework has no import-time dependency on tokenizer
assets. Benchmark prompts are short ASCII strings ("The photo of a {cls}").

``HashTokenizer`` is the asset-free fallback for tests and random-weight runs.

The port's own copy of ``diffsim_tpu/core/tokenizer.py`` (numpy only), kept so that
``diffsim_tpu_torch`` never imports the JAX package.
"""

from __future__ import annotations

import functools
import html
import json
import re

import numpy as np

MAX_LEN = 77


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The published GPT-2/CLIP byte->unicode table (printable chars keep their codepoint,
    the rest map above 255)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
    re.IGNORECASE | re.UNICODE,
)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class CLIPTokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 pad_token: str = "<|endoftext|>"):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = vocab["<|startoftext|>"]
        self.eos_id = vocab["<|endoftext|>"]
        self.pad_id = vocab[pad_token] if pad_token in vocab else self.eos_id
        self._cache: dict[str, list[str]] = {}

    @staticmethod
    def from_files(vocab_json: str, merges_txt: str, pad_token: str = "<|endoftext|>") -> "CLIPTokenizer":
        with open(vocab_json) as f:
            vocab = json.load(f)
        with open(merges_txt) as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines[1:]:  # first line is the version header
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return CLIPTokenizer(vocab, merges, pad_token)

    def with_pad_token(self, pad_token: str) -> "CLIPTokenizer":
        """A view sharing the parsed vocab/merge tables with a different pad id — SDXL's
        tokenizer-2 is the same BPE padded with "!" (token 0) instead of EOS; re-parsing the
        ~1.5 MB asset files for that is wasted startup work.

        Raises if ``pad_token`` is not in the vocab: silently falling back to EOS would
        restore exactly the non-parity SDXL tokenizer-2 padding this method exists to fix
        (same loud-failure policy as the HashTokenizer guard)."""
        import copy

        if pad_token not in self.encoder:
            raise ValueError(
                f"pad token {pad_token!r} is not in this vocab ({len(self.encoder)} entries) — "
                "a truncated or non-CLIP vocab.json? Falling back to EOS padding would "
                "silently break SDXL tokenizer-2 parity."
            )
        t = copy.copy(self)
        t.pad_id = self.encoder[pad_token]
        return t

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in _PAT.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts: str | list[str], max_len: int = MAX_LEN) -> np.ndarray:
        """Tokenize to (B, max_len) int32: BOS + ids (truncated to fit) + EOS + pad."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_id] + self.encode(t)[: max_len - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Asset-free fallback: deterministic word-hash ids. Not CLIP-compatible — only for tests
    and random-weight throughput runs where tokenizer assets are unavailable."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        self.pad_id = self.eos_id

    def __call__(self, texts: str | list[str], max_len: int = MAX_LEN) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            words = _clean(t).split()
            ids = [self.bos_id] + [
                int.from_bytes(w.encode()[:8].ljust(8, b"\0"), "little") % (self.vocab_size - 2)
                for w in words
            ][: max_len - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out
