"""Corpus loading and the character vocabulary (host side, numpy).

Port of ``lstm_tensorspark_tpu/data/corpus.py``: ``Vocab`` (char and word
encoding), ``build_char_vocab``, ``build_word_vocab``, ``load_text``,
``synthetic_text`` and the seed paragraph it draws from,
``synthetic_word_corpus`` (the word-level LMs' stand-in),
``resolve_split_files``. A copy, not an import: the JAX package's ``data``
package imports jax.

The real corpora are not in the repository, so every loader falls back to
a deterministic synthetic stand-in (a bigram Markov chain over the seed
paragraph, or a Zipfian pseudo-word chain for the word-level LMs, drawn
from ``numpy.random.RandomState(seed)``) that is byte-for-byte the JAX
package's.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

# Seed paragraph for the synthetic corpus generator: public-domain text
# (Lincoln, Gettysburg Address) — gives the Markov chain English-like
# structure so a language model has something learnable to fit.
_SEED_TEXT = """
four score and seven years ago our fathers brought forth on this continent a
new nation conceived in liberty and dedicated to the proposition that all men
are created equal now we are engaged in a great civil war testing whether that
nation or any nation so conceived and so dedicated can long endure we are met
on a great battle field of that war we have come to dedicate a portion of that
field as a final resting place for those who here gave their lives that that
nation might live it is altogether fitting and proper that we should do this
but in a larger sense we can not dedicate we can not consecrate we can not
hallow this ground the brave men living and dead who struggled here have
consecrated it far above our poor power to add or detract the world will
little note nor long remember what we say here but it can never forget what
they did here it is for us the living rather to be dedicated here to the
unfinished work which they who fought here have thus far so nobly advanced
"""

_SPECIALS = ("<pad>", "<unk>")


class Vocab:
    """Token ↔ id mapping. Reserved id 0 = <pad>, id 1 = <unk>."""

    PAD, UNK = 0, 1

    def __init__(self, tokens: list[str], *, reserve_special: bool = True):
        specials = list(_SPECIALS) if reserve_special else []
        self.itos = specials + [t for t in tokens if t not in _SPECIALS]
        self.stoi = {t: i for i, t in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, tokens) -> np.ndarray:
        unk = self.stoi.get("<unk>", 0)
        return np.asarray([self.stoi.get(t, unk) for t in tokens], dtype=np.int32)

    def encode_text(self, text: str, level: str) -> np.ndarray:
        """Encode raw text at the "char" or the "word" (whitespace) level.
        Tokens outside the vocabulary map to <unk>, as in the JAX package's
        native encoders — the special strings too, when raw text holds
        them."""
        unk = self.stoi.get("<unk>", 0)
        if level == "word":
            n_special = sum(1 for t in self.itos if t in _SPECIALS)
            lookup = {w: n_special + i
                      for i, w in enumerate(self.itos[n_special:])}
            return np.asarray([lookup.get(w, unk) for w in text.split()],
                              np.int32)
        if level != "char":
            raise ValueError(f"unknown encoding level {level!r}")
        # one-character entries only: the specials never occur in raw text
        chars = {c: i for c, i in self.stoi.items() if len(c) == 1}
        if text.isascii() and all(ord(c) < 128 for c in chars):
            # byte table, the same mapping as the native byte encoder
            table = np.full(256, unk, np.int32)
            for ch, idx in chars.items():
                table[ord(ch)] = idx
            return table[np.frombuffer(text.encode("ascii"), np.uint8)]
        return np.asarray([chars.get(c, unk) for c in text], np.int32)

    def decode(self, ids) -> list[str]:
        return [self.itos[int(i)] for i in ids]


def build_char_vocab(text: str) -> Vocab:
    return Vocab(sorted(set(text)))


def build_word_vocab(text: str, max_size: int | None = None) -> Vocab:
    """Whitespace words, most common first (ties in first-occurrence
    order, ``Counter.most_common``), at most ``max_size`` entries with the
    two specials."""
    n = max_size - 2 if max_size else None
    if n is not None and n <= 0:
        return Vocab([])
    return Vocab([w for w, _ in Counter(text.split()).most_common(n)])


def load_text(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read()


def synthetic_word_corpus(n_tokens: int, vocab_size: int, seed: int = 0,
                          *, noise: float = 0.05, branch: int = 20) -> str:
    """Controlled-entropy pseudo-word stream, the word-level LMs' stand-in:
    ``vocab_size`` pseudo-words ``w00000``... with a Zipfian unigram law;
    each word has a ``branch``-wide successor table drawn from that law,
    successors picked with a geometric bias, and with probability
    ``noise`` the next word is a fresh unigram draw instead. Deterministic
    per (n_tokens, vocab_size, seed, noise, branch): the same draws from
    ``numpy.random.RandomState(seed)``, in the same order, as the JAX
    package's."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    uni = 1.0 / ranks
    uni /= uni.sum()
    succ = rng.choice(vocab_size, size=(vocab_size, branch), p=uni)
    sp = 0.5 ** np.arange(branch, dtype=np.float64)
    sp /= sp.sum()
    choice_cols = rng.choice(branch, size=n_tokens, p=sp)
    noise_mask = rng.rand(n_tokens) < noise
    noise_draws = rng.choice(vocab_size, size=n_tokens, p=uni)
    succ_rows = succ.tolist()  # python lists: fast scalar indexing
    cols = choice_cols.tolist()
    nmask = noise_mask.tolist()
    ndraw = noise_draws.tolist()
    out = [0] * n_tokens
    cur = 0
    for t in range(n_tokens):
        cur = ndraw[t] if nmask[t] else succ_rows[cur][cols[t]]
        out[t] = cur
    words = [f"w{i:05d}" for i in range(vocab_size)]
    return " ".join(words[i] for i in out)


def synthetic_text(n_tokens: int, seed: int = 0) -> str:
    """Deterministic English-like word stream via a bigram Markov chain over
    the embedded seed paragraph."""
    words = _SEED_TEXT.split()
    successors: dict[str, list[str]] = {}
    for a, b in zip(words[:-1], words[1:]):
        successors.setdefault(a, []).append(b)
    rng = np.random.RandomState(seed)
    out = [words[0]]
    for _ in range(n_tokens - 1):
        nxt = successors.get(out[-1])
        if not nxt:
            nxt = words
        out.append(nxt[rng.randint(len(nxt))])
    return " ".join(out)


def resolve_split_files(data_path: str, basenames: list[str]) -> dict[str, str] | None:
    """Find train/valid/test files under data_path matching any of the
    conventional naming schemes; None if absent."""
    if not data_path or not os.path.isdir(data_path):
        return None
    for pattern in ("{b}.{s}.txt", "{s}.txt", "{b}.{s}.tokens"):
        for b in basenames:
            files = {
                s: os.path.join(data_path, pattern.format(b=b, s=s))
                for s in ("train", "valid", "test")
            }
            if all(os.path.isfile(p) for p in files.values()):
                return files
    return None
