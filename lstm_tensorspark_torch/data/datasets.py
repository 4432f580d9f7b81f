"""Dataset registry (host side): BASELINE.md config 1's char-level corpus,
config 2's IMDB sentiment examples and the word-level corpora of configs 3
and 5.

Port of ``lstm_tensorspark_tpu/data/datasets.py`` for ``ptb_char``,
``imdb``, ``wikitext2`` and ``wikitext103``. Real files under
``data_path`` are used when present; otherwise the synthetic stand-in,
whose splits, vocabulary and encoded arrays are byte-equal to the JAX
package's (the word-level stand-ins are regenerated in every process: the
JAX package's on-disk cache of the stream is an optimisation the port
does without). ``uci_electricity`` is not ported yet and raises.

Returned dict: {"train", "valid", "test"} int32 token arrays (LM) or
(sequences, labels) pairs (classification), "vocab", and "synthetic":
bool.
"""

from __future__ import annotations

import os

import numpy as np

from .corpus import (build_char_vocab, build_word_vocab, load_text,
                     resolve_split_files, synthetic_text,
                     synthetic_word_corpus)

# the JAX registry's other names, refused with a clear message
_NOT_PORTED = ("uci_electricity",)


def _lm_dataset(data_path: str | None, basenames: list[str], level: str, *,
                synthetic_tokens: int, max_vocab: int | None = None,
                seed: int = 0, synthetic_vocab: int | None = None,
                synthetic_noise: float = 0.05):
    files = resolve_split_files(data_path or "", basenames)
    synthetic = files is None
    if synthetic and synthetic_vocab is not None:
        # the word-level stand-in: one stream of one chain, sliced, so the
        # valid and test splits are held-out samples of the same process
        stream = synthetic_word_corpus(int(synthetic_tokens * 1.2),
                                       synthetic_vocab, seed=seed,
                                       noise=synthetic_noise).split()
        n, tenth = synthetic_tokens, synthetic_tokens // 10
        texts = {
            "train": " ".join(stream[:n]),
            "valid": " ".join(stream[n:n + tenth]),
            "test": " ".join(stream[n + tenth:n + 2 * tenth]),
        }
    elif synthetic:
        texts = {
            "train": synthetic_text(synthetic_tokens, seed),
            "valid": synthetic_text(synthetic_tokens // 10, seed + 1),
            "test": synthetic_text(synthetic_tokens // 10, seed + 2),
        }
    else:
        texts = {s: load_text(p) for s, p in files.items()}
    if level == "char":
        vocab = build_char_vocab(texts["train"])
    else:
        vocab = build_word_vocab(texts["train"], max_vocab)
    out = {s: vocab.encode_text(t, level) for s, t in texts.items()}
    out["vocab"] = vocab
    out["synthetic"] = synthetic
    return out


def ptb_char(data_path=None, **kw):
    """BASELINE.md config 1: Penn Treebank char-level."""
    return _lm_dataset(data_path, ["ptb", "ptb.char"], "char",
                       synthetic_tokens=200_000, **kw)


def wikitext2_word(data_path=None, **kw):
    """BASELINE.md config 3: WikiText-2 word-level. Stand-in: a
    1,000-word controlled-entropy chain (``synthetic_word_corpus``)."""
    kw.setdefault("synthetic_vocab", 1_000)
    kw.setdefault("synthetic_noise", 0.05)
    return _lm_dataset(data_path, ["wiki", "wikitext-2"], "word",
                       synthetic_tokens=400_000, max_vocab=33_278, **kw)


def wikitext103_word(data_path=None, **kw):
    """BASELINE.md config 5: WikiText-103 word-level. Stand-in: a
    5,000-word controlled-entropy chain, 2M training tokens."""
    kw.setdefault("synthetic_vocab", 5_000)
    kw.setdefault("synthetic_noise", 0.1)
    return _lm_dataset(data_path, ["wiki", "wikitext-103"], "word",
                       synthetic_tokens=2_000_000, max_vocab=50_000, **kw)


def _resolve_imdb_root(data_path: str | None) -> str | None:
    """Locate the aclImdb layout ``<root>/{train,test}/{pos,neg}/*.txt``:
    the aclImdb directory itself or a parent holding it; None when absent
    (synthetic stand-in)."""
    if not data_path or not os.path.isdir(data_path):
        return None
    for root in (data_path, os.path.join(data_path, "aclImdb")):
        if all(os.path.isdir(os.path.join(root, split, label))
               for split in ("train", "test") for label in ("pos", "neg")):
            return root
    return None


def _read_imdb_split(root: str, split: str, max_examples: int | None = None):
    """One aclImdb split as (texts, labels), positives first, files in
    sorted order."""
    texts, labels = [], []
    for label_name, label in (("pos", 1), ("neg", 0)):
        d = os.path.join(root, split, label_name)
        names = [n for n in sorted(os.listdir(d)) if n.endswith(".txt")]
        if max_examples is not None:
            names = names[: max_examples // 2]
        for name in names:
            with open(os.path.join(d, name), encoding="utf-8",
                      errors="replace") as f:
                texts.append(f.read())
            labels.append(label)
    return texts, labels


def _imdb_real(root: str, *, max_len: int, max_vocab: int = 25_000,
               valid_frac: float = 0.1, max_examples: int | None = None,
               seed: int = 0):
    """aclImdb → word-id sequences clipped to ``max_len``, labels, and the
    train split's vocabulary; the valid split is a seeded shuffle's head of
    the train split."""
    train_texts, train_labels = _read_imdb_split(root, "train", max_examples)
    test_texts, test_labels = _read_imdb_split(root, "test", max_examples)
    vocab = build_word_vocab(" ".join(train_texts), max_vocab)

    def encode(texts, labels):
        seqs = [vocab.encode_text(t, "word")[:max_len] for t in texts]
        return seqs, np.asarray(labels, np.int32)

    # interleave pos/neg before the valid split so both splits stay balanced
    order = np.random.RandomState(seed).permutation(len(train_texts))
    train_texts = [train_texts[i] for i in order]
    train_labels = [train_labels[i] for i in order]
    n_valid = int(len(train_texts) * valid_frac)
    seqs, labels = encode(train_texts, train_labels)
    test_seqs, test_labels = encode(test_texts, test_labels)
    return {
        "train": (seqs[n_valid:], labels[n_valid:]),
        "valid": (seqs[:n_valid], labels[:n_valid]),
        "test": (test_seqs, test_labels),
        "vocab": vocab,
        "num_classes": 2,
        "max_len": max_len,
        "synthetic": False,
    }


def imdb(data_path=None, *, num_examples: int | None = None,
         max_len: int = 400, seed: int = 0, signal: float = 0.25):
    """BASELINE.md config 2: binary sentiment over variable-length
    sequences. Real data: ``data_path`` at the aclImdb directory (or its
    parent). Otherwise the synthetic stand-in: two word distributions
    shifted by class (``signal`` the class-specific token fraction),
    lengths log-uniform in [20, max_len], labels alternating; 80/10/10
    train/valid/test of ``num_examples`` (default 2000)."""
    root = _resolve_imdb_root(data_path)
    if root is not None:
        return _imdb_real(root, max_len=max_len, seed=seed,
                          max_examples=num_examples)
    num_examples = num_examples or 2000
    rng = np.random.RandomState(seed)
    vocab = build_word_vocab(synthetic_text(50_000, seed))
    V = len(vocab)
    pos_words = np.arange(2, V, 2)
    neg_words = np.arange(3, V, 2)
    sequences, labels = [], []
    for i in range(num_examples):
        label = i % 2
        length = int(np.exp(rng.uniform(np.log(20), np.log(max_len))))
        base = pos_words if label else neg_words
        mix = rng.rand(length) < signal  # class-specific vs shared noise
        seq = np.where(
            mix, base[rng.randint(len(base), size=length)],
            rng.randint(2, V, size=length),
        ).astype(np.int32)
        sequences.append(seq)
        labels.append(label)
    labels = np.asarray(labels, np.int32)
    n_train = int(num_examples * 0.8)
    n_valid = int(num_examples * 0.1)
    return {
        "train": (sequences[:n_train], labels[:n_train]),
        "valid": (sequences[n_train:n_train + n_valid],
                  labels[n_train:n_train + n_valid]),
        "test": (sequences[n_train + n_valid:], labels[n_train + n_valid:]),
        "vocab": vocab,
        "num_classes": 2,
        "max_len": max_len,
        "synthetic": True,
    }


DATASETS = {"ptb_char": ptb_char, "wikitext2": wikitext2_word,
            "wikitext103": wikitext103_word, "imdb": imdb}


def get_dataset(name: str, data_path: str | None = None, **kw):
    if name in _NOT_PORTED:
        raise ValueError(f"dataset {name!r} is not ported to the PyTorch "
                         f"port yet (have {sorted(DATASETS)})")
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](data_path, **kw)
