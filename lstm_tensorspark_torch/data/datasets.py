"""Dataset registry (host side): BASELINE.md config 1's char-level corpus.

Port of ``lstm_tensorspark_tpu/data/datasets.py`` for ``ptb_char``. Real
files under ``data_path`` are used when present; otherwise the synthetic
stand-in, whose splits, vocabulary and encoded arrays are byte-equal to
the JAX package's. The other datasets of the JAX registry (wikitext2,
wikitext103, imdb, uci_electricity) are not ported yet and raise.

Returned dict: {"train", "valid", "test"} int32 token arrays, "vocab",
and "synthetic": bool.
"""

from __future__ import annotations

from .corpus import build_char_vocab, load_text, resolve_split_files, synthetic_text

# the JAX registry's other names, refused with a clear message
_NOT_PORTED = ("wikitext2", "wikitext103", "imdb", "uci_electricity")


def _lm_dataset(data_path: str | None, basenames: list[str], level: str, *,
                synthetic_tokens: int, seed: int = 0):
    if level != "char":
        raise ValueError(f"{level!r}-level datasets are not ported yet")
    files = resolve_split_files(data_path or "", basenames)
    synthetic = files is None
    if synthetic:
        texts = {
            "train": synthetic_text(synthetic_tokens, seed),
            "valid": synthetic_text(synthetic_tokens // 10, seed + 1),
            "test": synthetic_text(synthetic_tokens // 10, seed + 2),
        }
    else:
        texts = {s: load_text(p) for s, p in files.items()}
    vocab = build_char_vocab(texts["train"])
    out = {s: vocab.encode_text(t, level) for s, t in texts.items()}
    out["vocab"] = vocab
    out["synthetic"] = synthetic
    return out


def ptb_char(data_path=None, **kw):
    """BASELINE.md config 1: Penn Treebank char-level."""
    return _lm_dataset(data_path, ["ptb", "ptb.char"], "char",
                       synthetic_tokens=200_000, **kw)


DATASETS = {"ptb_char": ptb_char}


def get_dataset(name: str, data_path: str | None = None, **kw):
    if name in _NOT_PORTED:
        raise ValueError(f"dataset {name!r} is not ported to the PyTorch "
                         f"port yet (have {sorted(DATASETS)})")
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](data_path, **kw)
