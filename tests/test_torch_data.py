"""The port's data pipeline against the JAX package's, byte for byte.

``ptb_char`` (BASELINE.md config 1's corpus; here its synthetic stand-in,
as no corpus files are in the repository) must give the same vocabulary
and the same int32 train/valid/test arrays, and ``lm_batch_stream`` the
same windows, with and without a ``start_step`` fast-forward.
"""

import itertools

import numpy as np
import pytest

from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import corpus as tcorpus
from lstm_tensorspark_torch.data import datasets as tdata
from lstm_tensorspark_tpu.data import batching as jbatch
from lstm_tensorspark_tpu.data import corpus as jcorpus
from lstm_tensorspark_tpu.data import datasets as jdata


@pytest.fixture(scope="module")
def both():
    return tdata.get_dataset("ptb_char"), jdata.get_dataset("ptb_char")


def test_ptb_char_splits_and_vocab_byte_equal(both):
    t, j = both
    assert t["synthetic"] is True and j["synthetic"] is True
    assert t["vocab"].itos == j["vocab"].itos
    for split in ("train", "valid", "test"):
        assert t[split].dtype == np.int32
        assert t[split].tobytes() == j[split].tobytes(), split


@pytest.mark.parametrize("start_step", [0, 5, 3000])
def test_lm_batch_stream_byte_equal(both, start_step):
    """Windows of a stateful B=64, T=64 stream (config 1) and of a small
    one, from the start and fast-forwarded (3000 crosses an epoch)."""
    tokens = both[0]["train"]
    for B, T in ((64, 64), (4, 16)):
        a = itertools.islice(tbatch.lm_batch_stream(tokens, B, T,
                                                    start_step=start_step), 6)
        b = itertools.islice(jbatch.lm_batch_stream(tokens, B, T,
                                                    start_step=start_step), 6)
        for x, y in zip(a, b):
            for k in ("inputs", "targets"):
                assert x[k].dtype == y[k].dtype
                assert np.ascontiguousarray(x[k]).tobytes() == \
                    np.ascontiguousarray(y[k]).tobytes()


def test_epoch_batches_windows_and_cap(both):
    tokens = both[0]["valid"]
    assert tbatch.lm_windows(tokens, 8, 32)[2] == \
        jbatch.lm_windows(tokens, 8, 32)[2]
    got = list(tbatch.cap_batches(tbatch.lm_epoch_batches(tokens, 8, 32), 3))
    ref = list(jbatch.cap_batches(jbatch.lm_epoch_batches(tokens, 8, 32), 3))
    assert len(got) == len(ref) == 3
    for x, y in zip(got, ref):
        assert np.array_equal(x["inputs"], y["inputs"])
        assert np.array_equal(x["targets"], y["targets"])
    with pytest.raises(ValueError, match="too small"):
        tbatch.lm_windows(tokens[:10], 8, 32)


@pytest.mark.parametrize("text", ["hello world", "naïve café—x",
                                  "zz <unk> q"])
def test_encode_text_matches_jax(text):
    """Char ids equal the JAX encoder's for ASCII text (its byte table)
    and for text outside ASCII (its per-char path); characters outside the
    vocabulary map to <unk>."""
    tv = tcorpus.build_char_vocab("hello world café")
    jv = jcorpus.build_char_vocab("hello world café")
    assert tv.itos == jv.itos
    assert tv.encode_text(text, "char").tolist() == \
        jv.encode_text(text, "char").tolist()
    assert tcorpus.synthetic_text(50, 4) == jcorpus.synthetic_text(50, 4)


def test_unported_datasets_raise():
    """Every name of the JAX registry is ported (``uci_electricity`` gives
    its stand-in); an unknown name raises."""
    data = tdata.get_dataset("uci_electricity")
    assert data["synthetic"] and data["num_features"] == 8
    assert data["train"].shape == (8000, 8)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_dataset("nope")
