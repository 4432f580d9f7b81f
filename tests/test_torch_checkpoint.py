"""The port's checkpoints (lstm_tensorspark_torch/train/checkpoint.py) and
the JAX checkpoint reader (train/jax_checkpoint.py), on the CPU.

- The single-process cases of tests/test_checkpoint_corruption.py, on the
  port's ``step_<N>.pt`` files: the sidecar written and verified, a
  truncated newest step quarantined with a fall back to the next, a one-bit
  flip caught by the checksum, all corrupt -> None, a legacy file without
  a sidecar restored, keep-N cleanup taking sidecars along, a verified file
  that does not fit the run re-raised (never quarantined), a quarantine
  that cannot rename still ending, a transient OSError not quarantined, an
  interrupted overwrite never pairing new bytes with an old hash.
- The train command's refusals (``wire_checkpoint``) and the serve
  command's: all corrupt under ``--resume`` or serve -> SystemExit, an empty
  directory under ``--resume`` -> a fresh start.
- ``train --resume`` bit for bit against one uninterrupted run: a stateful
  2-layer LM with dropout, host-fed at K=1 and fed from the device at K=4,
  and the classifier.
- JAX's Checkpointer writes a TrainState; the port's reader returns its
  params bit for bit, and the port's msgpack decoder agrees with the
  msgpack package on every type flax writes.
"""

import argparse
import json
import os
import shutil

import jax
import msgpack
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_to_numpy
from lstm_tensorspark_torch.train import checkpoint as ckmod
from lstm_tensorspark_torch.train import jax_checkpoint as jck
from lstm_tensorspark_torch.train.checkpoint import (CorruptCheckpointError,
                                                     Checkpointer,
                                                     atomic_write,
                                                     read_verified,
                                                     wire_checkpoint)
from lstm_tensorspark_torch.train.loop import (TrainState, checkpoint_state,
                                               init_train_state,
                                               restore_state)
from lstm_tensorspark_torch.train.optimizer import make_optimizer


def _state(step: int, w: float, n: int = 4) -> TrainState:
    params = {"w": torch.full((n,), w)}
    s = init_train_state(params, make_optimizer("sgd", 0.1))
    return s._replace(step=step)


def _save_steps(ckpt, steps):
    for i, step in enumerate(steps):
        ckpt.save(checkpoint_state(_state(step, float(i + 1))))


def _restore(ckpt, like=None):
    like = like or _state(0, 0.0)
    out = ckpt.restore_latest(lambda saved: restore_state(like, saved))
    return None if out is None else out[0]


def test_sidecar_written_and_restore_verifies(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    assert os.path.exists(tmp_path / "step_2.pt.sha256")
    restored = _restore(ckpt)
    assert restored.step == 2 and float(restored.params["w"][0]) == 1.0
    assert ckpt.latest_step() == 2 and ckpt.has_checkpoint()


def test_truncated_newest_falls_back_and_quarantines(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2, 4])
    path = tmp_path / "step_4.pt"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])  # a torn write
    restored = _restore(ckpt)
    assert restored.step == 2 and float(restored.params["w"][0]) == 1.0
    assert os.path.exists(tmp_path / "step_4.pt.quarantined")
    assert not os.path.exists(tmp_path / "step_4.pt")
    assert ckpt.has_quarantined()
    assert _restore(ckpt).step == 2  # the fall back is durable


def test_single_bit_flip_detected_by_checksum(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2, 4])
    path = tmp_path / "step_4.pt"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(CorruptCheckpointError, match="sha256"):
        read_verified(str(path))
    assert _restore(ckpt).step == 2


def test_all_corrupt_returns_none(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    (tmp_path / "step_2.pt").write_bytes(b"garbage")
    assert _restore(ckpt) is None
    assert not ckpt.has_checkpoint() and ckpt.has_quarantined()


def test_legacy_checkpoint_without_sidecar_still_restores(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    os.remove(tmp_path / "step_2.pt.sha256")
    assert _restore(ckpt).step == 2
    # a legacy file that does not parse is corruption: quarantined
    (tmp_path / "step_2.pt").write_bytes(b"garbage")
    assert _restore(ckpt) is None
    assert os.path.exists(tmp_path / "step_2.pt.quarantined")


def test_cleanup_removes_sidecars_with_payloads(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    _save_steps(ckpt, [2, 4, 6, 8])
    names = set(os.listdir(tmp_path))
    assert not any(n.startswith(("step_2.", "step_4.")) for n in names), names
    assert {"step_6.pt", "step_6.pt.sha256", "step_8.pt",
            "step_8.pt.sha256"} == names


def test_config_mismatch_raises_instead_of_quarantining(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    with pytest.raises(ValueError, match="model or optimizer flags differ"):
        _restore(ckpt, like=_state(0, 0.0, n=5))
    with pytest.raises(ValueError, match="optimizer state"):
        like = init_train_state({"w": torch.zeros(4)},
                                make_optimizer("adam", 1e-3))
        _restore(ckpt, like=like)
    assert os.path.exists(tmp_path / "step_2.pt")  # untouched
    assert not ckpt.has_quarantined()


def test_unrenamable_quarantine_still_terminates(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    (tmp_path / "step_2.pt").write_bytes(b"garbage")
    monkeypatch.setattr(Checkpointer, "_quarantine",
                        lambda self, step, reason: None)
    assert _restore(ckpt) is None
    assert os.path.exists(tmp_path / "step_2.pt")


def test_transient_io_error_not_quarantined(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])

    def eio(path):
        raise OSError("EIO")

    monkeypatch.setattr(ckmod, "read_verified", eio)
    with pytest.raises(OSError, match="EIO"):
        _restore(ckpt)
    assert os.path.exists(tmp_path / "step_2.pt")
    assert not ckpt.has_quarantined()


def test_overwrite_crash_never_pairs_new_bytes_with_old_hash(tmp_path,
                                                             monkeypatch):
    path = str(tmp_path / "f.bin")
    atomic_write(path, b"old bytes", checksum=True)
    orig = os.replace

    def crash_after_payload(src, dst):
        orig(src, dst)
        if dst == path:
            raise KeyboardInterrupt  # a crash right after the payload lands

    monkeypatch.setattr(os, "replace", crash_after_payload)
    with pytest.raises(KeyboardInterrupt):
        atomic_write(path, b"new bytes", checksum=True)
    monkeypatch.setattr(os, "replace", orig)
    assert not os.path.exists(path + ".sha256")  # legacy, not a mismatch
    assert read_verified(path) == b"new bytes"
    assert not any(".tmp" in n for n in os.listdir(tmp_path)
                   if n.endswith(".sha256"))


class _Logger:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _args(d, resume=True):
    return argparse.Namespace(checkpoint_dir=str(d), resume=resume)


def test_wire_checkpoint_refusals_and_fresh_start(tmp_path):
    # an empty directory under --resume is a fresh start
    state, start, fn = wire_checkpoint(_args(tmp_path / "empty"), _Logger(),
                                       _state(0, 0.0), [])
    assert state.step == 0 and start == 0 and fn is not None
    # every checkpoint corrupt: refuse, and keep refusing after the
    # quarantine left nothing to find
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    (tmp_path / "step_2.pt").write_bytes(b"garbage")
    with pytest.raises(SystemExit, match="failed verification"):
        wire_checkpoint(_args(tmp_path), _Logger(), _state(0, 0.0), [])
    with pytest.raises(SystemExit, match="quarantined"):
        wire_checkpoint(_args(tmp_path), _Logger(), _state(0, 0.0), [])
    # a valid one restores the state and the generators' states
    d = tmp_path / "ok"
    gen = torch.Generator().manual_seed(5)
    torch.rand(7, generator=gen)
    Checkpointer(str(d)).save(checkpoint_state(_state(3, 2.0), [gen]))
    want = torch.rand(3, generator=gen)
    gen2 = torch.Generator().manual_seed(99)
    log = _Logger()
    state, start, _ = wire_checkpoint(_args(d), log, _state(0, 0.0), [gen2])
    assert state.step == start == 3 and float(state.params["w"][0]) == 2.0
    assert torch.equal(torch.rand(3, generator=gen2), want)
    assert log.records == [{"note": "resumed at step 3"}]


def test_cli_refusals(tmp_path):
    from lstm_tensorspark_torch.exit_codes import USAGE_RC

    base = ["train", "--device", "cpu", "--num-steps", "1"]
    assert tcli.main(base + ["--resume"]) == USAGE_RC
    assert tcli.main(base + ["--checkpoint-every", "2"]) == USAGE_RC
    assert tcli.main(base + ["--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "-1"]) == USAGE_RC
    # serve: no checkpoint, and all corrupt, are refused
    serve = ["serve", "--selftest", "--device", "cpu", "--checkpoint-dir"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main(serve + [str(tmp_path / "none")])
    ckpt = Checkpointer(str(tmp_path), keep=5)
    _save_steps(ckpt, [2])
    (tmp_path / "step_2.pt").write_bytes(b"garbage")
    with pytest.raises(SystemExit, match="corrupt"):
        tcli.main(serve + [str(tmp_path)])


LM_FLAGS = ["train", "--device", "cpu", "--hidden-units", "16",
            "--num-layers", "2", "--batch-size", "4", "--seq-len", "8",
            "--num-steps", "12", "--log-every", "1", "--stateful",
            "--dropout", "0.3", "--learning-rate", "0.5",
            "--compute-dtype", "float32"]
IMDB_FLAGS = ["train", "--dataset", "imdb", "--device", "cpu",
              "--hidden-units", "8", "--batch-size", "4", "--seq-len", "24",
              "--num-steps", "12", "--log-every", "1", "--dropout", "0.2",
              "--optimizer", "adam", "--learning-rate", "1e-3",
              "--compute-dtype", "float32"]


def _losses(jl):
    return {r["step"]: r["loss"] for r in map(json.loads, open(jl))
            if "loss" in r and "note" not in r}


@pytest.mark.parametrize("flags,every", [
    (LM_FLAGS, 3),
    (LM_FLAGS + ["--steps-per-call", "4", "--device-data"], 1),
    (LM_FLAGS + ["--steps-per-call", "2", "--compute-dtype", "bfloat16"],
     2),
    (IMDB_FLAGS, 3),
], ids=["lm-host-k1", "lm-device-data-k4", "lm-bf16-k2", "imdb"])
def test_cli_resume_bit_exact(tmp_path, flags, every):
    """Stop after the first checkpoints, resume from the oldest one kept:
    every loss after it equals the uninterrupted run's bit for bit (the
    params, optimizer state, carries, dropout generator and data cursor
    all restored)."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert tcli.main(flags + ["--checkpoint-dir", str(a), "--checkpoint-every",
                              str(every), "--jsonl",
                              str(tmp_path / "a.jsonl")]) == 0
    kept = sorted(int(n[5:-3]) for n in os.listdir(a) if n.endswith(".pt"))
    assert len(kept) == 3 and kept[-1] == 12
    mid = kept[0]
    os.makedirs(b)
    for suffix in (".pt", ".pt.sha256"):
        shutil.copy(a / f"step_{mid}{suffix}", b / f"step_{mid}{suffix}")
    assert tcli.main(flags + ["--checkpoint-dir", str(b), "--resume",
                              "--jsonl", str(tmp_path / "b.jsonl")]) == 0
    whole, resumed = _losses(tmp_path / "a.jsonl"), _losses(tmp_path /
                                                            "b.jsonl")
    assert sorted(resumed) == [s for s in sorted(whole) if s > mid]
    assert all(whole[s] == resumed[s] for s in resumed), (whole, resumed)
    notes = [r.get("note") for r in map(json.loads, open(tmp_path / "b.jsonl"))]
    assert f"resumed at step {mid}" in notes


# ---------------------------------------------------------------------------
# the JAX checkpoint reader
# ---------------------------------------------------------------------------


def test_msgpack_decoder_matches_the_msgpack_package():
    doc = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32,
                    2**63 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                    -2**31 - 1, -2**63],
           "floats": [0.5, -1.25e300, float("inf")],
           "str": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
           "bin": [b"", b"x" * 300, b"y" * 70000],
           "nil": None, "bools": [True, False],
           "big": {str(i): i for i in range(20)},
           "list": list(range(20))}
    assert jck.decode(msgpack.packb(doc, use_bin_type=True)) == doc
    assert jck.decode(msgpack.packb(1.5, use_single_float=True)) == 1.5
    ext = msgpack.ExtType(7, b"abc")
    with pytest.raises(ValueError, match="ext type 7"):
        jck.decode(msgpack.packb(ext))
    with pytest.raises(ValueError, match="truncated"):
        jck.decode(msgpack.packb(doc, use_bin_type=True)[:-3])


def test_decoder_reads_flax_arrays_scalars_and_chunks(monkeypatch):
    from flax import serialization

    rng = np.random.RandomState(0)
    tree = {"f": rng.randn(3, 5).astype(np.float32),
            "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "s": np.float32(2.5), "c": 1 + 2j,
            "b": jax.numpy.asarray(rng.randn(4), jax.numpy.bfloat16)}
    got = jck.decode(serialization.msgpack_serialize(tree))
    for k in ("f", "i"):
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k])
    assert got["s"] == np.float32(2.5) and got["c"] == 1 + 2j
    np.testing.assert_array_equal(got["b"], np.asarray(tree["b"], np.float32))
    # an array above flax's chunk size is written in chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    big = {"params": {"w": rng.randn(5, 7).astype(np.float32)}}
    data = serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    out = jck._unchunk(jck.decode(data))
    np.testing.assert_array_equal(out["params"]["w"], big["params"]["w"])


def _jax_lm_checkpoint(tmp_path, steps):
    """A JAX TrainState of a 2-layer LM (untied and tied heads, Adam)
    saved by JAX's Checkpointer at each of ``steps``; returns the params
    of each step as numpy."""
    from lstm_tensorspark_tpu.models import LMConfig, init_lm
    from lstm_tensorspark_tpu.train import make_optimizer as jopt
    from lstm_tensorspark_tpu.train.checkpoint import Checkpointer as JCk
    from lstm_tensorspark_tpu.train.loop import init_train_state as jinit

    cfg = LMConfig(vocab_size=23, hidden_size=12, num_layers=2)
    out = {}
    ck = JCk(str(tmp_path), keep=5)
    for i, step in enumerate(steps):
        params = init_lm(jax.random.PRNGKey(i), cfg)
        st = jinit(params, jopt("adam", 1e-3), jax.random.PRNGKey(0))
        ck.save(st._replace(step=jax.numpy.asarray(step, jax.numpy.int32)))
        out[step] = jax.tree.map(np.asarray, params)
    return cfg, out


def test_jax_checkpoint_params_bit_for_bit(tmp_path):
    cfg, want = _jax_lm_checkpoint(tmp_path, [3, 7])
    got = jck.read_params(str(tmp_path / "step_7.msgpack"))
    from lstm_tensorspark_torch.convert import params_from_numpy

    port = params_to_numpy(params_from_numpy(got, device="cpu"))
    ref = want[7]
    np.testing.assert_array_equal(port["embedding"], ref["embedding"])
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(port["head"][k], ref["head"][k])
    for pl, rl in zip(port["layers"], ref["layers"]):
        for f, arr in pl.items():
            np.testing.assert_array_equal(arr, np.asarray(getattr(rl, f)))
    # the Checkpointer's jax format: newest valid step, quarantine on a
    # flipped bit, and the fall back to step 3
    ck = Checkpointer(str(tmp_path), fmt="jax")
    assert ck.latest_step() == 7
    path = tmp_path / "step_7.msgpack"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    path.write_bytes(bytes(raw))
    state = ck.restore_latest(jck.params_tree)
    np.testing.assert_array_equal(state["embedding"], want[3]["embedding"])
    assert os.path.exists(tmp_path / "step_7.msgpack.quarantined")
    with pytest.raises(ValueError, match="read only"):
        ck.save({"step": 1})
