"""The port's model registry against the JAX package's, on the CPU.

- The cases of ``tests/test_serve_registry.py`` (round trip, auto-versioning
  and immutability, bad ids, peer adoption by ``scan``, an orphan payload
  adopted, truncation and a bit flip quarantined), each run on the port's
  ``ModelRegistry`` and on JAX's, which must behave alike.
- Across the packages: ``jax_checkpoint.encode`` of a bridged params tree
  equals ``flax.serialization.to_bytes`` of JAX's byte for byte (float32 and
  bfloat16 leaves, and a tree above flax's chunk limit, both limits
  lowered); an artifact JAX's registry published (``params`` and
  ``best_state``) loads in the port with equal values; one the port
  published loads in JAX's ``load_params`` under the sha256 JAX gives the
  same params; ``config_fingerprint`` agrees for the same model over
  width, layers, tying, compute and logits dtype.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import registry as treg
from lstm_tensorspark_torch.train import jax_checkpoint as tjc
from lstm_tensorspark_torch.train.loop import param_leaves
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.serve import registry as jreg
from lstm_tensorspark_tpu.train.checkpoint import atomic_write

REGISTRIES = {"torch": treg, "jax": jreg}
V, H = 29, 16


def _models(L=1, tied=False):
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                    tie_embeddings=tied)
    # jax.device_get: the pytree order the JAX package publishes in
    jparams = jax.device_get(init_lm(jax.random.PRNGKey(3), jcfg))
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        tie_embeddings=tied)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _equal(tparams, jparams):
    got = [t.numpy() for t in param_leaves(tparams)]
    want = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---- the JAX package's cases, on both registries ---------------------------


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_publish_load_roundtrip(tmp_path, pkg):
    jcfg, jparams, tcfg, tparams = _models()
    reg = REGISTRIES[pkg].ModelRegistry(str(tmp_path))
    if pkg == "jax":
        payload, template = serialization.to_bytes(jparams), jparams
    else:
        payload, template = treg.encode_params(tparams), tparams
    meta = reg.publish("m", payload, config_hash="cafe",
                       parent="best.msgpack @ step 7")
    assert meta["version"] == 1 and meta["kind"] == "params"
    got_meta, got = reg.load_params("m", template)
    assert got_meta["parent"] == "best.msgpack @ step 7"
    if pkg == "jax":
        got = params_from_numpy(jax.tree.map(np.asarray, got), device="cpu")
    _equal(got, jparams)


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_auto_versioning_and_immutability(tmp_path, pkg):
    reg = REGISTRIES[pkg].ModelRegistry(str(tmp_path))
    assert reg.publish("m", b"one")["version"] == 1
    assert reg.publish("m", b"two")["version"] == 2
    with pytest.raises(ValueError, match="immutable"):
        reg.publish("m", b"redo", version=2)
    assert reg.latest("m")["version"] == 2
    _, payload = reg.load_bytes("m", 1)
    assert payload == b"one"


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_bad_ids_and_unknown_lookups(tmp_path, pkg):
    mod = REGISTRIES[pkg]
    reg = mod.ModelRegistry(str(tmp_path))
    for bad in ("", "a/b", "x__v1"):
        with pytest.raises(ValueError):
            reg.publish(bad, b"p")
    with pytest.raises(ValueError, match="unknown artifact kind"):
        reg.publish("m", b"p", kind="weights")
    with pytest.raises(mod.RegistryError, match="unknown model"):
        reg.meta("ghost")
    reg.publish("m", b"p")
    with pytest.raises(mod.RegistryError, match="no version 9"):
        reg.load_bytes("m", 9)


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_peer_adoption_via_scan(tmp_path, pkg):
    """A second registry over the same directory indexes what the first
    published once it rescans; the filesystem is the only coordination."""
    mod = REGISTRIES[pkg]
    a = mod.ModelRegistry(str(tmp_path))
    a.publish("m", b"v1-bytes")
    b = mod.ModelRegistry(str(tmp_path))
    assert b.models() == {"m": [1]}
    a.publish("m", b"v2-bytes")
    assert b.models() == {"m": [1]}  # stale until rescan, by design
    assert b.scan() == {"m": [1, 2]}
    assert b.models() == {"m": [1, 2]}
    assert b.stats()["artifacts"] == 2


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_orphan_payload_adopted_with_reconstructed_meta(tmp_path, pkg):
    reg = REGISTRIES[pkg].ModelRegistry(str(tmp_path))
    reg.publish("m", b"payload")
    os.remove(tmp_path / "m__v000001.json")
    reg.scan()
    meta = reg.meta("m", 1)
    assert meta["kind"] == "params" and meta["payload_bytes"] == 7
    assert meta["sha256"] == hashlib.sha256(b"payload").hexdigest()


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
@pytest.mark.parametrize("when", ["truncated_before_scan",
                                  "bit_flip_after_index"])
def test_corrupt_artifact_quarantined(tmp_path, pkg, when):
    """Corruption is caught by the scan (a truncated payload) or by the
    per-load verification (a bit flip after indexing): the artifact is
    quarantined, leaves the manifest, and is never served."""
    mod = REGISTRIES[pkg]
    reg = mod.ModelRegistry(str(tmp_path))
    reg.publish("m", b"A" * 64)
    path = tmp_path / "m__v000001.msgpack"
    if when == "truncated_before_scan":
        path.write_bytes(b"A" * 10)
        reg = mod.ModelRegistry(str(tmp_path))
        assert reg.models() == {}
        with pytest.raises(mod.RegistryError):
            reg.load_bytes("m", 1)
    else:
        blob = bytearray(path.read_bytes())
        blob[13] ^= 0x40
        path.write_bytes(bytes(blob))
        with pytest.raises(mod.RegistryError, match="quarantined"):
            reg.load_bytes("m")
        assert reg.models() == {}
    assert reg.quarantined == 1
    for suffix in ("", ".sha256"):
        assert (tmp_path / f"m__v000001.msgpack{suffix}.quarantined").exists()
    reg.publish("other", b"fine")  # a sibling model is unaffected
    assert reg.load_bytes("other")[1] == b"fine"


def test_load_params_refuses_another_shape(tmp_path):
    _, jparams, _, _ = _models(L=1)
    reg = treg.ModelRegistry(str(tmp_path))
    reg.publish("m", serialization.to_bytes(jparams))
    for L, tied in ((2, False), (1, True)):
        with pytest.raises(ValueError, match="artifact has head"):
            reg.load_params("m", _models(L=L, tied=tied)[3])
    wide = tlm.init_lm(torch.Generator().manual_seed(0),
                       tlm.LMConfig(vocab_size=V, hidden_size=2 * H))
    with pytest.raises(ValueError, match="artifact param"):
        reg.load_params("m", wide)


# ---- across the packages ----------------------------------------------------


@pytest.mark.parametrize("case", ["float32", "bfloat16", "chunked"])
def test_encode_equals_flax_to_bytes(monkeypatch, case):
    """The port's writer gives flax's bytes for the same tree; under a
    lowered chunk limit (both packages') the embedding and the head's
    kernel are written as chunked maps."""
    _, jparams, _, tparams = _models(L=2)
    if case == "chunked":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 600)
        monkeypatch.setattr(tjc, "MAX_CHUNK_SIZE", 600)
    if case == "bfloat16":
        jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
        layers = [{f: getattr(layer, f).to(torch.bfloat16)
                   for f in layer._fields} for layer in tparams["layers"]]
        got = tjc.encode({
            "embedding": tparams["embedding"].to(torch.bfloat16),
            "head": {k: tparams["head"][k].to(torch.bfloat16)
                     for k in sorted(tparams["head"])},
            "layers": layers})
    else:
        jtree = jparams
        got = treg.encode_params(tparams)
    want = serialization.to_bytes(jtree)
    assert got == want
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in got
    # and the port's decoder reads it back to the same values
    back = tjc.params_tree({"params": tjc.decode(got)})
    np.testing.assert_array_equal(
        back["embedding"],
        np.asarray(jtree["embedding"]).astype(np.float32))


def _write_best(ckpt_dir, params, step=5, value=1.25):
    """The single-process best artifact as the JAX package's Checkpointer
    writes it: msgpack {step, value, state=to_bytes(state)} and sidecar."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = serialization.msgpack_serialize({
        "step": step, "value": value,
        "state": serialization.to_bytes({"params": params}),
    })
    path = os.path.join(ckpt_dir, "best.msgpack")
    atomic_write(path, payload, checksum=True)
    return path


@pytest.mark.parametrize("kind", ["params", "best_state"])
def test_jax_published_artifact_loads_in_the_port(tmp_path, kind):
    jcfg, jparams, tcfg, tparams = _models(L=2)
    reg_dir = str(tmp_path / "reg")
    jr = jreg.ModelRegistry(reg_dir)
    if kind == "params":
        payload = serialization.to_bytes(jparams)
    else:
        with open(_write_best(str(tmp_path / "ckpt"), jparams), "rb") as f:
            payload = f.read()
    jmeta = jr.publish("default", payload, kind=kind,
                       config_hash=jreg.config_fingerprint(jcfg))
    template = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    meta, got = treg.ModelRegistry(reg_dir).load_params("default", template)
    assert meta == jmeta
    assert meta["config_hash"] == treg.config_fingerprint(tcfg)
    _equal(got, jparams)


def test_port_published_artifact_loads_in_jax(tmp_path):
    jcfg, jparams, tcfg, tparams = _models(L=2, tied=True)
    meta = treg.ModelRegistry(str(tmp_path)).publish(
        "default", treg.encode_params(tparams),
        config_hash=treg.config_fingerprint(tcfg))
    assert meta["sha256"] == hashlib.sha256(
        serialization.to_bytes(jparams)).hexdigest()
    with open(tmp_path / "default__v000001.json") as f:
        assert json.load(f) == meta
    template = init_lm(jax.random.PRNGKey(0), jcfg)
    jmeta, got = jreg.ModelRegistry(str(tmp_path)).load_params("default",
                                                             template)
    assert jmeta == meta and jmeta["config_hash"] == jreg.config_fingerprint(
        jcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


FINGERPRINT_CASES = {
    "base": dict(vocab_size=50, hidden_size=128, num_layers=1),
    "config3": dict(vocab_size=33278, hidden_size=650, num_layers=2),
    "draft": dict(vocab_size=50, hidden_size=32, num_layers=1),
    "tied": dict(vocab_size=50, hidden_size=64, num_layers=2,
                 tie_embeddings=True),
    "bf16": dict(vocab_size=26, hidden_size=128, num_layers=1,
                 compute_dtype="bfloat16"),
    "bf16_logits": dict(vocab_size=33278, hidden_size=650, num_layers=2,
                        compute_dtype="bfloat16", logits_dtype="bfloat16"),
    "dropout_remat": dict(vocab_size=89, hidden_size=64, num_layers=2,
                          dropout=0.5, remat_chunk=16),
    "embed": dict(vocab_size=89, hidden_size=64, embed_size=32),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_config_fingerprint_equals_jax(case):
    kw = FINGERPRINT_CASES[case]
    got = treg.config_fingerprint(tlm.LMConfig(**kw))
    assert got == jreg.config_fingerprint(LMConfig(**kw))
    # and it tells models apart
    other = dict(kw, hidden_size=kw["hidden_size"] + 8)
    assert got != treg.config_fingerprint(tlm.LMConfig(**other))
