"""The port's bi-LSTM classifier path (BASELINE.md config 2) against the
JAX package's, on the CPU.

- data: the IMDB stand-in (splits, labels, vocabulary), the word
  vocabulary and encoder, and ``padded_batches`` (shuffled, bucketed, and
  with ``valid=False`` filler rows) byte-equal to the JAX package's;
- ``sequence_mask`` equal, and ``dropout_with_keep`` fed JAX's keep mask
  equal to JAX's dropout (atol 1e-7: the same division);
- ``classifier_loss``: loss, accuracy and every parameter gradient against
  ``jax.value_and_grad`` of the JAX ``classifier_loss`` on bridged
  parameters, at dropout 0 and at dropout 0.3 fed JAX's keep masks, with
  and without ``remat_chunk`` (atol 1e-5 / rtol 1e-4: float32 sums in
  another order);
- a 3-step Adam + clip trajectory of ``make_train_step`` against the JAX
  ``make_train_step`` (losses and final params to atol 1e-5);
- the classifier's parameter conversion, bit-exact both ways;
- ``train --dataset imdb`` on the CPU end to end, and its refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import (classifier_params_from_numpy,
                                            classifier_params_to_numpy)
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import corpus as tcorpus
from lstm_tensorspark_torch.data import datasets as tdata
from lstm_tensorspark_torch.exit_codes import USAGE_RC
from lstm_tensorspark_torch.models import classifier as tclf
from lstm_tensorspark_torch.ops import masking as tmask
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.data import batching as jbatch
from lstm_tensorspark_tpu.data import corpus as jcorpus
from lstm_tensorspark_tpu.data import datasets as jdata
from lstm_tensorspark_tpu.models import classifier as jclf
from lstm_tensorspark_tpu.ops import masking as jmask
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def imdb_both():
    return tdata.get_dataset("imdb", max_len=24), jdata.get_dataset(
        "imdb", max_len=24)


def test_imdb_standin_byte_equal(imdb_both):
    t, j = imdb_both
    assert t["synthetic"] and j["synthetic"]
    assert t["vocab"].itos == j["vocab"].itos and len(t["vocab"]) == 113
    assert t["num_classes"] == j["num_classes"] == 2
    for split in ("train", "valid", "test"):
        (ts, tl), (js, jl) = t[split], j[split]
        assert tl.tobytes() == jl.tobytes() and len(ts) == len(js)
        assert all(a.dtype == np.int32 and a.tobytes() == b.tobytes()
                   for a, b in zip(ts, js))
    assert (len(t["train"][0]), len(t["valid"][0])) == (1600, 200)


@pytest.mark.parametrize("max_size", [None, 2, 40])
def test_word_vocab_and_encoding_match_jax(max_size):
    text = jcorpus.synthetic_text(400, 3) + " <pad> zz <unk> four four"
    tv = tcorpus.build_word_vocab(text, max_size)
    jv = jcorpus.build_word_vocab(text, max_size)
    assert tv.itos == jv.itos
    probe = "four score <pad> and qq <unk> nation"
    assert tv.encode_text(probe, "word").tobytes() == \
        jv.encode_text(probe, "word").tobytes()


@pytest.mark.parametrize("kw", [
    dict(batch_size=32, max_len=24, shuffle_seed=3),
    dict(batch_size=48, max_len=400, shuffle_seed=None, drop_remainder=False),
    dict(batch_size=7, max_len=16, bucket=False, shuffle_seed=0,
         drop_remainder=False)])
def test_padded_batches_byte_equal(imdb_both, kw):
    seqs, labels = imdb_both[0]["valid"]
    got = list(tbatch.padded_batches(seqs, labels, **kw))
    ref = list(jbatch.padded_batches(seqs, labels, **kw))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    if kw.get("drop_remainder") is False:
        assert not got[-1]["valid"].all()  # filler rows, length 0
        assert (got[-1]["lengths"][~got[-1]["valid"]] == 0).all()


def test_epoch_stream_and_order_match_jax(imdb_both):
    seqs, labels = imdb_both[0]["train"]
    lens = [len(s) for s in seqs]
    assert np.array_equal(tbatch.example_order(lens, shuffle_seed=5),
                          jbatch.example_order(lens, shuffle_seed=5))

    def stream(mod, start):
        s = mod.epoch_stream(
            lambda e: mod.padded_batches(seqs, labels, 64, 24,
                                         shuffle_seed=e),
            steps_per_epoch=25, start_step=start)
        return [next(s) for _ in range(4)]

    for start in (0, 23):
        for a, b in zip(stream(tbatch, start), stream(jbatch, start)):
            assert a["tokens"].tobytes() == b["tokens"].tobytes()


def test_sequence_mask_and_dropout_match_jax():
    lens = np.array([0, 3, 7, 1], np.int32)
    assert np.array_equal(
        tmask.sequence_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jmask.sequence_mask(jnp.asarray(lens), 7)))
    x = np.random.RandomState(0).randn(4, 5, 6).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, jout = jmask.dropout(key, 0.3, jnp.asarray(x))
    _, sub = jax.random.split(key)
    keep = np.array(jax.random.bernoulli(sub, 0.7, x.shape))
    tout = tmask.dropout_with_keep(torch.from_numpy(keep), 0.3,
                                   torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-7,
                               rtol=0)
    xt = torch.from_numpy(x)
    assert tmask.dropout_with_keep(None, 0.0, xt) is xt
    g = torch.Generator().manual_seed(0)
    frac = tmask.dropout_keep(g, 0.25, (200, 200), "cpu").float().mean()
    assert abs(float(frac) - 0.75) < 0.01


def _models(L, dropout, remat=None, V=30, H=8, E=6, seed=0):
    jcfg = jclf.ClassifierConfig(vocab_size=V, hidden_size=H, num_layers=L,
                                 embed_size=E, dropout=dropout,
                                 remat_chunk=remat)
    jparams = jclf.init_classifier(jax.random.PRNGKey(seed), jcfg)
    tcfg = tclf.ClassifierConfig(vocab_size=V, hidden_size=H, num_layers=L,
                                 embed_size=E, dropout=dropout,
                                 remat_chunk=remat)
    tparams = classifier_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(B=8, T=8, V=30, seed=1):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    toks = rng.randint(2, V, size=(B, T)).astype(np.int32)
    toks[np.arange(T)[None, :] >= lens[:, None]] = 0
    valid = np.ones(B, bool)
    valid[-2:] = False
    return {"tokens": toks, "lengths": lens,
            "labels": rng.randint(0, 2, size=B).astype(np.int32),
            "valid": valid}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_keeps(key, rate, shapes):
    """The keep masks JAX's classifier_forward draws from ``key``, in
    order (one split per dropout call)."""
    keeps = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        keeps.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 1.0 - rate, shape))))
    return keeps


@pytest.mark.parametrize("L,dropout,remat", [(1, 0.0, None), (2, 0.3, None),
                                             (1, 0.3, 4)])
def test_classifier_loss_and_grads_match_jax(L, dropout, remat):
    jcfg, jparams, tcfg, tparams = _models(L, dropout, remat, seed=L)
    b = _batch()
    B, T = b["tokens"].shape
    key = jax.random.PRNGKey(7) if dropout else None
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jclf.classifier_loss(p, b, jcfg, dropout_rng=key,
                                       deterministic=key is None),
        has_aux=True))(jparams)
    keeps = None
    if dropout:
        shapes = [(B, T, 2 * tcfg.hidden_size)] * (L - 1) + [
            (B, 2 * tcfg.hidden_size)]
        keeps = iter(_jax_keeps(key, dropout, shapes))
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tl, taux = tclf.classifier_loss(params, _tb(b), tcfg, dropout_keeps=keeps)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(taux["accuracy"].item(),
                               float(jaux["accuracy"]), atol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == 12 * 2 * L + 3
    for a, e in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_train_trajectory_matches_jax():
    """3 Adam steps (lr 1e-2, clip 1.0) from bridged params on the same
    padded batches: losses, grad norms and the final params."""
    jcfg, jparams, tcfg, tparams = _models(1, 0.0, seed=4)
    jo = jopt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(
        lambda p, b, rng: jclf.classifier_loss(p, b, jcfg), jo)
    to = topt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    tstate = tloop.init_train_state(tparams, to)
    tstep = tloop.make_train_step(
        lambda p, b: tclf.classifier_loss(p, b, tcfg), to)
    jl, tl = [], []
    for i in range(3):
        b = _batch(seed=10 + i)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-4)


def test_classifier_params_convert_bit_exact():
    _, jparams, _, tparams = _models(2, 0.0)
    jnp_tree = jax.tree.map(np.asarray, jparams)
    back = classifier_params_to_numpy(tparams)
    assert back["embedding"].tobytes() == jnp_tree["embedding"].tobytes()
    for side in ("fwd", "bwd"):
        for tl_, jl_ in zip(back[side], jnp_tree[side]):
            for f in tl_:
                assert tl_[f].tobytes() == getattr(jl_, f).tobytes()
    for k in ("kernel", "bias"):
        assert back["head"][k].tobytes() == jnp_tree["head"][k].tobytes()
    again = classifier_params_from_numpy(back, device="cpu")
    for a, b in zip(tloop.param_leaves(again), tloop.param_leaves(tparams)):
        assert torch.equal(a, b)


def test_init_classifier_shapes_and_order():
    cfg = tclf.ClassifierConfig(vocab_size=20, hidden_size=8, num_layers=2,
                                embed_size=6)
    p = tclf.init_classifier(torch.Generator().manual_seed(0), cfg)
    assert p["embedding"].shape == (20, 6)
    assert p["fwd"][0].W_i.shape == (6, 8) and p["bwd"][1].W_i.shape == (16, 8)
    assert p["head"]["kernel"].shape == (16, 2)
    assert [k for k in sorted(p)] == ["bwd", "embedding", "fwd", "head"]
    assert tclf.ClassifierConfig(vocab_size=4,
                                 compute_dtype="bfloat16").compute_dtype \
        == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        tclf.ClassifierConfig(vocab_size=4, compute_dtype="float16")


def test_cli_train_imdb_end_to_end(tmp_path):
    """``train --dataset imdb`` on the CPU: exits 0, logs losses, evals
    with accuracy at the cadence, a new-best record, and a final eval."""
    path = tmp_path / "m.jsonl"
    rc = tcli.main([
        "train", "--dataset", "imdb", "--device", "cpu", "--hidden-units",
        "8", "--seq-len", "24", "--batch-size", "8", "--num-steps", "12",
        "--log-every", "4", "--eval-every", "6", "--eval-batches", "2",
        "--optimizer", "adam", "--learning-rate", "1e-2", "--clip-norm",
        "1.0", "--dropout", "0.2", "--remat-chunk", "8", "--compute-dtype",
        "float32", "--jsonl", str(path)])
    assert rc == 0
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [r for r in recs if "loss" in r]
    assert len(losses) == 3 and all(r["examples_per_sec"] > 0 for r in losses)
    evals = [r for r in recs if "eval_accuracy" in r and "note" not in r]
    assert [r["step"] for r in evals] == [6, 12]
    assert any(r.get("note") == "new best eval_accuracy" for r in recs)
    assert recs[-1]["note"] == "final"
    assert 0.0 <= recs[-1]["eval_accuracy"] <= 1.0


@pytest.mark.parametrize("flags,msg", [
    (["--stateful"], "--stateful"), (["--remat-chunk", "0"], "remat-chunk"),
    (["--fused-eval"], "--fused-eval needs --eval-every")])
def test_cli_imdb_refusals(flags, msg, capsys):
    rc = tcli.main(["train", "--dataset", "imdb", "--device", "cpu",
                    "--num-steps", "1", *flags])
    assert rc == USAGE_RC
    assert msg in capsys.readouterr().err
