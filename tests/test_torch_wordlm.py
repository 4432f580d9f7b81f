"""The port's word-level LM path (BASELINE.md config 5's model: a stacked
LSTM LM with dropout between layers, on the WikiText stand-ins) against
the JAX package's, on the CPU.

- ``synthetic_word_corpus`` and the ``wikitext2`` / ``wikitext103``
  stand-ins (ids of every split and the vocabulary) byte-equal to the JAX
  package's;
- ``lm_loss`` with 3 layers and dropout 0.2 fed JAX's keep masks (the
  split chain of the JAX ``stacked_lstm_scan`` reproduced here), stateful
  carries, with and without ``remat_chunk``: loss, final carries and every
  parameter gradient (atol 1e-5 / rtol 1e-4: float32 sums in another
  order); eval without a mask source equals dropout 0;
- a 3-step Adam + clip stateful trajectory of ``make_train_step`` against
  the JAX ``make_train_step`` on the wikitext103 stand-in at a width cut
  to H=16, dropout 0.2 with each step's keep masks from the JAX step's
  key: losses and final params to atol 1e-5;
- ``train --dataset wikitext103 --dropout 0.2`` on the CPU end to end.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import corpus as tcorpus
from lstm_tensorspark_torch.data import datasets as tdata
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.data import corpus as jcorpus
from lstm_tensorspark_tpu.data import datasets as jdata
from lstm_tensorspark_tpu.models import lstm_lm as jlm
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("n,V,seed,noise", [(500, 50, 0, 0.05),
                                            (3000, 1000, 3, 0.1)])
def test_synthetic_word_corpus_matches_jax(n, V, seed, noise):
    assert tcorpus.synthetic_word_corpus(n, V, seed, noise=noise) == \
        jcorpus.synthetic_word_corpus(n, V, seed, noise=noise)


@pytest.mark.parametrize("name,V", [("wikitext2", 996), ("wikitext103", 4998)])
def test_wiki_standins_byte_equal(name, V):
    t, j = tdata.get_dataset(name), jdata.get_dataset(name)
    assert t["synthetic"] and j["synthetic"]
    assert t["vocab"].itos == j["vocab"].itos and len(t["vocab"]) == V
    for split in ("train", "valid", "test"):
        assert t[split].dtype == j[split].dtype == np.int32
        assert t[split].tobytes() == j[split].tobytes()


def test_unported_dataset_still_raises():
    """``uci_electricity``, the last dataset of the JAX registry to be
    ported, gives the stand-in of JAX's own registry."""
    t, j = tdata.get_dataset("uci_electricity"), jdata.get_dataset(
        "uci_electricity")
    assert t["synthetic"] and t["num_features"] == j["num_features"] == 8
    for split in ("train", "valid", "test"):
        assert t[split].tobytes() == j[split].tobytes()


def _models(V, H, L, dropout, remat=None, seed=0):
    jcfg = jlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        dropout=dropout, remat_chunk=remat)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        dropout=dropout, remat_chunk=remat)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_keeps(key, rate, shape, n):
    """The keep masks the JAX ``stacked_lstm_scan`` draws from ``key``
    between ``n + 1`` layers, in order (one split per dropout call)."""
    keeps = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keeps.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 1.0 - rate, shape))))
    return keeps


def _tbatch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def wt103():
    return tdata.get_dataset("wikitext103")


@pytest.mark.parametrize("remat", [None, 4])
def test_lm_loss_with_dropout_matches_jax(wt103, remat):
    V, H, L, B, T, rate = len(wt103["vocab"]), 16, 3, 4, 8, 0.2
    jcfg, jparams, tcfg, tparams = _models(V, H, L, rate, remat, seed=5)
    b = next(tbatch.lm_batch_stream(wt103["train"], B, T))
    rng = np.random.RandomState(6)
    carries = [((rng.randn(B, H) * 0.5).astype(np.float32),
                (rng.randn(B, H) * 0.5).astype(np.float32)) for _ in range(L)]
    key = jax.random.PRNGKey(11)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, b, jcfg, carries=carries, dropout_rng=key,
                              deterministic=False), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tc = [(torch.from_numpy(h), torch.from_numpy(c)) for h, c in carries]
    keeps = iter(_jax_keeps(key, rate, (B, T, H), L - 1))
    tl, taux = tlm.lm_loss(params, _tbatch(b), tcfg, carries=tc,
                           dropout_keeps=keeps)
    assert next(keeps, None) is None  # no dropout after the top layer
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    for (th, tcc), (jh, jc) in zip(taux["carries"], jaux["carries"]):
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tcc.detach().numpy(), np.asarray(jc),
                                   atol=1e-5, rtol=0)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == 3 + 12 * L
    for a, e in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    # no source of keep masks: deterministic, as eval runs it
    with torch.no_grad():
        ev, _ = tlm.lm_loss(tparams, _tbatch(b), tcfg, carries=tc)
        d0, _ = tlm.lm_loss(tparams, _tbatch(b),
                            dataclasses.replace(tcfg, dropout=0.0),
                            carries=tc)
    assert ev.item() == d0.item()


def test_train_trajectory_with_dropout_matches_jax(wt103):
    """3 stateful Adam steps (lr 1e-2, clip 1.0), 2 layers, dropout 0.2,
    H=16, B=4, T=8 on the wikitext103 stand-in from bridged params; each
    port step is fed the keep masks the JAX step draws from its key."""
    V, H, L, B, T, rate = len(wt103["vocab"]), 16, 2, 4, 8, 0.2
    jcfg, jparams, tcfg, tparams = _models(V, H, L, rate, seed=8)

    def jloss(params, batch, dropout_rng, carries):
        return jlm.lm_loss(params, batch, jcfg, carries=carries,
                           dropout_rng=dropout_rng, deterministic=False)

    jo = jopt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    key = jax.random.PRNGKey(2)
    jstate = jloop.init_train_state(jparams, jo, key,
                                    carries=jlm.init_carries(jcfg, B))
    jstep = jloop.make_train_step(jloss, jo, stateful=True)
    # the JAX step splits its state's key and hands the loss the second half
    step_keeps = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        step_keeps.append(_jax_keeps(sub, rate, (B, T, H), L - 1))
    feed = iter(step_keeps)

    def tloss(params, batch, carries=None):
        return tlm.lm_loss(params, batch, tcfg, carries=carries,
                           dropout_keeps=iter(next(feed)))

    to = topt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    tstate = tloop.init_train_state(tparams, to,
                                    carries=tlm.init_carries(tcfg, B))
    tstep = tloop.make_train_step(tloss, to, stateful=True)
    stream = tbatch.lm_batch_stream(wt103["train"], B, T)
    jl, tl = [], []
    for _ in range(3):
        b = next(stream)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-4)
    for (th, tcc), (jh, jc) in zip(tstate.carries, jstate.carries):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(tcc.numpy(), np.asarray(jc), atol=1e-5)


def test_cli_train_wikitext103_with_dropout(tmp_path):
    """``train --dataset wikitext103 --dropout 0.2`` (config 5's flags at a
    tiny width) on the CPU: exits 0, logs finite losses at the cadence, an
    eval, and a final eval record."""
    path = tmp_path / "m.jsonl"
    rc = tcli.main([
        "train", "--dataset", "wikitext103", "--device", "cpu",
        "--hidden-units", "8", "--num-layers", "2", "--batch-size", "4",
        "--seq-len", "8", "--num-steps", "6", "--log-every", "3",
        "--eval-every", "6", "--eval-batches", "2", "--optimizer", "adam",
        "--learning-rate", "1e-2", "--clip-norm", "1.0", "--dropout", "0.2",
        "--stateful", "--compute-dtype", "float32", "--logits-dtype",
        "float32", "--remat-chunk", "4", "--jsonl", str(path)])
    assert rc == 0
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[1]["vocab"] == 4998 and recs[1]["dataset"] == "wikitext103"
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [r["step"] for r in recs if "eval_ppl" in r] == [6, 6]
    assert recs[-1]["note"] == "final" and recs[-1]["eval_ppl"] > 0
