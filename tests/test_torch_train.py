"""The port's training path against the JAX package's, on the CPU.

Same numpy inputs and bridged weights (``convert.params_from_numpy``) go
through both:

- ``lm_loss``: value and every parameter gradient against
  ``jax.value_and_grad`` of the JAX ``lm_loss``, stateful carries included
  (atol 1e-5 / rtol 1e-4: float32 sums in another order);
- the optimizers: 5 updates against optax for all five families, global-norm
  clipping and the warmup / warmup-cosine schedules (atol 1e-6, rtol 1e-5);
- a 5-step stateful SGD (lr 0.5) trajectory of ``make_train_step`` against
  the JAX ``make_train_step`` at a config-1 shape cut to H=32: losses and
  final params to atol 1e-5;
- the non-finite guard (the update, the moments and the carries are
  skipped) and ``--anomaly-limit`` (exit 77);
- ``python -m lstm_tensorspark_torch train --device cpu`` end to end.
"""

import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import corpus as tcorpus
from lstm_tensorspark_torch.exit_codes import ANOMALY_RC, USAGE_RC
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.models.lstm_lm import init_carries, lm_loss
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _tokens(n_words=3000, seed=0):
    text = tcorpus.synthetic_text(n_words, seed)
    vocab = tcorpus.build_char_vocab(text)
    return vocab, vocab.encode_text(text, "char")


def _models(V, H, L, tied, seed=0):
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                    tie_embeddings=tied)
    jparams = init_lm(jax.random.PRNGKey(seed), jcfg)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        tie_embeddings=tied)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch_np(tokens, B, T, index=0):
    return next(itertools.islice(tbatch.lm_batch_stream(tokens, B, T),
                                 index, None))


def _tbatch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("L,tied,stateful", [(1, False, True),
                                             (2, True, False),
                                             (2, False, True)])
def test_lm_loss_and_grads_match_jax(L, tied, stateful):
    vocab, tokens = _tokens()
    V, H, B, T = len(vocab), 16, 8, 8
    jcfg, jparams, tcfg, tparams = _models(V, H, L, tied, seed=L)
    b = _batch_np(tokens, B, T, 3)
    rng = np.random.RandomState(4)
    carries = None
    if stateful:
        carries = [((rng.randn(B, H) * 0.5).astype(np.float32),
                    (rng.randn(B, H) * 0.5).astype(np.float32))
                   for _ in range(L)]
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: lm_loss(p, b, jcfg, carries=carries), has_aux=True)(jparams)

    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tc = None if carries is None else [(torch.from_numpy(h), torch.from_numpy(c))
                                       for h, c in carries]
    tl, taux = tlm.lm_loss(params, _tbatch(b), tcfg, carries=tc)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-6)
    assert taux["tokens"] == float(jaux["tokens"]) == B * T
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, e in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    for (th, tcc), (jh, jc) in zip(taux["carries"], jaux["carries"]):
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tcc.detach().numpy(), np.asarray(jc),
                                   atol=1e-5, rtol=0)


def test_chunked_xent_vocab_raises():
    cfg = tlm.LMConfig(vocab_size=tlm._CHUNKED_XENT_MIN_V, hidden_size=4)
    with pytest.raises(NotImplementedError, match="chunked xent"):
        tlm.lm_loss({}, {"inputs": None, "targets": None}, cfg)


OPTIMIZER_CASES = {
    "sgd": dict(name="sgd", learning_rate=0.3),
    "sgd_momentum": dict(name="sgd", learning_rate=0.3, momentum=0.8),
    "momentum": dict(name="momentum", learning_rate=0.1),
    "adam": dict(name="adam", learning_rate=0.01),
    "adamw": dict(name="adamw", learning_rate=0.01, weight_decay=0.05),
    "rmsprop": dict(name="rmsprop", learning_rate=0.01),
    "sgd_clip": dict(name="sgd", learning_rate=0.3, clip_norm=0.5),
    "adam_warmup_cosine": dict(name="adam", learning_rate=0.02,
                               warmup_steps=2, decay_steps=4),
    "sgd_warmup_hold": dict(name="sgd", learning_rate=0.3, warmup_steps=3),
    "momentum_cosine_clip": dict(name="momentum", learning_rate=0.1,
                                 momentum=0.5, clip_norm=2.0, decay_steps=3),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(OPTIMIZER_CASES[case])
    name = kw.pop("name")
    rng = np.random.RandomState(7)
    shapes = [(5, 3), (3,), (4, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jo = jopt.make_optimizer(name, **kw)
    to = topt.make_optimizer(name, **kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        grads = [(rng.randn(*s) * (1 + step)).astype(np.float32)
                 for s in shapes]
        ju, js = jo.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update([torch.from_numpy(g) for g in grads], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, e in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-6,
                                       rtol=1e-5, err_msg=f"step {step}")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion")


def test_train_trajectory_matches_jax():
    """5 stateful SGD steps (lr 0.5) at a config-1 shape cut to H=32,
    B=8, T=16, from bridged params on the same contiguous windows."""
    vocab, tokens = _tokens()
    V, H, B, T = len(vocab), 32, 8, 16
    jcfg, jparams, tcfg, tparams = _models(V, H, 1, False, seed=9)

    def jloss(params, batch, dropout_rng, carries):
        return lm_loss(params, batch, jcfg, carries=carries)

    jo = jopt.make_optimizer("sgd", 0.5)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0),
                                    carries=init_carries(jcfg, B))
    jstep = jloop.make_train_step(jloss, jo, stateful=True)

    def tloss(params, batch, carries=None):
        return tlm.lm_loss(params, batch, tcfg, carries=carries)

    to = topt.make_optimizer("sgd", 0.5)
    tstate = tloop.init_train_state(tparams, to,
                                    carries=tlm.init_carries(tcfg, B))
    tstep = tloop.make_train_step(tloss, to, stateful=True)
    stream = tbatch.lm_batch_stream(tokens, B, T)
    jl, tl = [], []
    for _ in range(5):
        b = next(stream)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        assert tm["anomalous"].item() == 0.0
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tl[-1] < tl[0]
    assert tstate.step == int(jstate.step) == 5
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-4)


def test_nonfinite_guard_skips_the_update():
    """A non-finite loss keeps params, momentum and carries, still counts
    the step, and reports anomalous = 1; the next finite step updates."""
    vocab, tokens = _tokens()
    V, H, B, T = len(vocab), 16, 4, 8
    cfg = tlm.LMConfig(vocab_size=V, hidden_size=H)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)

    def loss_fn(params, batch, carries=None):
        loss, aux = tlm.lm_loss(params, batch, cfg, carries=carries)
        return loss * batch["scale"], aux

    opt = topt.make_optimizer("sgd", 0.5, momentum=0.9)
    state = tloop.init_train_state(params, opt,
                                   carries=tlm.init_carries(cfg, B))
    step = tloop.make_train_step(loss_fn, opt, stateful=True)
    stream = tbatch.lm_batch_stream(tokens, B, T)

    def batch(scale):
        b = _tbatch(next(stream))
        b["scale"] = torch.tensor(scale)
        return b

    state, m = step(state, batch(1.0))
    assert m["anomalous"].item() == 0.0
    bad, m = step(state, batch(float("nan")))
    assert m["anomalous"].item() == 1.0 and bad.step == state.step + 1
    for a, b in zip(tloop.param_leaves(bad.params),
                    tloop.param_leaves(state.params)):
        assert torch.equal(a, b)
    for a, b in zip(bad.opt_state["trace"], state.opt_state["trace"]):
        assert torch.equal(a, b)
    assert torch.equal(bad.opt_state["count"], state.opt_state["count"])
    for (h1, c1), (h0, c0) in zip(bad.carries, state.carries):
        assert torch.equal(h1, h0) and torch.equal(c1, c0)
    good, m = step(bad, batch(1.0))
    assert m["anomalous"].item() == 0.0
    assert not torch.equal(good.params["embedding"], bad.params["embedding"])


def test_anomaly_limit_exits_77(capsys):
    """An infinite learning rate leaves non-finite params after step 1;
    steps 2 and 3 are anomalous and --anomaly-limit 2 ends the run."""
    rc = tcli.main(["train", "--device", "cpu", "--hidden-units", "8",
                    "--batch-size", "4", "--seq-len", "8", "--num-steps", "20",
                    "--learning-rate", "inf", "--anomaly-limit", "2",
                    "--log-every", "0"])
    assert rc == ANOMALY_RC == 77
    assert "anomaly abort" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--compute-dtype", "bfloat16"],
                                   ["--logits-dtype", "bfloat16"],
                                   ["--dataset", "uci_electricity"]])
def test_train_refuses_what_is_not_ported(flags, capsys):
    rc = tcli.main(["train", "--device", "cpu", "--num-steps", "1", *flags])
    assert rc == USAGE_RC
    assert "not ported" in capsys.readouterr().err


def test_cli_train_end_to_end(tmp_path):
    """The CLI entry on the CPU: exits 0, the logged loss falls, evals run
    at the cadence and the run ends with a final eval record."""
    path = tmp_path / "m.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "lstm_tensorspark_torch", "train",
         "--device", "cpu", "--hidden-units", "32", "--batch-size", "8",
         "--seq-len", "16", "--num-steps", "60", "--log-every", "10",
         "--eval-every", "30", "--eval-batches", "4", "--learning-rate", "0.5",
         "--stateful", "--jsonl", str(path)],
        capture_output=True, text=True, timeout=300,
        # one thread, as the in-process tests use: the suite runs in
        # parallel workers
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    records = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert all(r["tokens_per_sec"] > 0 for r in records if "loss" in r)
    evals = [r for r in records if "eval_ppl" in r]
    assert [r["step"] for r in evals] == [30, 60, 60]
    assert evals[-1]["note"] == "final" and np.isfinite(evals[-1]["eval_ppl"])
