"""The port's K-steps-per-call training (``train/multistep.py``), the
logging loop over calls, the prefetched feed and the capture wrapper's
CPU form, held against the JAX package (``lstm_tensorspark_tpu/train/
multistep.py``) and against the port's own single steps.

- ``make_multi_train_step`` at K=4 against the JAX one (SGD with momentum
  and Adam with clipping, stateful and not): ``loss``, ``loss_last``,
  ``grad_norm`` and the params after the call (atol 1e-5, rtol 1e-4: the
  sums run in another order);
- the K-step call against K of the port's own single steps, with dropout
  drawn from a generator: bit-identical on the CPU (``torch.equal``);
- the fused classifier eval (``metric_fn`` over stacked eval batches):
  ``eval_loss`` and ``eval_accuracy`` against the port's host
  ``evaluate_classifier`` (1e-6) and the JAX fused step (1e-5); a call
  without the eval reports NaN and trains bit-identically;
- ``train_loop``'s contract over calls (cadences in calls, rates in steps,
  the consecutive-anomaly rule), ``prefetch_to_device`` on the CPU, the
  capture wrapper's state flattening and its eager CPU form, and the
  generator tracking its warm-up relies on (``track_generators``).

Shapes are the JAX twins' (V=11, B=8, T=12, K=4) with H cut to 32.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import (classifier_params_from_numpy,
                                            params_from_numpy)
from lstm_tensorspark_torch.data import prefetch as tprefetch
from lstm_tensorspark_torch.data import stage_stacked_batches
from lstm_tensorspark_torch.models import classifier as tclf
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import masking as tmask
from lstm_tensorspark_torch.train import graphs as tgraphs
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import multistep as tms
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.models import LMConfig, init_lm, lm_loss
from lstm_tensorspark_tpu.models import classifier as jclf
from lstm_tensorspark_tpu.models.lstm_lm import init_carries
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import make_multi_train_step as jmulti
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

V, H, B, T, K = 11, 32, 8, 12, 4
ATOL, RTOL = 1e-5, 1e-4
OPTS = {"sgd": dict(name="momentum", learning_rate=0.3, momentum=0.9),
        "adam": dict(name="adam", learning_rate=1e-2, clip_norm=1.0)}


def _stacked(seed=0, k=K):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randint(0, V, (k, B, T)).astype(np.int32),
            "targets": rng.randint(0, V, (k, B, T)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _lm(L=1, seed=0):
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _tleaves_close(tparams, jparams):
    tl, jl = tloop.param_leaves(tparams), jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for a, e in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("opt,stateful", [("sgd", True), ("sgd", False),
                                          ("adam", True), ("adam", False)])
def test_multi_step_matches_jax(opt, stateful):
    jcfg, jparams, tparams = _lm()
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H)
    kw = dict(OPTS[opt])
    name = kw.pop("name")
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    if stateful:
        def jloss(p, b, rng, carries):
            return lm_loss(p, b, jcfg, carries=carries)
    else:
        def jloss(p, b, rng):
            return lm_loss(p, b, jcfg)

    def tloss(p, b, carries=None):
        return tlm.lm_loss(p, b, tcfg, carries=carries)

    jstate = jloop.init_train_state(
        jparams, jo, jax.random.PRNGKey(1),
        carries=init_carries(jcfg, B) if stateful else None)
    tstate = tloop.init_train_state(
        tparams, to, carries=tlm.init_carries(tcfg, B) if stateful else None)
    jstep = jmulti(jloss, jo, stateful=stateful)
    tstep = tms.make_multi_train_step(tloss, to, stateful=stateful)
    for call in range(2):
        b = _stacked(seed=call)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _t(b))
        for key in ("loss", "loss_last", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       atol=ATOL, rtol=RTOL)
        assert tm["anomalous"].item() == 0.0
    assert tstate.step == int(jstate.step) == 2 * K
    _tleaves_close(tstate.params, jstate.params)
    if stateful:
        for (h, c), (jh, jc) in zip(tstate.carries, jstate.carries):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)


def _assert_states_equal(a, b):
    for x, y in zip(tgraphs.state_leaves(a), tgraphs.state_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt,stateful,dropout", [("sgd", True, 0.3),
                                                  ("adam", False, 0.0)])
def test_k_step_call_is_k_single_steps(opt, stateful, dropout):
    """One K-step call against K single steps of the same body: the same
    params, moments, carries and losses bit for bit, dropout drawn in the
    same order from generators seeded alike."""
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=2,
                        dropout=dropout)
    params = tlm.init_lm(torch.Generator().manual_seed(3), tcfg)
    kw = dict(OPTS[opt])
    to = topt.make_optimizer(kw.pop("name"), **kw)
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]

    def loss_of(gen):
        def loss(p, b, carries=None):
            return tlm.lm_loss(p, b, tcfg, carries=carries, dropout_gen=gen)
        return loss

    carries = tlm.init_carries(tcfg, B) if stateful else None
    s1 = tloop.init_train_state(params, to, carries=carries)
    s2 = tloop.init_train_state(params, to, carries=carries)
    single = tloop.make_train_step(loss_of(gens[0]), to, stateful=stateful)
    multi = tms.make_multi_train_step(loss_of(gens[1]), to, stateful=stateful)
    for call in range(2):
        b = _t(_stacked(seed=10 + call))
        losses = []
        for i in range(K):
            s1, m1 = single(s1, {k: v[i] for k, v in b.items()})
            losses.append(m1["loss"])
        s2, m2 = multi(s2, b)
        assert s1.step == s2.step == (call + 1) * K
        _assert_states_equal(s1, s2)
        assert torch.equal(m2["loss_last"], losses[-1])
        assert torch.equal(m2["grad_norm"], m1["grad_norm"])
        assert torch.equal(m2["loss"], torch.stack(losses).mean())
        assert m2["anomalous"].item() == 0.0


def _classifier(seed=4):
    jcfg = jclf.ClassifierConfig(vocab_size=30, hidden_size=H, embed_size=6)
    jparams = jclf.init_classifier(jax.random.PRNGKey(seed), jcfg)
    tcfg = tclf.ClassifierConfig(vocab_size=30, hidden_size=H, embed_size=6)
    tparams = classifier_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _clf_batches(n, seed, Tc=10):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(1, Tc + 1, size=B).astype(np.int32)
        toks = rng.randint(2, 30, size=(B, Tc)).astype(np.int32)
        toks[np.arange(Tc)[None, :] >= lens[:, None]] = 0
        valid = np.ones(B, bool)
        valid[rng.randint(0, B)] = False
        out.append({"tokens": toks, "lengths": lens,
                    "labels": rng.randint(0, 2, B).astype(np.int32),
                    "valid": valid})
    return out


def test_fused_classifier_eval_matches_host_and_jax():
    jcfg, jparams, tcfg, tparams = _classifier()
    jo = jopt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    to = topt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    keys = ("eval_loss", "eval_accuracy")

    def jmetric(p, b):
        _, aux = jclf.classifier_loss(p, b, jcfg)
        return ({"eval_loss": aux["loss"], "eval_accuracy": aux["accuracy"]},
                b["valid"].astype(np.float32).sum())

    def tmetric(p, b):
        _, aux = tclf.classifier_loss(p, b, tcfg)
        return ({"eval_loss": aux["loss"], "eval_accuracy": aux["accuracy"]},
                b["valid"].to(torch.float32).sum())

    train = _clf_batches(K, seed=1)
    stacked = {k: np.stack([b[k] for b in train]) for k in train[0]}
    ev_host = _clf_batches(3, seed=2)
    j_ev = {k: np.stack([b[k] for b in ev_host]) for k in ev_host[0]}
    t_ev = stage_stacked_batches(ev_host, device="cpu")

    jstep = jmulti(lambda p, b, rng: jclf.classifier_loss(p, b, jcfg), jo,
                   metric_fn=jmetric, metric_keys=keys)
    tstep = tms.make_multi_train_step(
        lambda p, b: tclf.classifier_loss(p, b, tcfg), to, metric_fn=tmetric,
        metric_keys=keys, eval_batches=t_ev)
    plain = tms.make_multi_train_step(
        lambda p, b: tclf.classifier_loss(p, b, tcfg), to)
    jstate, jm = jstep(jloop.init_train_state(jparams, jo,
                                              jax.random.PRNGKey(0)),
                       stacked, j_ev, np.bool_(True))
    t0 = tloop.init_train_state(tparams, to)
    tstate, tm = tstep(t0, _t(stacked), True)

    @torch.no_grad()
    def eval_step(p, b):
        return tclf.classifier_loss(p, b, tcfg)[1]

    host = tloop.evaluate_classifier(eval_step, tstate.params,
                                     [_t(b) for b in ev_host])
    for k in keys:
        np.testing.assert_allclose(tm[k].item(), host[k], atol=1e-6, rtol=0)
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=1e-5,
                                   rtol=0)
    _tleaves_close(tstate.params, jstate.params)

    # a call without the eval: NaN metrics, the same training bit for bit
    sf, mf = tstep(t0, _t(stacked), False)
    sp, mp = plain(t0, _t(stacked))
    assert all(np.isnan(mf[k].item()) for k in keys)
    assert torch.equal(mf["loss"], mp["loss"])
    _assert_states_equal(sf, sp)


class _FakeStep:
    """A call of ``k`` steps whose anomalous count follows ``bad``."""

    def __init__(self, k, bad=()):
        self.k, self.bad, self.do_evals = k, list(bad), []

    def __call__(self, state, batch, do_eval=None):
        if do_eval is not None:
            self.do_evals.append(do_eval)
        n = self.bad.pop(0) if self.bad else 0
        m = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(2.0),
             "anomalous": torch.tensor(float(n)),
             "eval_loss": torch.tensor(3.0)}
        return state._replace(step=state.step + self.k), m


class _Log:
    def __init__(self):
        self.records = []

    def log(self, r):
        self.records.append(r)


def test_train_loop_counts_calls_and_scales_rates():
    """Cadences count K-step calls, the logged rates count steps, and a
    fused step gets ``do_eval`` on the eval cadence's calls."""
    step, log = _FakeStep(4), _Log()
    state = tloop.TrainState(0, None, None)
    out = tloop.train_loop(state, step, iter(range(100)), num_steps=6,
                           log_every=2, logger=log, eval_every=3,
                           tokens_per_batch=10, steps_per_call=4,
                           fused_eval=lambda m: {"eval_loss":
                                                 float(m["eval_loss"])})
    assert out.step == 24
    assert step.do_evals == [False, False, True, False, False, True]
    logged = [r for r in log.records if "loss" in r]
    assert [r["step"] for r in logged] == [8, 16, 24]
    for r in logged:
        np.testing.assert_allclose(r["tokens_per_sec"],
                                   10 * r["steps_per_sec"], rtol=1e-9)
    evals = [r for r in log.records if "eval_loss" in r]
    assert [(r["step"], r["eval_loss"]) for r in evals] == [(12, 3.0),
                                                            (24, 3.0)]


@pytest.mark.parametrize("bad,limit,raises_at", [
    ([4, 4, 4], 12, 12),   # three fully anomalous calls of 4
    ([4, 3, 4, 4], 8, 16),  # a partly anomalous call resets the run
    ([2, 2, 2, 2], 4, None),  # no call is fully anomalous
])
def test_anomaly_rule_over_calls(bad, limit, raises_at):
    step = _FakeStep(4, bad)
    state = tloop.TrainState(0, None, None)
    if raises_at is None:
        tloop.train_loop(state, step, iter(range(len(bad))), log_every=0,
                         anomaly_limit=limit, steps_per_call=4)
        return
    with pytest.raises(tloop.AnomalousTrainingError) as e:
        tloop.train_loop(state, step, iter(range(10)), log_every=0,
                         anomaly_limit=limit, steps_per_call=4)
    assert e.value.step == raises_at


def _numbered(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.int32)}


def test_prefetch_keeps_order_on_the_cpu():
    got = [b["x"] for b in tprefetch.prefetch_to_device(_numbered(7), 2,
                                                         device="cpu")]
    assert len(got) == 7
    for i, t in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
        assert torch.equal(t, torch.full((2, 3), i, dtype=torch.int32))
    with pytest.raises(ValueError, match="prefetch size"):
        next(tprefetch.prefetch_to_device(_numbered(1), 0, device="cpu"))


def test_prefetch_abandoned_consumer_stops_producer():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"x": np.array([i])}
            i += 1

    before = threading.active_count()
    it = tprefetch.prefetch_to_device(endless(), 2, device="cpu")
    assert int(next(it)["x"][0]) == 0
    it.close()  # the loop stopping at its budget
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    assert len(pulled) <= 5


def test_prefetch_raises_producer_errors():
    def broken():
        yield {"x": np.zeros(1)}
        raise RuntimeError("bad shard")

    it = tprefetch.prefetch_to_device(broken(), 2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="bad shard"):
        next(it)


def test_state_leaves_round_trip_and_cpu_runs_eagerly():
    """The capture wrapper's flattening of a train state is exact, and on
    the CPU ``graphed`` runs the body itself and captures nothing."""
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=8, num_layers=2)
    params = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    to = topt.make_optimizer("adam", 1e-3)
    state = tloop.init_train_state(params, to,
                                   carries=tlm.init_carries(tcfg, 2))
    leaves = tgraphs.state_leaves(state)
    n = len(tloop.param_leaves(params))
    assert len(leaves) == n + 1 + 2 * n + 4  # count, mu, nu; 2 carries
    back = tgraphs.state_from_leaves(state, leaves)
    assert [id(t) for t in tgraphs.state_leaves(back)] == [id(t) for t in
                                                             leaves]
    calls = []

    def body(s, feed, do_eval):
        calls.append((feed["x"].device.type, do_eval))
        return s._replace(step=s.step + 1), {}

    run = tgraphs.graphed(body, route="test", graph=True, fused=True)
    s2, _ = run(state, {"x": torch.zeros(1)}, True)
    s3, _ = run(s2, {"x": torch.zeros(1)})
    assert s3.step == 2 and calls == [("cpu", True), ("cpu", False)]


def test_track_generators_records_states_before_first_draw():
    """What a capture's warm-up records: each generator dropout drew from,
    with its state before its first draw; restoring it replays the same
    masks (the eager call's) and nothing is recorded outside the block."""
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    x = torch.ones(4, 6)
    with tmask.track_generators() as drawn:
        a = [tmask.dropout(g1, 0.5, x), tmask.dropout(g2, 0.5, x),
             tmask.dropout(g1, 0.5, x)]
    assert set(drawn) == {g1, g2}
    for g, state in drawn.items():
        g.set_state(state)
    b = [tmask.dropout(g1, 0.5, x), tmask.dropout(g2, 0.5, x),
         tmask.dropout(g1, 0.5, x)]
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], a[2])  # the second draw moved on
    with tmask.track_generators() as none:
        tmask.dropout(g1, 0.0, x)  # rate 0 draws nothing
    assert none == {}
