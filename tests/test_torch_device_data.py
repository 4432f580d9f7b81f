"""The port's device-fed training (``data/device_dataset.py``,
``train/device_step.py``), its K-step feeds (``data/batching.py``) and the
CLI's four flags, held against the JAX package and against the port's
host-fed calls.

- ``stacked_batches``, ``index_groups`` (``start_step``, epoch
  wrap-around), ``window_index_stream``, ``slice_window`` (from a device
  index and a Python int) and ``take_batch`` against the JAX functions:
  exact;
- ``make_device_lm_train_step`` against the host-fed K-step call:
  bit-identical on the CPU (``torch.equal``), and within 1e-5 of JAX's
  (stateful and not);
- the fused LM eval (stateful): ``eval_loss`` against the port's host
  ``evaluate`` (1e-6) and JAX's fused step (1e-5); without the eval, NaN
  and the plain call's training bit for bit;
- the classifier's device-fed call (row gathers in ``example_order``)
  against its host-fed padded batches: bit-identical;
- the CLI: ``--steps-per-call 4 --device-data --fused-eval`` and the
  host-fed ``--prefetch 2`` runs log JAX's keys at JAX's cadence, the
  device-fed LM run's losses equal the host-fed run's, and the refusals
  return ``USAGE_RC``; ``cli.training`` (the run built, not started)
  driven by ``train_loop`` logs the command's own records, and raises
  for what the command refuses;
- ``host_feed``: stacked, prefetched or not, the same tensors; and the
  layers point down (``data/`` imports neither ``train/`` nor the CLI,
  ``tasks/`` not the CLI).

Shapes are the JAX twins' (B=8, T=16, V=29, K=4) with H cut to 32.
"""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import device_dataset as tdd
from lstm_tensorspark_torch.exit_codes import USAGE_RC, UsageError
from lstm_tensorspark_torch.models import classifier as tclf
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.train import device_step as tds
from lstm_tensorspark_torch.train.metrics import MetricsLogger as tloop_metrics
from lstm_tensorspark_torch.train import graphs as tgraphs
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import multistep as tms
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.data import batching as jbatch
from lstm_tensorspark_tpu.data import device_dataset as jdd
from lstm_tensorspark_tpu.models import LMConfig, init_lm, lm_loss
from lstm_tensorspark_tpu.models.lstm_lm import init_carries
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import make_device_lm_train_step as jdevice_lm
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

B, T, V, H, K = 8, 16, 29, 32, 4


def _tokens(n=B * T * 12 + 1, seed=0):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _equal_states(a, b):
    for x, y in zip(tgraphs.state_leaves(a), tgraphs.state_leaves(b)):
        assert torch.equal(x, y)


def test_feeds_match_jax():
    """The host feeds and the on-device slicing and gathering, exactly."""
    tokens = _tokens()
    host = list(tbatch.lm_batch_stream(tokens, B, T, num_epochs=1))
    for k in (1, 3):
        got = list(tbatch.stacked_batches(iter(host), k))
        want = list(jbatch.stacked_batches(iter(host), k))
        assert len(got) == len(want) == len(host) // k
        for g, w in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])

    def order(epoch):
        return np.random.RandomState(epoch).permutation(21)

    for k, start in ((4, 0), (3, 5), (2, 11)):  # 21 // 4 = 5 batches/epoch
        got = list(itertools.islice(tbatch.index_groups(
            order, 4, k, start_step=start), 7))
        want = list(itertools.islice(jbatch.index_groups(
            order, 4, k, start_step=start), 7))
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == (k, 4)
            np.testing.assert_array_equal(g, w)

    tdata = tdd.stage_lm_data(tokens, B, T, device="cpu")
    jdata = jdd.stage_lm_data(tokens, B, T)
    assert tdata.n_windows == jdata.n_windows == len(host) == 12
    for k, start in ((4, 0), (5, 7), (1, 25)):  # wraps around the epoch
        got = list(itertools.islice(tdd.window_index_stream(
            tdata, k, start_step=start), 6))
        want = list(itertools.islice(jdd.window_index_stream(
            jdata, k, start_step=start), 6))
        assert [int(w) for w in got] == [int(w) for w in want]
    for w in range(tdata.n_windows):
        jw = jdd.slice_window(jdata.arrays, np.int32(w), T)
        for index in (torch.tensor(w, dtype=torch.int32), w):
            tw = tdd.slice_window(tdata.arrays, index, T)
            for key in ("inputs", "targets"):
                np.testing.assert_array_equal(tw[key].numpy(),
                                              np.asarray(jw[key]))
                np.testing.assert_array_equal(tw[key].numpy(), host[w][key])

    rng = np.random.RandomState(3)
    arrays = {"tokens": rng.randint(0, V, (13, 7)).astype(np.int32),
              "lengths": rng.randint(0, 7, 13).astype(np.int32),
              "valid": rng.rand(13) > 0.3}
    staged = tdd.stage_examples(arrays, device="cpu")
    assert staged.num_examples == 13
    idx = np.array([12, 0, 5, 5, 3], np.int32)
    got = tdd.take_batch(staged.arrays, torch.from_numpy(idx))
    want = jdd.take_batch(jdd.stage_examples(arrays).arrays, idx)
    for key in arrays:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    with pytest.raises(ValueError, match="leading dims"):
        tdd.stage_examples({"a": np.zeros(3), "b": np.zeros(4)},
                           device="cpu")


def _lm_setup(stateful, L=2):
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    if stateful:
        def jloss(p, b, rng, carries):
            return lm_loss(p, b, jcfg, carries=carries)
    else:
        def jloss(p, b, rng):
            return lm_loss(p, b, jcfg)

    def tloss(p, b, carries=None):
        return tlm.lm_loss(p, b, tcfg, carries=carries)

    return jcfg, jparams, jloss, tcfg, tparams, tloss


@pytest.mark.parametrize("stateful", [False, True])
def test_device_lm_step_matches_host_fed_and_jax(stateful):
    jcfg, jparams, jloss, tcfg, tparams, tloss = _lm_setup(stateful)
    tokens = _tokens()
    to, jo = topt.make_optimizer("sgd", 0.3), jopt.make_optimizer("sgd", 0.3)

    def t_state():
        return tloop.init_train_state(
            tparams, to,
            carries=tlm.init_carries(tcfg, B) if stateful else None)

    host_step = tms.make_multi_train_step(tloss, to, stateful=stateful)
    s_host = t_state()
    host_it = tbatch.stacked_batches(tbatch.lm_batch_stream(tokens, B, T), K)
    tdata = tdd.stage_lm_data(tokens, B, T, device="cpu")
    dev_step = tds.make_device_lm_train_step(tloss, to, tdata,
                                             steps_per_call=K,
                                             stateful=stateful)
    s_dev = t_state()
    idx = tdd.window_index_stream(tdata, K)
    jdata = jdd.stage_lm_data(tokens, B, T)
    jstep = jdevice_lm(jloss, jo, jdata, steps_per_call=K, stateful=stateful)
    jstate = jloop.init_train_state(
        jparams, jo, jax.random.PRNGKey(1),
        carries=init_carries(jcfg, B) if stateful else None)
    jidx = jdd.window_index_stream(jdata, K)
    for _ in range(4):  # 16 windows over an epoch of 12: wraps
        s_host, m_host = host_step(s_host, _t(next(host_it)))
        s_dev, m_dev = dev_step(s_dev, next(idx))
        jstate, jm = jstep(jstate, jdata.arrays, next(jidx))
        for key in ("loss", "loss_last", "grad_norm"):
            assert torch.equal(m_host[key], m_dev[key])
            np.testing.assert_allclose(m_dev[key].item(), float(jm[key]),
                                       atol=1e-5, rtol=1e-4)
    _equal_states(s_host, s_dev)
    assert s_dev.step == int(jstate.step) == 4 * K
    for a, e in zip(tloop.param_leaves(s_dev.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-4)


def test_fused_lm_eval_matches_host_and_jax():
    """Stateful: the eval threads its own carries from zeros through the
    staged valid stream (3 windows, capped at 2 by ``eval_windows``)."""
    jcfg, jparams, jloss, tcfg, tparams, tloss = _lm_setup(True)
    train, valid = _tokens(B * T * 8 + 1), _tokens(B * T * 3 + 1, seed=1)
    to, jo = topt.make_optimizer("sgd", 0.3), jopt.make_optimizer("sgd", 0.3)
    tdata = tdd.stage_lm_data(train, B, T, device="cpu")
    edata = tdd.stage_lm_data(valid, B, T, device="cpu")
    fused = tds.make_device_lm_train_step(
        tloss, to, tdata, eval_data=edata, eval_windows=2,
        eval_carries=tlm.init_carries(tcfg, B), steps_per_call=K,
        stateful=True)
    plain = tds.make_device_lm_train_step(tloss, to, tdata, steps_per_call=K,
                                          stateful=True)
    t0 = tloop.init_train_state(tparams, to,
                                carries=tlm.init_carries(tcfg, B))
    state, ms = fused(t0, 0, True)
    host = tloop.evaluate(
        tloop.make_eval_step(tloss, stateful=True), state.params,
        (_t(b) for b in tbatch.cap_batches(
            tbatch.lm_epoch_batches(valid, B, T), 2)),
        carries=tlm.init_carries(tcfg, B))
    np.testing.assert_allclose(ms["eval_loss"].item(), host["eval_loss"],
                               atol=1e-6, rtol=0)

    jdata = jdd.stage_lm_data(train, B, T)
    jedata = jdd.stage_lm_data(valid, B, T)
    jstep = jdevice_lm(jloss, jo, jdata, eval_data=jedata, eval_windows=2,
                       steps_per_call=K, stateful=True)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(1),
                                    carries=init_carries(jcfg, B))
    _, jm = jstep(jstate, jdata.arrays, np.int32(0), jedata.arrays,
                  np.bool_(True), init_carries(jcfg, B))
    np.testing.assert_allclose(ms["eval_loss"].item(), float(jm["eval_loss"]),
                               atol=1e-5, rtol=0)

    sf, mf = fused(t0, 0, False)
    sp, mp = plain(t0, 0)
    assert np.isnan(mf["eval_loss"].item())
    assert torch.equal(mf["loss"], mp["loss"])
    _equal_states(sf, sp)


def test_classifier_device_rows_match_host_batches():
    """Row gathers by ``index_groups`` of ``example_order`` take the same
    batches, and so the same steps, as ``padded_batches`` in one epoch."""
    rng = np.random.RandomState(5)
    L, n = 9, 27
    seqs = [rng.randint(2, 30, rng.randint(1, L + 1)).astype(np.int32)
            for _ in range(n)]
    labels = rng.randint(0, 2, n).astype(np.int32)
    cfg = tclf.ClassifierConfig(vocab_size=30, hidden_size=16, embed_size=6)
    params = tclf.init_classifier(torch.Generator().manual_seed(0), cfg)
    to = topt.make_optimizer("adam", 1e-2, clip_norm=1.0)

    def loss(p, b):
        return tclf.classifier_loss(p, b, cfg)

    toks = np.zeros((n, L), np.int32)
    for r, s in enumerate(seqs):
        toks[r, :len(s)] = s
    staged = tdd.stage_examples(
        {"tokens": toks, "lengths": np.array([len(s) for s in seqs],
                                             np.int32),
         "labels": labels, "valid": np.ones(n, bool)}, device="cpu")
    groups = tbatch.index_groups(
        lambda e: tbatch.example_order([len(s) for s in seqs],
                                       shuffle_seed=e), 4, 2)
    host = tbatch.stacked_batches(
        tbatch.padded_batches(seqs, labels, 4, L, shuffle_seed=0), 2)
    dstep = tds.make_device_train_step(loss, to, tdd.take_batch,
                                       staged.arrays)
    hstep = tms.make_multi_train_step(loss, to)
    sd = sh = tloop.init_train_state(params, to)
    for _ in range(3):  # 6 of the epoch's 6 full batches
        sd, md = dstep(sd, next(groups))
        sh, mh = hstep(sh, _t(next(host)))
        assert torch.equal(md["loss"], mh["loss"])
    _equal_states(sd, sh)


LM_FLAGS = ["train", "--device", "cpu", "--hidden-units", "16",
            "--batch-size", "4", "--seq-len", "8", "--learning-rate", "0.5",
            "--stateful", "--log-every", "2", "--eval-every", "3",
            "--eval-batches", "2", "--compute-dtype", "float32"]
IMDB_FLAGS = ["train", "--dataset", "imdb", "--device", "cpu",
              "--hidden-units", "8", "--seq-len", "16", "--batch-size", "8",
              "--optimizer", "adam", "--learning-rate", "1e-2",
              "--log-every", "2", "--eval-every", "2", "--eval-batches", "2",
              "--compute-dtype", "float32"]
# the keys of JAX's logged records (train/loop.py::_run_train_loop, with
# the logger's elapsed "t") that the port keeps; model_tflops and mfu need
# --peak-tflops, not ported
JAX_LOG_KEYS = {"t", "step", "loss", "grad_norm", "steps_per_sec",
                "tokens_per_sec"}


def _run(tmp_path, name, flags):
    path = tmp_path / f"{name}.jsonl"
    assert tcli.main(flags + ["--jsonl", str(path)]) == 0
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_k_steps_device_data_fused_eval(tmp_path):
    """``--steps-per-call 4 --device-data --fused-eval``: 12 steps are 3
    calls; logs every 2 calls, the fused eval at call 3 equals the final
    host eval of the same params; the losses equal the host-fed run's."""
    k4 = ["--num-steps", "12", "--steps-per-call", "4"]
    fused = _run(tmp_path, "fused", LM_FLAGS + k4 + ["--device-data",
                                                     "--fused-eval"])
    host = _run(tmp_path, "host", LM_FLAGS + k4 + ["--prefetch", "2"])
    for recs in (fused, host):
        logged = [r for r in recs if "loss" in r]
        assert [r["step"] for r in logged] == [8]
        assert set(logged[0]) == JAX_LOG_KEYS
        np.testing.assert_allclose(logged[0]["tokens_per_sec"],
                                   32 * logged[0]["steps_per_sec"], rtol=1e-9)
        evals = [r for r in recs if "eval_loss" in r]
        assert [r["step"] for r in evals] == [12, 12]
        assert evals[-1]["note"] == "final"
        assert set(evals[0]) == {"t", "step", "eval_loss", "eval_ppl"}
    assert ([r["loss"] for r in fused if "loss" in r]
            == [r["loss"] for r in host if "loss" in r])
    ev = [r["eval_loss"] for r in fused if "eval_loss" in r]
    np.testing.assert_allclose(ev[0], ev[1], atol=1e-6, rtol=0)
    assert [r["eval_loss"] for r in host if "eval_loss" in r] == [ev[1]] * 2


def _classifier_device_data_fused_eval(tmp_path, extra):
    flags = IMDB_FLAGS + ["--num-steps", "8", "--steps-per-call", "2"] + extra
    fused = _run(tmp_path, "fused", flags + ["--device-data", "--fused-eval"])
    host = _run(tmp_path, "host", flags)
    for recs in (fused, host):
        assert [r["step"] for r in recs if "loss" in r] == [4, 8]
        assert set([r for r in recs if "loss" in r][0]) == (
            JAX_LOG_KEYS | {"examples_per_sec"})
        evals = [r for r in recs if "eval_accuracy" in r
                 and "note" not in r]
        assert [r["step"] for r in evals] == [4, 8]
    for a, b in zip([r for r in fused if "eval_loss" in r],
                    [r for r in host if "eval_loss" in r]):
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], atol=1e-6)


def test_cli_classifier_device_data_fused_eval(tmp_path):
    _classifier_device_data_fused_eval(tmp_path, [])


def test_cli_classifier_device_data_fused_eval_bf16(tmp_path):
    """The same in bf16 compute (the train command's default): the staged
    rows and the fused eval carry the compute dtype through the config."""
    _classifier_device_data_fused_eval(tmp_path,
                                       ["--compute-dtype", "bfloat16"])


@pytest.mark.parametrize("flags", [
    ["--fused-eval"],  # no --eval-every
    ["--device-data", "--prefetch", "2"],
    ["--steps-per-call", "0"],
])
def test_cli_refusals(flags, capsys):
    rc = tcli.main(["train", "--device", "cpu", "--num-steps", "1", *flags])
    assert rc == USAGE_RC
    assert "train:" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    LM_FLAGS + ["--steps-per-call", "4", "--prefetch", "2"],
    LM_FLAGS + ["--steps-per-call", "4", "--device-data", "--fused-eval"],
    IMDB_FLAGS + ["--steps-per-call", "2", "--device-data", "--fused-eval"],
])
def test_training_is_the_commands_run(tmp_path, flags):
    """``cli.training`` builds the run the command makes: its call driven
    over its feed by ``train_loop`` with its arguments logs the command's
    losses and evals, bit for bit."""
    flags = flags[1:] + ["--num-steps", "12"]
    ran = _run(tmp_path, "cli", ["train"] + flags)
    path = tmp_path / "built.jsonl"
    with tloop_metrics(str(path)) as logger:
        run = tcli.training(flags, logger=logger)
        state = tloop.train_loop(run.state, run.step, run.feed,
                                 logger=logger, **run.loop_kw)
        logger.log({"step": state.step, **run.eval_fn(state.params),
                    "note": "final"})
    built = [json.loads(line) for line in path.read_text().splitlines()]

    def values(recs):
        return [(r["step"], r.get("loss"), r.get("eval_loss"))
                for r in recs if "loss" in r or "eval_loss" in r]

    assert values(built) == values(ran) and len(values(ran)) >= 2


@pytest.mark.parametrize("flags", [
    ["--fused-eval"],
    ["--device-data", "--prefetch", "2"],
    ["--dataset", "imdb", "--stateful"],
])
def test_training_refusals_raise(flags):
    with pytest.raises(UsageError):
        tcli.training(["--device", "cpu", "--num-steps", "1", *flags])


def test_host_feed_stacks_and_prefetches():
    """The host feed of a K-step call: K batches stacked on a leading axis,
    a trailing partial group dropped; prefetched or not, the same
    tensors."""
    stream = [{"x": np.full((2, 3), i, np.int32)} for i in range(7)]
    plain = list(tms.host_feed(iter(stream), "cpu", steps_per_call=3,
                               stacked=True))
    ahead = list(tms.host_feed(iter(stream), "cpu", steps_per_call=3,
                               stacked=True, prefetch=2))
    assert [tuple(b["x"].shape) for b in plain] == [(3, 2, 3)] * 2
    for a, b in zip(plain, ahead):
        assert torch.equal(a["x"], b["x"])
    assert plain[1]["x"][:, 0, 0].tolist() == [3, 4, 5]
    one = list(tms.host_feed(iter(stream), "cpu"))
    assert len(one) == 7 and tuple(one[0]["x"].shape) == (2, 3)


def test_layers_point_down():
    """``data/`` imports nothing of ``train/`` or the CLI, and ``tasks/``
    nothing of the CLI: the CLI and the tasks build on train/ and data/,
    not the other way round."""
    import ast
    import pathlib

    import lstm_tensorspark_torch as pkg

    root = pathlib.Path(pkg.__file__).parent
    banned = {"data": ("train", "cli", "tasks"), "tasks": ("cli",)}
    for sub, names in banned.items():
        for f in sorted((root / sub).glob("*.py")):
            for node in ast.walk(ast.parse(f.read_text())):
                if isinstance(node, ast.ImportFrom) and node.level:
                    mod = (node.module or "").split(".")[0]
                    got = [mod] if mod else [a.name for a in node.names]
                    bad = ([m for m in got if m in names]
                           if node.level == 2 else [])
                    assert not bad, f"{f.name} imports ..{bad[0]}"
