"""The port's seq2seq forecaster path (BASELINE.md config 4) against the
JAX package's, on the CPU.

- data: the ``uci_electricity`` stand-in and ``_uci_real`` on a small
  semicolon CSV with decimal commas, byte-equal to the JAX package's;
  ``forecast_starts`` / ``forecast_windows`` (shuffled, and with the
  ``valid=False`` filler tail) byte-equal; ``slice_forecast_batch`` over
  the staged series equal to ``forecast_windows``' batches;
- the forecaster's parameter conversion, bit-exact both ways;
- ``seq2seq_loss``: loss, MAE and every parameter gradient against
  ``jax.value_and_grad`` of the JAX ``seq2seq_loss`` on bridged parameters,
  1 and 2 layers and with ``remat_chunk``, within 1e-5 in float32, on the
  plain route and on the resident pair's route (the kernels' plain twins
  on the CPU: the encoder's final carries enter the decoder's
  ``LSTMRecurrence`` and its dh0 / dc0 come back as the encoder's dhT /
  dcT); in bfloat16 against JAX's plain bfloat16 scan at
  ``tests/test_torch_bf16.py``'s plain tolerances;
- ``forecast`` (the free-running decode) within 1e-5 of JAX's;
- 5 Adam + clip steps of ``make_train_step`` against JAX's;
- ``train --dataset uci_electricity`` on the CPU: records, the ``min``
  best metric, K = 4 ``--device-data --fused-eval`` against the host-fed
  run, resume bit for bit, the refusals.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import (seq2seq_params_from_numpy,
                                            seq2seq_params_to_numpy)
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import datasets as tdata
from lstm_tensorspark_torch.data import device_dataset as tdev
from lstm_tensorspark_torch.exit_codes import OK_RC, USAGE_RC
from lstm_tensorspark_torch.models import seq2seq as tseq
from lstm_tensorspark_torch.ops import cuda_lstm
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.data import batching as jbatch
from lstm_tensorspark_tpu.data import datasets as jdata
from lstm_tensorspark_tpu.models import seq2seq as jseq
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

TOL = 1e-5
# the plain bfloat16 loop against JAX's plain bfloat16 scan: one rounding
# scheme (tests/test_torch_bf16.py's PLAIN_ATOL and PLAIN_GRAD)
PLAIN_ATOL, PLAIN_GRAD = 1e-4, 5e-3

SMALL = ["train", "--dataset", "uci_electricity", "--device", "cpu",
         "--hidden-units", "16", "--batch-size", "8", "--seq-len", "24",
         "--optimizer", "adam", "--learning-rate", "1e-3",
         "--clip-norm", "1.0", "--compute-dtype", "float32"]


def _same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# ---- data ----


@pytest.mark.parametrize("kw", [{}, dict(num_series=3, length=700, seed=2)])
def test_uci_standin_byte_equal(kw):
    t = tdata.get_dataset("uci_electricity", **kw)
    j = jdata.get_dataset("uci_electricity", **kw)
    assert t["synthetic"] and j["synthetic"]
    assert t["num_features"] == j["num_features"] == kw.get("num_series", 8)
    _same_arrays({s: t[s] for s in ("train", "valid", "test")},
                 {s: j[s] for s in ("train", "valid", "test")})
    n = kw.get("length", 10_000)
    assert len(t["train"]) == int(n * 0.8) and t["train"].dtype == np.float32


CSV = ('"";"MT_001";"MT_002";"MT_003"\n'
       + "".join(f'"2011-01-01 00:{15 * i:02d}:00";{i},5;{2 * i};{i}2,25\n'
                 for i in range(14))
       + '"2011-01-01 04:00:00";3,5\n'          # too few fields: skipped
       + '"2011-01-01 04:15:00";;7,75;1\n'      # an empty field reads as 0
       + '"2011-01-01 04:30:00";9;8;7\n')


@pytest.mark.parametrize("num_series", [2, 3, 8])
def test_uci_real_csv_byte_equal(tmp_path, num_series):
    path = tmp_path / "LD2011_2014.txt"
    path.write_text(CSV)
    for where in (str(tmp_path), str(path)):
        t = tdata.get_dataset("uci_electricity", where, num_series=num_series)
        j = jdata.get_dataset("uci_electricity", where, num_series=num_series)
        assert not t["synthetic"] and not j["synthetic"]
        assert t["num_features"] == j["num_features"] == min(num_series, 3)
        _same_arrays({s: t[s] for s in ("train", "valid", "test")},
                     {s: j[s] for s in ("train", "valid", "test")})
    bad = tmp_path / "bad.txt"
    bad.write_text("a;b\n1\n")
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="UCI LD2011_2014 format"):
            mod._uci_real(str(bad), num_series=2)


@pytest.fixture(scope="module")
def series():
    return tdata.get_dataset("uci_electricity", num_series=3, length=400,
                             seed=1)["valid"]


@pytest.mark.parametrize("kw", [
    dict(context_len=12, horizon=6, batch_size=4, shuffle_seed=3),
    dict(context_len=7, horizon=24, batch_size=4, shuffle_seed=None,
         drop_remainder=False),
    dict(context_len=1, horizon=1, batch_size=16, shuffle_seed=0,
         drop_remainder=False)])
def test_forecast_windows_byte_equal(series, kw):
    got = list(tbatch.forecast_windows(series, **kw))
    ref = list(jbatch.forecast_windows(series, **kw))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        _same_arrays(a, b)
    if kw.get("drop_remainder") is False:
        last = got[-1]
        assert not last["valid"].all()
        # the filler repeats the last window
        f = int(last["valid"].sum())
        assert (last["context"][f:] == last["context"][f - 1]).all()
    n = len(series) - kw["context_len"] - kw["horizon"] + 1
    assert np.array_equal(tbatch.forecast_starts(n, shuffle_seed=9),
                          jbatch.forecast_starts(n, shuffle_seed=9))
    with pytest.raises(ValueError, match="series length"):
        next(tbatch.forecast_windows(series[:5], 4, 2, 1))


def test_slice_forecast_batch_matches_windows(series):
    C, Hz, B = 12, 6, 4
    staged = tdev.stage_series(series, C, Hz, device="cpu")
    assert staged.num_windows == len(series) - C - Hz + 1
    starts = tbatch.forecast_starts(staged.num_windows, shuffle_seed=5)
    ref = tbatch.forecast_windows(series, C, Hz, B, shuffle_seed=5)
    for i in range(3):
        idx = torch.from_numpy(starts[i * B:(i + 1) * B].astype(np.int32))
        got = tdev.slice_forecast_batch(staged.arrays, idx, C, Hz)
        _same_arrays({k: v.numpy() for k, v in got.items()}, next(ref))
    with pytest.raises(ValueError, match="series length"):
        tdev.stage_series(series[:10], C, Hz, device="cpu")


# ---- the model against JAX's ----


def _models(L, F=3, H=16, remat=None, dtype="float32", horizon=6, seed=0):
    jcfg = jseq.Seq2SeqConfig(num_features=F, hidden_size=H, num_layers=L,
                              horizon=horizon, compute_dtype=dtype,
                              remat_chunk=remat)
    jparams = jseq.init_seq2seq(jax.random.PRNGKey(seed), jcfg)
    tcfg = tseq.Seq2SeqConfig(num_features=F, hidden_size=H, num_layers=L,
                              horizon=horizon, compute_dtype=dtype,
                              remat_chunk=remat)
    tparams = seq2seq_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(B=6, C=12, horizon=6, F=3, seed=1):
    rng = np.random.RandomState(seed)
    return {"context": rng.randn(B, C, F).astype(np.float32),
            "targets": rng.randn(B, horizon, F).astype(np.float32),
            "valid": np.ones(B, bool)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _kernel_route(monkeypatch):
    """Every recurrence of the model through the kernels' route (on CPU
    tensors: their plain twins, under the same autograd Functions)."""
    def route(*a, bptt="sequential", **k):
        return tscan.kernel_lstm_scan(*a, **k)

    monkeypatch.setattr(tscan, "auto_lstm_scan", route)
    monkeypatch.setattr(tseq, "auto_lstm_scan", route)


def _loss_and_grads(jcfg, jparams, tcfg, tparams, b):
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jseq.seq2seq_loss(p, b, jcfg), has_aux=True))(jparams)
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tl, taux = tseq.seq2seq_loss(params, _tb(b), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == 24 * jcfg.num_layers + 2
    return tl, taux, tg, float(jl), jaux, jleaves


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("L,remat", [(1, None), (2, None), (1, 4), (2, 3)])
def test_seq2seq_loss_and_grads_match_jax(route, L, remat, monkeypatch):
    jcfg, jparams, tcfg, tparams = _models(L, remat=remat, seed=L)
    b = _batch()
    if route == "kernels":
        _kernel_route(monkeypatch)
        cuda_lstm.fwd_counts.reset()
        cuda_lstm.bwd_counts.reset()
    tl, taux, tg, jl, jaux, jleaves = _loss_and_grads(jcfg, jparams, tcfg,
                                                      tparams, b)
    if route == "kernels":
        # encoder and decoder: a resident forward a layer each; the fused
        # backward where there is no remat (the encoder's under remat is
        # the plain recompute)
        assert cuda_lstm.fwd_counts.reference == 2 * L
        assert cuda_lstm.bwd_counts.reference == (L if remat else 2 * L)
    np.testing.assert_allclose(tl.item(), jl, atol=TOL, rtol=0)
    np.testing.assert_allclose(taux["mae"].item(), float(jaux["mae"]),
                               atol=TOL, rtol=0)
    for a, e in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("L,remat", [(1, None), (2, 4)])
def test_seq2seq_loss_bf16_matches_jax_plain(L, remat):
    jcfg, jparams, tcfg, tparams = _models(L, remat=remat, dtype="bfloat16",
                                           seed=3)
    tl, taux, tg, jl, jaux, jleaves = _loss_and_grads(jcfg, jparams, tcfg,
                                                      tparams, _batch(seed=4))
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5, atol=0)
    assert all(g.dtype == torch.float32 for g in tg)
    for i, (a, e) in enumerate(zip(tg, jleaves)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   err_msg=f"leaf {i}",
                                   atol=PLAIN_GRAD * float(np.abs(e).max()))


@pytest.mark.parametrize("L,dtype,horizon", [(1, "float32", 24),
                                             (2, "float32", 6),
                                             (2, "bfloat16", 6)])
def test_forecast_matches_jax(L, dtype, horizon):
    jcfg, jparams, tcfg, tparams = _models(L, dtype=dtype, horizon=horizon,
                                           seed=5)
    ctx = _batch(seed=6)["context"]
    ref = np.asarray(jax.jit(lambda p, c: jseq.forecast(p, c, jcfg))(
        jparams, ctx))
    with torch.no_grad():
        got = tseq.forecast(tparams, torch.from_numpy(ctx), tcfg).numpy()
    assert got.shape == ref.shape == (6, horizon, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL if dtype == "float32" else PLAIN_ATOL)


def test_seq2seq_params_convert_bit_exact():
    _, jparams, _, tparams = _models(2)
    jtree = jax.tree.map(np.asarray, jparams)
    back = seq2seq_params_to_numpy(tparams)
    for side in ("encoder", "decoder"):
        assert len(back[side]) == 2
        for tl_, jl_ in zip(back[side], jtree[side]):
            for f in tl_:
                assert tl_[f].tobytes() == getattr(jl_, f).tobytes()
    for k in ("kernel", "bias"):
        assert back["proj"][k].tobytes() == jtree["proj"][k].tobytes()
    again = seq2seq_params_from_numpy(back, device="cpu")
    for a, b in zip(tloop.param_leaves(again), tloop.param_leaves(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_seq2seq_shapes_and_order():
    cfg = tseq.Seq2SeqConfig(num_features=3, hidden_size=8, num_layers=2)
    p = tseq.init_seq2seq(torch.Generator().manual_seed(0), cfg)
    assert p["encoder"][0].W_i.shape == (3, 8)
    assert p["decoder"][1].W_i.shape == (8, 8)
    assert p["proj"]["kernel"].shape == (8, 3)
    assert not p["proj"]["bias"].any()
    assert sorted(p) == ["decoder", "encoder", "proj"]
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        tseq.Seq2SeqConfig(num_features=3, compute_dtype="float16")


def test_train_trajectory_matches_jax():
    """5 Adam steps (lr 1e-2, clip 1.0) from bridged params on the same
    windows: losses, grad norms and the final params."""
    jcfg, jparams, tcfg, tparams = _models(1, seed=7)
    jo = jopt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(
        lambda p, b, rng: jseq.seq2seq_loss(p, b, jcfg), jo)
    to = topt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    tstate = tloop.init_train_state(tparams, to)
    tstep = tloop.make_train_step(
        lambda p, b: tseq.seq2seq_loss(p, b, tcfg), to)
    jl, tl = [], []
    for i in range(5):
        b = _batch(seed=10 + i)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=1e-4)


# ---- the train command ----


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_cli_train_forecaster_end_to_end(tmp_path):
    """``train --dataset uci_electricity`` on the CPU: exits 0, the loss
    falls, evals at the cadence with ``new best eval_mse`` records, and a
    final eval record; the start record names the windows' geometry."""
    path = tmp_path / "m.jsonl"
    rc = tcli.main(SMALL + ["--num-steps", "40", "--log-every", "10",
                            "--eval-every", "20", "--eval-batches", "3",
                            "--learning-rate", "1e-2", "--jsonl", str(path)])
    assert rc == OK_RC
    recs = _records(path)
    start = next(r for r in recs if r.get("note") == "start")
    assert (start["features"], start["context"], start["horizon"],
            start["steps_per_epoch"]) == (8, 24, 24, (8000 - 47) // 8)
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(r["tokens_per_sec"] > 0 for r in recs if "loss" in r)
    evals = [r for r in recs if "eval_mse" in r and "note" not in r]
    assert [r["step"] for r in evals] == [20, 40]
    best = [r for r in recs if r.get("note") == "new best eval_mse"]
    assert best and best[0]["step"] == 20
    assert recs[-1]["note"] == "final"
    assert recs[-1]["eval_mse"] == evals[-1]["eval_mse"] > 0
    assert 0 < recs[-1]["eval_mae"]


def test_best_mode_min_and_max():
    """``train_loop``'s best metric: a falling MSE is a new best under
    ``min``, a rising accuracy under ``max``; NaN never is."""
    def run(values, mode):
        out = []
        it = iter(values)

        class Log:
            def log(self, rec):
                out.append(rec)

        def step(state, batch):
            return state, {"loss": torch.zeros(()),
                           "grad_norm": torch.zeros(()),
                           "anomalous": torch.zeros(())}

        tloop.train_loop(tloop.TrainState(0, {}, {}), step, range(4),
                         log_every=0, logger=Log(), eval_every=1,
                         eval_fn=lambda p: {"m": next(it)}, best_metric="m",
                         best_mode=mode)
        return [r["m"] for r in out if r.get("note") == "new best m"]

    assert run([3.0, 2.0, float("nan"), 2.5], "min") == [3.0, 2.0]
    assert run([3.0, 2.0, float("nan"), 3.5], "max") == [3.0, 3.5]
    assert run([float("nan"), 1.0, 0.5, 0.7], "min") == [1.0, 0.5]
    with pytest.raises(ValueError, match="best_mode"):
        tloop.train_loop(tloop.TrainState(0, {}, {}), None, [],
                         best_mode="lowest")


def _drive(argv, calls):
    """The run ``train <argv>`` builds, driven ``calls`` calls: (the calls'
    metrics, the final state, the run)."""
    run = tcli.training(argv[1:])
    state, feed, ms = run.state, iter(run.feed), []
    for i in range(calls):
        if run.loop_kw["fused_eval"] is not None:
            state, m = run.step(state, next(feed), (i + 1) % 2 == 0)
        else:
            state, m = run.step(state, next(feed))
        ms.append({k: float(v) for k, v in m.items()})
    return ms, state, run


def test_device_data_fused_eval_matches_host_fed():
    """K = 4 ``--device-data --fused-eval`` against the host-fed run at
    K = 1: the same windows, so the same losses and params bit for bit; the
    fused eval within 1e-6 of the host eval of the same params."""
    base = SMALL + ["--eval-every", "2", "--eval-batches", "2"]
    host, hstate, hrun = _drive(base, 8)
    dev, dstate, drun = _drive(base + ["--steps-per-call", "4",
                                       "--device-data", "--fused-eval"], 2)
    assert dstate.step == hstate.step == 8
    assert [m["loss_last"] for m in dev] == [host[3]["loss"],
                                            host[7]["loss"]]
    assert dev[0]["loss"] == pytest.approx(
        float(np.mean([m["loss"] for m in host[:4]])), abs=1e-7)
    for a, b in zip(tloop.param_leaves(dstate.params),
                    tloop.param_leaves(hstate.params)):
        assert torch.equal(a, b)
    assert dev[0]["eval_mse"] != dev[0]["eval_mse"]  # not an eval call
    ev = hrun.eval_fn(hstate.params)
    for k in ("eval_mse", "eval_mae"):
        assert dev[1][k] == pytest.approx(ev[k], abs=1e-6)
    # the host-fed fused K-step call takes the same steps and evaluates
    # the same way
    hf, _, _ = _drive(base + ["--steps-per-call", "4", "--fused-eval"], 2)
    assert [m["loss_last"] for m in hf] == [m["loss_last"] for m in dev]
    for k in ("eval_mse", "eval_mae"):
        assert hf[1][k] == pytest.approx(dev[1][k], abs=1e-6)


@pytest.mark.parametrize("name,extra,ckpt_every", [
    ("k1", ["--num-steps", "12"], "4"),
    ("k4-device-data", ["--num-steps", "16", "--steps-per-call", "4",
                        "--device-data"], "1"),
    ("k2-bf16", ["--num-steps", "8", "--steps-per-call", "2",
                 "--compute-dtype", "bfloat16"], "2")])
def test_resume_bit_for_bit(tmp_path, name, extra, ckpt_every):
    """A run resumed from its oldest kept checkpoint logs every later loss
    equal to the whole run's (params, Adam moments, step and data
    cursor restored; no carries, no generators)."""
    base = SMALL + extra + ["--log-every", "1", "--checkpoint-every",
                            ckpt_every]
    whole_dir, res_dir = tmp_path / "whole", tmp_path / "resumed"

    def run(tag, flags):
        path = tmp_path / f"{tag}.jsonl"
        assert tcli.main(base + flags + ["--jsonl", str(path)]) == OK_RC
        recs = _records(path)
        return recs, {r["step"]: r["loss"] for r in recs
                      if "loss" in r and "note" not in r}

    _, whole = run("whole", ["--checkpoint-dir", str(whole_dir)])
    kept = sorted(int(n[5:-3]) for n in os.listdir(whole_dir)
                  if n.endswith(".pt"))
    mid = kept[0]
    saved = torch.load(whole_dir / f"step_{mid}.pt", weights_only=True)
    assert saved["carries"] is None and saved["generators"] == []
    assert sorted(saved["opt_state"]) == ["count", "mu", "nu"]
    os.makedirs(res_dir)
    for suffix in (".pt", ".pt.sha256"):
        shutil.copy(whole_dir / f"step_{mid}{suffix}", res_dir)
    recs, resumed = run("resumed", ["--checkpoint-dir", str(res_dir),
                                    "--resume"])
    assert any(r.get("note") == f"resumed at step {mid}" for r in recs)
    want = [s for s in sorted(whole) if s > mid]
    assert want and sorted(resumed) == want
    assert [resumed[s] for s in want] == [whole[s] for s in want]


@pytest.mark.parametrize("flags,msg", [
    (["--stateful"], "--stateful applies to contiguous-stream LM"),
    (["--batch-size", "9000"], "train series too short"),
    (["--seq-len", "8000"], "train series too short"),
    (["--device-data", "--prefetch", "2"], "--device-data has no host feed")])
def test_cli_forecaster_refusals(flags, msg, capsys):
    rc = tcli.main(SMALL + ["--num-steps", "1", *flags])
    assert rc == USAGE_RC
    assert msg in capsys.readouterr().err


def test_fused_eval_falls_back_without_a_valid_window(tmp_path):
    """A valid series shorter than one window: the fused eval falls back
    to the host eval with JAX's note, and every eval is skipped."""
    path = tmp_path / "m.jsonl"
    rc = tcli.main(["train", "--dataset", "uci_electricity", "--device",
                    "cpu", "--hidden-units", "4", "--batch-size", "2",
                    "--seq-len", "980", "--num-steps", "2", "--eval-every",
                    "1", "--fused-eval", "--jsonl", str(path)])
    assert rc == OK_RC
    recs = _records(path)
    assert any(r.get("note", "").startswith("fused-eval: valid series "
                                            "shorter than one window")
               for r in recs)
    assert recs[-1] == {**recs[-1], "eval_skipped": 1, "note": "final"}
