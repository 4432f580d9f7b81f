"""Draft distillation and the verified draft pair in the port against the
JAX package, on the CPU (V=50, H=16, B=4, T=8).

- ``make_teacher_fn`` against JAX's on bridged params: float32 within 1e-5,
  bfloat16 within 1e-3 (both round as the plain scan does).
- ``make_distill_loss``: loss, kl, ce and every gradient against JAX's for
  one batch and the same teacher logits, alpha in {0, 0.5, 1} and
  temperature in {1, 2}, within 1e-5; and JAX's range refusals.
- 5 Adam steps of the distill step from bridged params against JAX's
  ``make_train_step(make_distill_loss(...))``: params within 1e-5.
- ``distill`` end to end returns ``draft_config`` of the teacher.
- ``publish_draft`` by one package and ``load_draft`` by the other, both
  ways, and the two refusals (config_hash, parent) in both packages.
- ``build_distill_parser`` and the serve flags ``--registry-dir``,
  ``--model-id`` and ``--draft-model`` against JAX's parsers.
- ``cli distill --device cpu`` (the teacher from a checkpoint or from the
  registry) publishes a draft that ``serve --selftest --speculative
  --registry-dir`` serves with zero mismatches; a pair that does not
  verify, a corpus wider than the teacher and a missing teacher are
  refused; ``/rollout`` answers 404.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve.registry import (ModelRegistry,
                                                   config_fingerprint,
                                                   encode_params)
from lstm_tensorspark_torch.serve.server import make_http_server
from lstm_tensorspark_torch.train import distill as tdist
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.train import distill as jdist
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

V, H, B, T = 50, 16, 4, 8
TOL = 1e-5


def _models(hidden=H, layers=2, compute="float32", seed=0, tied=False):
    kw = dict(vocab_size=V, hidden_size=hidden, num_layers=layers,
              compute_dtype=compute, tie_embeddings=tied)
    jparams = jax.device_get(init_lm(jax.random.PRNGKey(seed), LMConfig(**kw)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return LMConfig(**kw), jparams, tlm.LMConfig(**kw), tparams


def _tokens(n=4000, seed=0):
    return np.random.RandomState(seed).randint(0, V, size=n).astype(np.int32)


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("compute,tol", [("float32", 1e-5),
                                         ("bfloat16", 1e-3)])
def test_teacher_logits_match_jax(compute, tol):
    jcfg, jparams, tcfg, tparams = _models(compute=compute, seed=1)
    inputs = _tokens(B * T, seed=2).reshape(B, T)
    want = np.asarray(jdist.make_teacher_fn(jparams, jcfg)(inputs))
    got = tdist.make_teacher_fn(tparams, tcfg)(torch.from_numpy(inputs))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def _distill_batch(seed=3):
    rng = np.random.RandomState(seed)
    b = next(tbatch.lm_batch_stream(_tokens(seed=seed), B, T))
    b["teacher_logits"] = (rng.randn(B, T, V) * 2).astype(np.float32)
    return b


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("tau", [1.0, 2.0])
def test_distill_loss_and_grads_match_jax(alpha, tau):
    jcfg, jparams, tcfg, tparams = _models(layers=1, seed=4)
    b = _distill_batch()
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jdist.make_distill_loss(jcfg, alpha=alpha,
                                          temperature=tau)(p, b, None),
        has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tl, taux = tdist.make_distill_loss(tcfg, alpha=alpha, temperature=tau)(
        params, _tbatch(b))
    tg = torch.autograd.grad(tl, leaves)
    for k in ("loss", "kl", "ce"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   atol=TOL, rtol=0)
    assert taux["tokens"] == float(jaux["tokens"]) == B * T
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, e in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=1e-4)


@pytest.mark.parametrize("kw,match", [
    (dict(alpha=-0.1), "alpha must be in"),
    (dict(alpha=1.5), "alpha must be in"),
    (dict(temperature=0.0), "temperature must be > 0"),
])
def test_distill_loss_range_refusals(kw, match):
    cfg = tlm.LMConfig(vocab_size=V, hidden_size=H)
    with pytest.raises(ValueError, match=match):
        jdist.make_distill_loss(LMConfig(vocab_size=V, hidden_size=H), **kw)
    with pytest.raises(ValueError, match=match):
        tdist.make_distill_loss(cfg, **kw)


def test_adam_trajectory_matches_jax():
    """5 Adam steps (1e-3, cli distill's defaults) of a draft at config
    1's layout cut to V=50, H=16, from bridged params, on the same windows
    and the same teacher logits (JAX's teacher scores them)."""
    tjcfg, tjparams, _, _ = _models(hidden=4 * H, layers=1, seed=5)
    jdcfg = jdist.draft_config(tjcfg)
    jparams = jax.device_get(init_lm(jax.random.PRNGKey(6), jdcfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tdcfg = tdist.draft_config(tlm.LMConfig(vocab_size=V,
                                            hidden_size=4 * H))
    assert tdcfg.hidden_size == jdcfg.hidden_size == H
    jo = jopt.make_optimizer("adam", 1e-3)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(jdist.make_distill_loss(jdcfg), jo)
    to = topt.make_optimizer("adam", 1e-3)
    tstate = tloop.init_train_state(tparams, to)
    tstep = tloop.make_train_step(tdist.make_distill_loss(tdcfg), to,
                                  graph=False)
    teacher = jdist.make_teacher_fn(tjparams, tjcfg)
    batches = jdist.distill_batches(
        tbatch.lm_batch_stream(_tokens(seed=7), B, T),
        lambda x: np.asarray(teacher(x)))
    jl, tl = [], []
    for _ in range(5):
        b = next(batches)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=1e-4)


def test_distill_returns_the_draft_config(monkeypatch):
    _, _, tcfg, tparams = _models(hidden=64, layers=2, seed=8)
    records, scored = [], []
    make = tdist.make_teacher_fn

    def counted(*a, **k):
        score = make(*a, **k)
        return lambda x: scored.append(x.shape) or score(x)

    monkeypatch.setattr(tdist, "make_teacher_fn", counted)

    class Log:
        def log(self, r):
            records.append(r)

    dparams, dcfg = tdist.distill(
        tparams, tcfg, tbatch.lm_batch_stream(_tokens(seed=9), B, T),
        num_steps=4, log_every=2, logger=Log(), device="cpu")
    assert dcfg == tdist.draft_config(tcfg)
    assert (dcfg.hidden_size, dcfg.num_layers) == (16, 1)
    template = tlm.init_lm(torch.Generator().manual_seed(0), dcfg)
    for a, b in zip(tloop.param_leaves(dparams),
                    tloop.param_leaves(template)):
        assert a.shape == b.shape and a.device.type == "cpu"
        assert torch.isfinite(a).all()
    assert [r["step"] for r in records] == [2, 4]
    assert scored == [(B, T)] * 4  # one teacher pass a step, none spare
    assert all(np.isfinite(r["loss"]) for r in records)


@pytest.mark.parametrize("publisher", ["jax", "torch"])
def test_publish_by_one_package_load_by_the_other(tmp_path, publisher):
    jcfg, _, tcfg, _ = _models(hidden=64, layers=2, seed=10)
    jdcfg = jdist.draft_config(jcfg)
    jd = jax.device_get(init_lm(jax.random.PRNGKey(11), jdcfg))
    td = params_from_numpy(jax.tree.map(np.asarray, jd), device="cpu")
    d = str(tmp_path)
    if publisher == "jax":
        meta = jdist.publish_draft(d, jd, jdcfg, jcfg, teacher_id="lm")
        got_meta, got, dcfg = tdist.load_draft(d, tcfg, teacher_id="lm")
        assert dcfg == tdist.draft_config(tcfg)
        got = [t.numpy() for t in tloop.param_leaves(got)]
    else:
        meta = tdist.publish_draft(d, td, tdist.draft_config(tcfg), tcfg,
                                   teacher_id="lm")
        got_meta, got, dcfg = jdist.load_draft(d, jcfg, teacher_id="lm")
        assert dcfg == jdcfg
        got = [np.asarray(a) for a in jax.tree.leaves(got)]
    assert got_meta == meta and meta["model"] == "lm-draft"
    assert meta["parent"] == f"lm:{config_fingerprint(tcfg)}"
    for a, e in zip(got, jax.tree.leaves(jd)):
        np.testing.assert_array_equal(a, np.asarray(e))


@pytest.mark.parametrize("loader", ["jax", "torch"])
@pytest.mark.parametrize("refusal", ["config_hash", "parent"])
def test_load_draft_refuses_an_unverified_pair(tmp_path, loader, refusal):
    """A draft of another shape (config_hash), or one distilled for
    another teacher whose draft shape is the same (parent), is refused."""
    _, _, tcfg, _ = _models(hidden=64, layers=2)
    if refusal == "config_hash":
        dcfg = tdist.draft_config(tcfg, hidden_div=2)
        parent_cfg = tcfg
    else:
        dcfg = tdist.draft_config(tcfg)
        parent_cfg = tlm.LMConfig(vocab_size=V, hidden_size=64, num_layers=1)
    tdist.publish_draft(str(tmp_path),
                        tlm.init_lm(torch.Generator().manual_seed(0), dcfg),
                        dcfg, parent_cfg)
    load = jdist.load_draft if loader == "jax" else tdist.load_draft
    cfg = (LMConfig(vocab_size=V, hidden_size=64, num_layers=2)
           if loader == "jax" else tcfg)
    with pytest.raises(ValueError, match=f"draft default-draft v1: {refusal}"):
        load(str(tmp_path), cfg)


def _flag(p, dest):
    (a,) = [a for a in p._actions if a.dest == dest]
    return (a.option_strings, a.default,
            None if a.choices is None else list(a.choices), a.type, a.nargs,
            a.required)


def _dests(p):
    return {a.dest for a in p._actions if a.dest != "help"}


DISTILL_FLAGS = sorted(_dests(jcli.build_distill_parser()))


@pytest.mark.parametrize("dest", DISTILL_FLAGS)
def test_distill_flags_equal_jax(dest):
    assert (_flag(tcli.build_distill_parser(), dest)
            == _flag(jcli.build_distill_parser(), dest))


def test_distill_parser_adds_only_the_device():
    assert (_dests(tcli.build_distill_parser()) - set(DISTILL_FLAGS)
            == {"device"})


@pytest.mark.parametrize("dest", ["registry_dir", "model_id", "draft_model"])
def test_serve_registry_flags_equal_jax(dest):
    assert (_flag(tcli.build_serve_parser(), dest)
            == _flag(jcli.build_serve_parser(), dest))


# ---- the CLI ----------------------------------------------------------------

SERVE = ["serve", "--selftest", "--speculative", "--device", "cpu",
         "--sessions", "3", "--max-new-tokens", "10", "--vocab-size", "26",
         "--hidden-units", "32", "--num-layers", "1", "--prefill-buckets",
         "8,16", "--batch-buckets", "1,2,4"]
TEACHER = ["--vocab-size", "26", "--hidden-units", "32", "--num-layers",
           "1", "--device", "cpu"]


def _teacher_checkpoint(d):
    assert tcli.main(["train", "--device", "cpu", "--hidden-units", "32",
                      "--batch-size", "4", "--seq-len", "8", "--num-steps",
                      "4", "--log-every", "0", "--compute-dtype", "float32",
                      "--checkpoint-dir", d, "--checkpoint-every",
                      "4"]) == 0


@pytest.mark.parametrize("teacher", ["checkpoint", "registry"])
def test_cli_distill_then_serve_speculative(tmp_path, capsys, teacher):
    reg = str(tmp_path / "reg")
    src = []
    if teacher == "checkpoint":
        ck = str(tmp_path / "ck")
        _teacher_checkpoint(ck)
        src = ["--checkpoint-dir", ck]
    else:
        # the seeded weights `serve` draws from --seed 0, published as the
        # fleet's model
        cfg = tlm.LMConfig(vocab_size=26, hidden_size=32)
        ModelRegistry(reg).publish(
            "default",
            encode_params(tlm.init_lm(torch.Generator().manual_seed(0), cfg)),
            config_hash=config_fingerprint(cfg))
    capsys.readouterr()
    assert tcli.main(["distill", "--registry-dir", reg, "--steps", "6",
                      "--batch-size", "4", "--seq-len", "8",
                      "--log-every", "3"] + TEACHER + src) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])["distill"]
    assert rec["draft"] == "default-draft" and rec["version"] == 1
    assert (rec["hidden_size"], rec["num_layers"], rec["steps"]) == (8, 1, 6)
    assert rec["launch_counts"] == {}  # the CPU launches no kernel
    assert tcli.main(SERVE + ["--registry-dir", reg] + src) == 0
    out = capsys.readouterr().out
    report = json.loads([ln for ln in out.splitlines()
                         if '"serve_selftest"' in ln][0])
    assert report["mismatches"] == 0 and "serve selftest: PASS" in out
    assert report["draft"] == {"hidden_size": 8, "num_layers": 1,
                               "version": 1}
    assert sum(report["spec_windows_dispatched"].values()) > 0
    if teacher == "registry":  # the load generator's report names it too
        flags = [f for f in SERVE if f not in ("--selftest", "--sessions",
                                               "3")]
        assert tcli.main(flags + ["--loadgen", "--registry-dir", reg,
                                  "--compare", "", "--sessions", "2",
                                  "--requests-per-session", "1",
                                  "--greedy"]) == 0
        out = capsys.readouterr().out
        engine = json.loads(out.strip().splitlines()[-1])["engine"]
        assert engine["draft"] == report["draft"]


def test_cli_refusals(tmp_path):
    reg = str(tmp_path / "reg")
    ck = str(tmp_path / "ck")
    _teacher_checkpoint(ck)
    # a draft distilled for another teacher (its parent) is refused at boot
    other = tlm.LMConfig(vocab_size=26, hidden_size=32, num_layers=2)
    dcfg = tdist.draft_config(other)
    tdist.publish_draft(reg, tlm.init_lm(torch.Generator().manual_seed(0),
                                         dcfg), dcfg, other, draft_id="d2")
    with pytest.raises(SystemExit, match="does not match the serving "
                                         "teacher"):
        tcli.main(SERVE + ["--registry-dir", reg, "--checkpoint-dir", ck,
                           "--draft-model", "d2"])
    with pytest.raises(SystemExit, match="cannot load draft: unknown model"):
        tcli.main(SERVE + ["--registry-dir", reg, "--checkpoint-dir", ck])
    with pytest.raises(SystemExit, match="cannot load teacher 'default'"):
        tcli.main(["distill", "--registry-dir", reg] + TEACHER)
    # a teacher published for another config than the flags describe
    cfg = tlm.LMConfig(vocab_size=26, hidden_size=32)
    teacher = encode_params(tlm.init_lm(torch.Generator().manual_seed(0),
                                        cfg))
    ModelRegistry(reg).publish("default", teacher, config_hash="0" * 16)
    with pytest.raises(SystemExit, match="was published for config "
                                         "0000000000000000"):
        tcli.main(["distill", "--registry-dir", reg] + TEACHER)
    # the teacher cannot score tokens outside its embedding
    narrow = tlm.LMConfig(vocab_size=20, hidden_size=32)
    ModelRegistry(reg).publish(
        "v20", encode_params(tlm.init_lm(torch.Generator().manual_seed(0),
                                         narrow)),
        config_hash=config_fingerprint(narrow))
    with pytest.raises(SystemExit, match=r"corpus vocab \(26\) exceeds "
                                         r"--vocab-size \(20\)"):
        tcli.main(["distill", "--registry-dir", reg, "--device", "cpu",
                   "--model-id", "v20", "--vocab-size", "20",
                   "--hidden-units", "32", "--num-layers", "1"])
    with pytest.raises(SystemExit, match="distill: no checkpoint in"):
        tcli.main(["distill", "--registry-dir", reg, "--checkpoint-dir",
                   str(tmp_path / "none")] + TEACHER)


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_rollout_route_answers_not_found(method):
    args = tcli.build_serve_parser().parse_args(
        ["--http", "--device", "cpu", "--vocab-size", str(V),
         "--hidden-units", str(H), "--num-layers", "1", "--prefill-buckets",
         "8", "--batch-buckets", "1"])
    _, _, server = tcli._build_serve_stack(args)
    httpd = make_http_server(server, port=0)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/rollout", method=method,
            data=b"{}" if method == "POST" else None)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
        body = json.loads(e.value.read())
        assert body["code"] == "not_found"
        assert "rollout controller" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
