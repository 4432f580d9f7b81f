"""The port's telemetry plane and load generator, on the CPU against the
JAX package.

- **registry**: one script of ``inc`` / ``set`` / ``observe`` over
  labelled children (bucket edges, NaN and infinities included) fed to
  JAX's ``MetricsRegistry`` and the port's gives the same exposition text,
  byte for byte, the same ``parse_exposition`` result, quantiles,
  summaries, snapshots, deltas and aggregates, and the same refusals;
- **families**: both one-replica stacks, built without warmup, register
  the same families (kind, help, labels, buckets), except
  ``serve_compiles_total`` (XLA traces, which the port does not have);
- **pure functions**: ``arrival_offsets`` of every shape,
  ``_random_prompts``, ``template_mix_prompts``, ``_percentile``,
  ``_class_report``, ``_report``, ``retry_after_from_p99`` and a seeded
  ``backoff_delay`` equal JAX's;
- **telemetry** (``tests/test_serve_metrics.py``'s cases): ``/metrics``
  serves a valid exposition, registry counters track ``stats()``, the
  server-side TTFT and gap percentiles agree with the load generator's to
  within a bucket, ``NULL_REGISTRY`` disables it all;
- **CLI**: the new serve flags keep JAX's defaults and choices, its
  refusals, and ``serve --loadgen --device cpu`` runs closed-loop,
  open-loop, ``--idle-churn`` and ``--workload template-mix``, each
  writing a strict-JSON report whose per-class counts add up.
"""

import json
import math
import random
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import backoff as tbackoff
from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch import obs as tobs
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import ServeEngine, ServeServer
from lstm_tensorspark_torch.serve import batcher as tbatcher
from lstm_tensorspark_torch.serve import loadgen as tloadgen
from lstm_tensorspark_torch.serve.server import make_http_server
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu import obs as jobs
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.resilience import backoff as jbackoff
from lstm_tensorspark_tpu.serve import ServeEngine as JServeEngine
from lstm_tensorspark_tpu.serve import ServeServer as JServeServer
from lstm_tensorspark_tpu.serve import batcher as jbatcher
from lstm_tensorspark_tpu.serve import loadgen as jloadgen

torch.set_num_threads(1)

V, H = 50, 16


def _script(obs):
    """One sequence of registry operations; returns the registry and the
    families it made."""
    reg = obs.MetricsRegistry()
    c = reg.counter("req_total", "requests by outcome and replica",
                    labelnames=("outcome", "replica"))
    c.labels(outcome="ok", replica="0").inc()
    c.labels(outcome="ok", replica="1").inc(2.5)
    c.labels(outcome='we"ird\\x\n', replica="0").inc(float("inf"))
    bare = reg.counter("bare_total", "no labels")
    bare.inc(3)
    g = reg.gauge("depth", "a level", labelnames=("replica",))
    g.labels(replica="0").set(7)
    g.labels(replica="0").dec(2.25)
    g.labels(replica="1").set(float("nan"))
    reg.gauge("neg").set(float("-inf"))
    reg.gauge("big").set(1e16)
    h = reg.histogram("lat_seconds", "latency", labelnames=("replica",))
    for v in (0.0001, 0.00025, 0.0007, 0.01, 0.01, 2.5, 30.0, 61.0,
              float("inf"), 1e-9, 0.0):
        h.labels(replica="0").observe(v)
    for v in (0.5, 1.0, 1.0000001, 5.0):
        h.labels(replica="1").observe(v)
    k = reg.histogram("k_len", "custom buckets",
                      buckets=(0.0, 1.0, 2.0, 4.0))
    for v in (0.0, 0.0, 1.0, 3.0, 3.5, 9.0):
        k.observe(v)
    reg.histogram("empty_seconds", "never observed")
    return reg, {"c": c, "g": g, "h": h, "k": k}


def _same(a, b):
    """Equality where NaN equals NaN (via a JSON form that keeps them)."""
    return json.dumps(a, sort_keys=True, default=repr) == json.dumps(
        b, sort_keys=True, default=repr)


@pytest.fixture(scope="module")
def scripted():
    return _script(jobs), _script(tobs)


def test_exposition_text_is_byte_identical(scripted):
    (jreg, _), (treg, _) = scripted
    assert jreg.render_prometheus() == treg.render_prometheus()
    assert '\\"' in treg.render_prometheus()  # the escaping ran


def test_parse_exposition_agrees(scripted):
    (jreg, _), (treg, _) = scripted
    text = treg.render_prometheus()
    assert _same(jobs.parse_exposition(text), tobs.parse_exposition(text))
    bad = text.replace('le="+Inf"', 'le="99"', 1)
    errs = []
    for mod in (jobs, tobs):
        with pytest.raises(ValueError) as e:
            mod.parse_exposition(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_quantiles_and_summaries_agree(scripted):
    (_, jf), (_, tf) = scripted
    for rl in ("0", "1"):
        jh, th = jf["h"].labels(replica=rl), tf["h"].labels(replica=rl)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert _same(jh.quantile(q), th.quantile(q))
        assert _same(jh.summary(), th.summary())
    assert _same(jf["k"].summary(), tf["k"].summary())
    assert _same(jf["k"].quantile(0.5), tf["k"].quantile(0.5))


def test_summaries_snapshots_deltas_and_aggregates_agree(scripted):
    (jreg, jf), (treg, tf) = scripted
    assert _same(jreg.summaries(), treg.summaries())
    assert _same(jreg.snapshot(), treg.snapshot())
    for key in ("c", "g", "h"):
        assert _same(jf[key].aggregate_over("replica"),
                     tf[key].aggregate_over("replica"))
        assert _same(jf[key].aggregate_over("outcome"),
                     tf[key].aggregate_over("outcome"))
    jd, jcur = jf["h"].snapshot_delta()
    td, tcur = tf["h"].snapshot_delta()
    assert _same(jd, td) and jcur == tcur
    for fam in (jf["h"], tf["h"]):
        fam.labels(replica="2").observe(0.003)
    jd, jcur = jf["h"].snapshot_delta(jcur)
    td, tcur = tf["h"].snapshot_delta(tcur)
    assert _same(jd, td) and jcur == tcur
    for key in ("c", "g"):
        assert _same(jf[key].snapshot_delta()[0], tf[key].snapshot_delta()[0])


def test_registry_refusals_agree():
    msgs = []
    for obs in (jobs, tobs):
        reg = obs.MetricsRegistry()
        reg.counter("x_total", labelnames=("a",))
        out = []
        for bad in (lambda: reg.gauge("x_total", labelnames=("a",)),
                    lambda: reg.counter("x_total", labelnames=("b",)),
                    lambda: reg.counter("9bad"),
                    lambda: reg.counter("y", labelnames=("le",)),
                    lambda: reg.counter("x_total", labelnames=("a",))
                    .labels(b="1"),
                    lambda: reg.counter("z").inc(-1),
                    lambda: obs.Histogram((1.0, 1.0)),
                    lambda: reg.histogram("h"),
                    lambda: reg.histogram("h", buckets=(1.0, 2.0))):
            try:
                bad()
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        msgs.append(out)
    assert msgs[0] == msgs[1]


def test_null_registry_matches_jax():
    for name in ("counter", "gauge", "histogram"):
        j = getattr(jobs.NULL_REGISTRY, name)("a", labelnames=("x",))
        t = getattr(tobs.NULL_REGISTRY, name)("a", labelnames=("x",))
        j.labels(x="1").inc()
        t.labels(x="1").inc()
        assert (j.value, j.summary(), j.aggregate_over("x"),
                j.snapshot_delta()) == (t.value, t.summary(),
                                        t.aggregate_over("x"),
                                        t.snapshot_delta())
    assert (jobs.NULL_REGISTRY.render_prometheus()
            == tobs.NULL_REGISTRY.render_prometheus())
    assert tobs.REGISTRY is not jobs.REGISTRY
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS


# ---- the stacks' families -------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    jparams = init_lm(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


ENGINE_KW = dict(num_slots=8, prefill_buckets=(4, 8), batch_buckets=(1, 2, 4),
                 prefix_cache=True, prefix_stride=2, tiered_cache=True)


def _families(reg) -> dict:
    return {f.name: (f.kind, f.help, f.labelnames,
                     tuple(f._buckets) if f._buckets else None)
            for f in reg.families()}


def test_one_replica_stack_registers_every_jax_family(models, tmp_path):
    jcfg, jparams, tcfg, tparams = models
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jserver = JServeServer(JServeEngine(jparams, jcfg, registry=jreg,
                                        session_dir=str(tmp_path / "j"),
                                        **ENGINE_KW), max_active=4)
    tserver = ServeServer(ServeEngine(tparams, tcfg, device="cpu",
                                      registry=treg,
                                      session_dir=str(tmp_path / "t"),
                                      **ENGINE_KW), max_active=4)
    jtext, ttext = jserver.metrics_text(), tserver.metrics_text()
    jfam, tfam = _families(jreg), _families(treg)
    assert set(jfam) - set(tfam) == {"serve_compiles_total"}
    assert set(tfam) <= set(jfam)
    for name, spec in tfam.items():
        assert spec == jfam[name], name
    # the scrape-time gauges and the zero counters read alike
    jp, tp = jobs.parse_exposition(jtext), tobs.parse_exposition(ttext)
    jp.pop("serve_compiles_total")
    assert _same(jp, tp)


# ---- pure functions ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(rate=10.0), dict(arrival="burst", burst_n=3, burst_gap_s=0.4),
    dict(arrival="burst", burst_n=4, burst_gap_s=0.5, rate=20.0),
    dict(arrival="sine", rate=50.0, sine_period_s=0.3, sine_amp=0.5),
    dict(arrival_times=[0.0, 0.1, 0.35]), dict(arrival_times=[0.0]),
    dict(rate=0.0), dict(arrival="burst", burst_n=8, rate=1.0),
    dict(arrival="sine", rate=5.0, sine_amp=1.0),
    dict(arrival_times=[0.2, 0.1]), dict(arrival="poisson", rate=3.0)])
def test_arrival_offsets_match_jax(kw):
    outs = []
    for mod in (jloadgen, tloadgen):
        try:
            outs.append(mod.arrival_offsets(11, **kw))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_prompts_and_percentiles_match_jax():
    for args in ((6, 9, V, 3, 0), (4, 12, V, 0, 5)):
        j = jloadgen._random_prompts(*args)
        t = tloadgen._random_prompts(*args)
        assert [p.tolist() for p in j] == [p.tolist() for p in t]
    for mod in (jloadgen, tloadgen):
        with pytest.raises(ValueError):
            mod._random_prompts(2, 4, V, 0, 4)
    jp, jid = jloadgen.template_mix_prompts(
        9, vocab_size=V, tenants=2, templates=3, preamble_len=5,
        template_len=4, suffix_len=2, seed=1)
    tp, tid = tloadgen.template_mix_prompts(
        9, vocab_size=V, tenants=2, templates=3, preamble_len=5,
        template_len=4, suffix_len=2, seed=1)
    assert [p.tolist() for p in jp] == [p.tolist() for p in tp]
    assert jid == tid
    vals = sorted(np.random.RandomState(0).rand(37).tolist())
    for pct in (0, 1, 50, 90, 99, 100):
        assert jloadgen._percentile(vals, pct) == tloadgen._percentile(
            vals, pct)
    assert math.isnan(tloadgen._percentile([], 50))


def _records(seed):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(7):
        n = int(rng.randint(1, 9))
        recs.append({"latency_s": float(rng.rand()),
                     "ttft_s": None if i == 3 else float(rng.rand() / 10),
                     "tokens": n, "itl_s": rng.rand(n - 1).tolist(),
                     "replica": 0, "klass": "priority" if i % 3
                     else "best_effort"})
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_reports_match_jax(seed):
    recs = _records(seed)
    for args in ((recs, 2, 1, 3, 1.5), ([], 0, 0, 0, 1.0),
                 (recs[:1], 0, 0, 0, 0.0)):
        assert _same(jloadgen._class_report(*args),
                     tloadgen._class_report(*args))
    for args in ((recs, 3, 1, 2.5, "closed", 4), ([], 1, 0, 0.5, "open", 2)):
        assert _same(jloadgen._report(*args), tloadgen._report(*args))
    assert jloadgen._per_replica(recs) == tloadgen._per_replica(recs)


def test_retry_after_policy_and_backoff_match_jax():
    for p99 in (None, float("nan"), -1.0, 0.0, 0.001, 0.02, 0.3, 2.0, 25.0,
                100.0, 3):
        for fullness in (0.0, 0.25, 0.5, 1.0):
            assert (jbatcher.retry_after_from_p99(p99, fullness)
                    == tbatcher.retry_after_from_p99(p99, fullness))
    assert jbatcher.CLASSES == tbatcher.CLASSES
    jr, tr = random.Random(11), random.Random(11)
    for attempt in range(0, 12):
        for base, cap in ((0.05, 2.0), (0.5, 30.0), (0.0, 1.0)):
            assert (jbackoff.backoff_delay(base, attempt, cap=cap,
                                           rand=jr.random)
                    == tbackoff.backoff_delay(base, attempt, cap=cap,
                                              rand=tr.random))


# ---- telemetry of a running stack -------------------------------------------


def _server(models, registry, **kw):
    tcfg, tparams = models[2], models[3]
    engine = ServeEngine(tparams, tcfg, device="cpu", num_slots=8,
                         prefill_buckets=(4, 8), batch_buckets=(1, 2, 4),
                         registry=registry, **kw)
    return ServeServer(engine, max_active=4, queue_size=16)


def test_metrics_route_serves_valid_exposition(models):
    reg = tobs.MetricsRegistry()
    server = _server(models, reg)
    httpd = make_http_server(server, port=0)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    try:
        with server:
            body = json.dumps({"prompt": [5, 1, 2], "max_new_tokens": 6,
                               "greedy": True}).encode()
            req = urllib.request.Request(
                base + "/v1/generate", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                ctype = r.headers["Content-Type"]
                text = r.read().decode()
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert ctype.startswith("text/plain; version=0.0.4")
    fams = tobs.parse_exposition(text)
    for name in ("serve_ttft_seconds", "serve_itl_seconds",
                 "serve_queue_wait_seconds",
                 "serve_scheduler_iteration_seconds",
                 "serve_readback_seconds"):
        assert fams[name]["type"] == "histogram", name
        count = next(v for n, _, v in fams[name]["samples"]
                     if n == name + "_count")
        assert count >= 1, name
    ok = [v for n, lab, v in fams["serve_requests_total"]["samples"]
          if lab == {"outcome": "completed", "replica": "0"}]
    assert ok == [1.0]
    assert out["phases_ms"]["queue_ms"] >= 0
    assert out["phases_ms"]["prefill_ms"] > 0 and "decode_ms" in out[
        "phases_ms"]
    assert out["replica"] == 0 and out["class"] == "priority"
    ms = stats["metrics"]
    assert ms["serve_ttft_seconds"]["count"] == 1
    assert {"p50", "p99"} <= set(ms["serve_ttft_seconds"])
    assert stats["router"]["routed"] == {"0": 1}


def _bucket_of(value_s: float) -> int:
    for i, hi in enumerate(tobs.DEFAULT_LATENCY_BUCKETS):
        if value_s <= hi:
            return i
    return len(tobs.DEFAULT_LATENCY_BUCKETS)


def test_server_percentiles_agree_with_loadgen(models):
    """The server-side TTFT and gap histograms and the load generator's
    percentiles read the same timestamps: each server estimate sits in the
    loadgen value's bucket or, within scheduling noise, next to it."""
    reg = tobs.MetricsRegistry()
    server = _server(models, reg)
    with server:
        server.warmup(prompt_lens=(4,))
        report = tloadgen.run_loadgen(server, vocab_size=V, sessions=3,
                                      requests_per_session=3, prompt_len=4,
                                      max_new_tokens=6)
    assert report["failed"] == 0 and report["rejected"] == 0
    h_ttft = reg.histogram("serve_ttft_seconds",
                           labelnames=("replica",)).labels(replica="0")
    assert h_ttft.snapshot()[2] == report["completed"] == 9
    assert report["server_histograms"]["serve_ttft_seconds"]["count"] == 9
    for key, name in (("p50_ttft_ms", "serve_ttft_seconds"),
                      ("p99_ttft_ms", "serve_ttft_seconds"),
                      ("p50_itl_ms", "serve_itl_seconds"),
                      ("p99_itl_ms", "serve_itl_seconds")):
        lg_s = report[key] / 1e3
        q = 0.99 if key.startswith("p99") else 0.5
        srv_s = reg.histogram(name, labelnames=("replica",)).labels(
            replica="0").quantile(q)
        assert abs(_bucket_of(srv_s) - _bucket_of(lg_s)) <= 1, (key, srv_s,
                                                                lg_s)


def test_registry_counters_track_stats_counters(models):
    reg = tobs.MetricsRegistry()
    server = _server(models, reg, prefix_cache=True, prefix_stride=2)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    with server:
        for _ in range(3):
            server.generate(prompt, max_new_tokens=5)
    engine = server.engine
    st, bs = engine.prefix.stats(), server.batcher.stats()
    fam = reg.counter("serve_prefix_cache_events_total",
                      labelnames=("event",))
    for event, key in (("hit", "hits"), ("miss", "misses"),
                       ("insert", "inserts")):
        assert fam.labels(event=event).value == st[key] >= 1
    assert (reg.counter("serve_state_cache_swaps_total").value
            == engine.cache.stats()["generation"] > 0)
    s = reg.summaries()
    assert s['serve_requests_total{outcome="completed",replica="0"}'] == (
        bs["completed"]) == 3
    assert s["serve_ttft_seconds"]["count"] == 3
    windows = {k: s[f'serve_decode_windows_total{{k="{k}",replica="0"}}']
               for k in bs["window_ladder"]}
    assert windows == {k: bs["windows_dispatched"].get(k, 0)
                       for k in bs["window_ladder"]}
    assert s["serve_itl_seconds"]["count"] == bs["tokens_generated"] - 3


def test_null_registry_disables_serve_telemetry(models):
    server = _server(models, tobs.NULL_REGISTRY)
    with server:
        req = server.generate([1, 2, 3], max_new_tokens=4)
    assert len(req.tokens) == 4
    assert server.metrics_summary() == {}
    assert "disabled" in server.metrics_text()
    assert server.stats()["metrics"] == {}


# ---- the command line -------------------------------------------------------


NEW_FLAGS = ("class_weights", "best_effort_queue_frac", "deadline_priority_s",
             "deadline_best_effort_s", "tenant_rate", "tenant_burst",
             "replicas", "telemetry", "requests_per_session", "prompt_len",
             "mode", "rate", "arrival", "arrival_trace", "burst_n",
             "burst_gap", "sine_period", "sine_amp", "compare",
             "shared_prefix_len", "inject_prompt_len", "inject_delay",
             "workload", "tenants", "templates", "preamble_len",
             "template_len", "suffix_len", "workers", "idle_churn", "zipf_s",
             "priority_frac", "deadline_s", "retry_max", "json", "loadgen",
             "sessions", "max_new_tokens", "queue_size")


def test_serve_parsers_agree_on_the_admission_and_loadgen_flags():
    jp, tp = jcli.build_serve_parser(), tcli.build_serve_parser()

    def flag(p, dest):
        (a,) = [a for a in p._actions if a.dest == dest]
        return a.option_strings, a.default, a.choices, a.type, a.nargs

    for dest in NEW_FLAGS:
        assert flag(tp, dest) == flag(jp, dest), dest
    for bad in ("4", "0,1", "a,b"):
        with pytest.raises(SystemExit, match="--class-weights"):
            tcli._parse_class_weights(bad)


@pytest.mark.parametrize("argv", [
    ["--shared-prefix-len", "8", "--prompt-len", "8"],
    ["--arrival", "burst"], ["--arrival-trace", "t.txt"]])
def test_loadgen_refusals_match_jax(argv, capsys):
    base = ["serve", "--loadgen", "--device", "cpu"]
    assert tcli.main(base + argv) == 2
    t_err = capsys.readouterr().err
    assert jcli.main(["serve", "--loadgen"] + argv) == 2
    assert capsys.readouterr().err == t_err


def test_replicas_other_than_one_are_refused():
    for spec in ("2", "1,2"):
        with pytest.raises(SystemExit, match="serves one replica"):
            tcli.main(["serve", "--loadgen", "--device", "cpu",
                       "--replicas", spec])


SMALL = ["serve", "--loadgen", "--device", "cpu", "--hidden-units", "16",
         "--num-layers", "1", "--vocab-size", str(V), "--max-new-tokens",
         "6", "--prefill-buckets", "8,16,32", "--batch-buckets", "1,2,4"]


@pytest.mark.parametrize("extra", [
    ["--sessions", "4", "--requests-per-session", "2", "--compare", "",
     "--priority-frac", "0.5", "--retry-max", "2"],
    ["--mode", "open", "--rate", "400", "--arrival", "burst", "--burst-n",
     "4", "--sessions", "4", "--requests-per-session", "2", "--queue-size",
     "2", "--priority-frac", "0.5", "--deadline-s", "5"],
    ["--idle-churn", "--sessions", "10", "--num-slots", "4",
     "--max-active", "4", "--requests-per-session", "2"],
    ["--workload", "template-mix", "--sessions", "6", "--tenants", "2",
     "--templates", "2", "--preamble-len", "6", "--template-len", "4",
     "--suffix-len", "2", "--workers", "3"],
], ids=["closed", "open", "idle-churn", "template-mix"])
def test_serve_loadgen_writes_a_strict_json_report(extra, tmp_path, capsys):
    path = tmp_path / "report.json"
    assert tcli.main(SMALL + extra + ["--json", str(path)]) == 0
    text = path.read_text()
    report = json.loads(text, parse_constant=lambda c: pytest.fail(c))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line, parse_constant=lambda c: pytest.fail(c)) == (
        report)
    assert report["failed"] == 0
    assert report["completed"] > 0 and report["tokens_generated"] > 0
    assert report["engine"]["device"] == "cpu"
    if "classes" in report:
        total = sum(c["completed"] + c["shed"] + c["timeouts"]
                    for c in report["classes"].values())
        assert total == report["requests"] - report["failed"]
        assert report["requests"] == (report["completed"]
                                      + report["rejected"]
                                      + report["timeouts"])
