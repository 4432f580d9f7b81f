"""Admission classes, deadlines and the one-replica router of the port's
serve plane, on the CPU against the JAX package.

The cases of ``tests/test_serve_deadline.py``, where the port has the
feature, run on both stacks (``jax``: the JAX package's ``ServeServer`` on
one shared engine, whose registry is read as deltas; ``torch``: the port's,
on a fresh engine with its own registry): queue reaping without a slot or
a prefill, reaping behind the head, decode-boundary expiry whose partial
output is a prefix of the uninterrupted greedy output, per-class default
deadlines and the explicit-zero opt-out, ``Request`` validation, the 4:1
weighted dequeue (the same admission order as JAX's for one mixed queue),
the router shedding ``best_effort`` first with ``Retry-After``, the
batcher-level 429, Retry-After tracking the queue-wait p99, loadgen's
retries and per-class counts, and the uniform HTTP error bodies. The port
alone: a row that expires while its successor window is in flight parks
its slot until that window is fetched; a timed-out kept session's tier
copies are discarded; mixed-class greedy tokens equal the plain generate.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.obs import MetricsRegistry as TRegistry
from lstm_tensorspark_torch.serve import (
    DeadlineExceededError,
    QueueFullError,
    Request,
    ServeEngine,
    ServeServer,
    make_http_server,
    retry_after_from_p99,
    run_loadgen,
)
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.obs import MetricsRegistry as JRegistry
from lstm_tensorspark_tpu.serve import DeadlineExceededError as JDeadline
from lstm_tensorspark_tpu.serve import QueueFullError as JQueueFull
from lstm_tensorspark_tpu.serve import Request as JRequest
from lstm_tensorspark_tpu.serve import ServeEngine as JServeEngine
from lstm_tensorspark_tpu.serve import ServeServer as JServeServer
from lstm_tensorspark_tpu.serve.server import make_http_server as jmake_http

torch.set_num_threads(1)

V, H = 29, 16
PROMPT = np.array([1, 2, 3], np.int32)
N_REF = 48
STACKS = ("jax", "torch")
# each stack raises its own package's classes
DEADLINE = (DeadlineExceededError, JDeadline)
QUEUE_FULL = (QueueFullError, JQueueFull)


@pytest.fixture(scope="module")
def models():
    """(port cfg, port params, JAX engine shared by every JAX stack, JAX
    greedy reference of PROMPT)."""
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    jparams = init_lm(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jengine = JServeEngine(jparams, jcfg, num_slots=8,
                           prefill_buckets=(4, 8), batch_buckets=(1, 2, 4, 8),
                           registry=JRegistry())
    gen = make_generate_fn(jcfg, max_new_tokens=N_REF, greedy=True)
    ref = np.asarray(gen(jparams, jnp.asarray(PROMPT[None, :]),
                         jax.random.PRNGKey(0)))[0, PROMPT.size:].tolist()
    return tcfg, tparams, jengine, ref


def _stack(models, kind, **kw):
    """(server, registry, Request class) of one stack, unstarted."""
    tcfg, tparams, jengine, _ = models
    kw.setdefault("max_active", 4)
    kw.setdefault("queue_size", 8)
    if kind == "jax":
        return JServeServer(jengine, **kw), jengine.metrics, JRequest
    reg = TRegistry()
    engine = ServeEngine(tparams, tcfg, device="cpu", num_slots=8,
                         prefill_buckets=(4, 8), batch_buckets=(1, 2, 4, 8),
                         registry=reg)
    return ServeServer(engine, **kw), reg, Request


def _value(summaries: dict, key: str) -> float:
    v = summaries.get(key, 0)
    return v["count"] if isinstance(v, dict) else v


def _delta(reg, before: dict, key: str) -> float:
    return _value(reg.summaries(), key) - _value(before, key)


def _hint(reg, fullness: float) -> float:
    """The Retry-After the shared policy gives for the registry's live
    queue-wait p99 (the JAX stacks share one engine, so their waits are
    not cold)."""
    fam = reg.histogram("serve_queue_wait_seconds", labelnames=("replica",))
    p99 = (fam.aggregate_over("replica").get("") or {}).get("p99")
    return retry_after_from_p99(p99, fullness)


def _prefills(server) -> int:
    """Prefill work so far: the JAX engine's prefill traces (its own
    test's proxy), the port engine's prefill dispatches."""
    eng = server.engine
    if hasattr(eng, "num_compiles"):
        return eng.num_compiles("prefill")
    return eng.stats()["dispatches"]["prefill"]


def _plain(models, n: int) -> list[int]:
    tcfg, tparams = models[0], models[1]
    out = tgen.generate(tparams, PROMPT[None, :], tcfg, max_new_tokens=n,
                        greedy=True, device="cpu")
    return out[0, PROMPT.size:].tolist()


# ---- deadlines ----------------------------------------------------------


@pytest.mark.parametrize("kind", STACKS)
def test_queue_expired_request_reaped_without_slot_or_prefill(models, kind):
    server, reg, Req = _stack(models, kind)
    before = reg.summaries()
    b = server.batcher
    req = Req(PROMPT, 4, deadline_s=0.05)
    b.submit(req)
    assert req.deadline == pytest.approx(req.t_submit + 0.05)
    time.sleep(0.12)
    cache_before = server.engine.cache.stats()
    prefills = _prefills(server)
    b.step()
    assert req.done.is_set() and req.timed_out
    assert req.error is None and req.tokens == []
    after = server.engine.cache.stats()
    assert (after["live_sessions"], after["pinned"]) == (
        cache_before["live_sessions"], cache_before["pinned"])
    assert _prefills(server) == prefills
    assert [p[0] for p in req.phases] == ["queue"]
    assert req.phases[0][1] == req.t_submit
    assert _delta(reg, before,
                  'serve_requests_total{outcome="timeout",replica="0"}') == 1
    assert _delta(reg, before, 'serve_deadline_expired_total'
                  '{stage="queue",replica="0"}') == 1
    assert b.stats()["timed_out"] == 1


@pytest.mark.parametrize("kind", STACKS)
def test_queue_expiry_reaps_behind_the_head(models, kind):
    server, _, Req = _stack(models, kind)
    b = server.batcher
    live, doomed = Req([1, 2], 2), Req([3, 4], 2, deadline_s=0.05)
    b.submit(live)
    b.submit(doomed)
    time.sleep(0.12)
    b.drain()
    assert doomed.timed_out and doomed.tokens == []
    assert not live.timed_out and len(live.tokens) == 2


@pytest.mark.parametrize("kind", STACKS)
def test_decode_boundary_expiry_returns_a_greedy_prefix(models, kind):
    """The deadline lapses mid-decode: the request settles at a window
    boundary with partial output that is a prefix of the uninterrupted
    greedy output (never a token of a window run past the deadline and
    dropped), and the session is not kept."""
    server, _, _ = _stack(models, kind)
    with server:
        server.generate(PROMPT, max_new_tokens=8, timeout=60.0)  # warm
        with pytest.raises(DEADLINE) as ei:
            server.generate(PROMPT, max_new_tokens=100000, deadline_s=0.15,
                            keep_session=True, timeout=60.0)
    req = ei.value.request
    assert req.timed_out and 0 < len(req.tokens) < 100000
    assert req.tokens == _plain(models, len(req.tokens))
    n = min(len(req.tokens), N_REF)
    assert req.tokens[:n] == models[3][:n]
    assert server.engine.cache.stats()["live_sessions"] == 0


def test_expiry_under_an_in_flight_window_parks_the_slot(models):
    """A row whose deadline lapses after its successor window was
    dispatched settles at once, its session id leaves the cache at once,
    and its slot stays pinned under a reserved id until that window is
    fetched; the tokens are still a greedy prefix."""
    server, _, _ = _stack(models, "torch")
    b = server.batcher
    req = Request(PROMPT, 40, deadline_s=60.0)
    b.submit(req)
    while b._pending is None:
        b.step()
    calls = []

    def expired(now=None):  # live at the pipeline check, lapsed after
        calls.append(now)
        return len(calls) > 1

    req.expired = expired
    b.step()  # dispatches the successor, fetches, then settles the row
    assert req.timed_out and b._pending is not None
    sid_rows = server.engine.cache.session_ids()
    assert len(sid_rows) == 1 and sid_rows[0].startswith("prefix/timed-out/")
    assert server.engine.cache.stats()["pinned"] == 1
    b.drain()
    assert server.engine.cache.stats()["live_sessions"] == 0
    assert req.tokens == _plain(models, len(req.tokens))


def test_timed_out_kept_session_discards_tier_copies(models, tmp_path):
    tcfg, tparams = models[0], models[1]
    engine = ServeEngine(tparams, tcfg, device="cpu", num_slots=8,
                         prefill_buckets=(4, 8), batch_buckets=(1, 2, 4),
                         registry=TRegistry(), session_dir=str(tmp_path))
    server = ServeServer(engine, max_active=4, queue_size=8)
    with server:
        r1 = server.generate(PROMPT, max_new_tokens=2, keep_session=True,
                             timeout=30.0)
        sid = r1.session_id
        engine.tiers.flush(timeout=15.0)
        assert engine.has_session(sid)
        with pytest.raises(DEADLINE) as ei:
            server.generate([r1.tokens[-1]], max_new_tokens=100000,
                            session_id=sid, keep_session=True,
                            deadline_s=0.2, timeout=30.0)
        assert len(ei.value.request.tokens) > 0
        assert not engine.has_session(sid)
        with pytest.raises(RuntimeError, match="unknown session"):
            server.generate([1], max_new_tokens=2, session_id=sid,
                            timeout=30.0)
    assert engine.cache.stats()["live_sessions"] == 0


@pytest.mark.parametrize("kind", STACKS)
def test_per_class_default_deadline_applied(models, kind):
    server, _, _ = _stack(models, kind,
                          deadline_defaults={"best_effort": 0.05})
    with server:
        r = server.generate(PROMPT, max_new_tokens=2, timeout=30.0)
        assert len(r.tokens) == 2 and r.deadline_s is None
        with pytest.raises(DEADLINE) as ei:
            server.generate(PROMPT, max_new_tokens=100000,
                            klass="best_effort", timeout=30.0)
        assert ei.value.request.deadline_s == 0.05


@pytest.mark.parametrize("kind", STACKS)
def test_explicit_zero_deadline_opts_out_of_default(models, kind):
    server, _, _ = _stack(models, kind, deadline_defaults={"priority": 0.05})
    with server:
        with pytest.raises(DEADLINE):
            server.generate(PROMPT, max_new_tokens=100000, timeout=30.0)
        r = server.generate(PROMPT, max_new_tokens=4, deadline_s=0,
                            timeout=30.0)
        assert len(r.tokens) == 4 and r.deadline_s is None


@pytest.mark.parametrize("kwargs", [
    {"klass": "vip"}, {"deadline_s": 0.0}, {"deadline_s": -1.0},
    {"tenant": ""}, {"tenant": "t" * 257}])
def test_request_validation_matches_jax(kwargs):
    msgs = []
    for Req in (JRequest, Request):
        with pytest.raises(ValueError) as e:
            Req([1], 1, **kwargs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_default_deadline_refusals_match_jax(models):
    msgs = []
    for kind in STACKS:
        for bad in ({"vip": 1.0}, {"priority": -1.0}):
            with pytest.raises(ValueError) as e:
                _stack(models, kind, deadline_defaults=bad)
            msgs.append((kind, str(e.value)))
    assert [m for k, m in msgs if k == "jax"] == [
        m for k, m in msgs if k == "torch"]


# ---- weighted dequeue and shedding ---------------------------------------


@pytest.mark.parametrize("kind", STACKS)
def test_weighted_dequeue_prefers_priority(models, kind):
    server, _, Req = _stack(models, kind, max_active=5, queue_size=16)
    b = server.batcher
    reqs = ([Req([1, 2], 1, klass="best_effort") for _ in range(5)]
            + [Req([1, 2], 1) for _ in range(5)])
    for r in reqs:
        b.submit(r)
    b.step()  # capacity 5: 4 priority + 1 best_effort
    done = [(r.klass, r.done.is_set()) for r in reqs]
    assert (sum(1 for k, d in done if d and k == "priority"),
            sum(1 for k, d in done if d and k == "best_effort")) == (4, 1)
    b.drain()
    assert all(r.done.is_set() and r.error is None for r in reqs)


@pytest.mark.parametrize("weights", [(4, 1), (1, 1), (2, 3)])
def test_admission_order_matches_jax(models, weights):
    """One mixed queue, admitted one request a step: the port admits in
    JAX's weighted round-robin order."""
    pattern = "bbbpbpppbbpbpbbp"
    orders = []
    for kind in STACKS:
        server, _, Req = _stack(models, kind, max_active=1, queue_size=32,
                                class_weights=weights)
        reqs = [Req([1, 2], 1, klass="priority" if c == "p"
                    else "best_effort") for c in pattern]
        for r in reqs:
            server.batcher.submit(r)
        order = []
        while len(order) < len(reqs):
            server.batcher.step()
            order += [i for i, r in enumerate(reqs)
                      if r.done.is_set() and i not in order]
        orders.append(order)
    assert orders[0] == orders[1]


@pytest.mark.parametrize("kind", STACKS)
def test_router_sheds_best_effort_first_with_retry_after(models, kind):
    server, reg, Req = _stack(models, kind, queue_size=8,
                              best_effort_queue_frac=0.5)
    before = reg.summaries()
    for _ in range(4):
        server.router.submit(Req([1, 2], 2))
    with pytest.raises(QUEUE_FULL) as ei:
        server.router.submit(Req([1, 2], 2, klass="best_effort"))
    assert ei.value.retry_after_s == pytest.approx(_hint(reg, 0.5))
    for _ in range(4):
        server.router.submit(Req([1, 2], 2))
    with pytest.raises(QUEUE_FULL) as ei2:
        server.router.submit(Req([1, 2], 2))
    assert ei2.value.retry_after_s == pytest.approx(_hint(reg, 1.0))
    st = server.router.stats()
    assert st["shed_by_class"] == {"priority": 1, "best_effort": 1}
    assert st["best_effort_bound"] == 4 and st["routed"] == {"0": 8}
    assert _delta(reg, before, 'serve_shed_total{class="best_effort",'
                  'tenant_limited="no"}') == 1
    assert _delta(reg, before, 'serve_shed_total{class="priority",'
                  'tenant_limited="no"}') == 1
    assert _delta(reg, before, "serve_retry_after_seconds") == 2
    server.batcher.drain()


def test_router_stats_match_jax(models):
    stats = []
    for kind in STACKS:
        server, _, Req = _stack(models, kind, queue_size=4,
                                best_effort_queue_frac=0.25)
        for klass in ("priority", "best_effort", "priority", "best_effort",
                      "priority", "priority", "priority"):
            try:
                server.router.submit(Req([1, 2], 2, klass=klass))
            except QUEUE_FULL:
                pass
        stats.append(server.router.stats())
        server.batcher.drain()
    assert stats[0] == stats[1]


@pytest.mark.parametrize("kind", STACKS)
def test_batcher_level_429_also_carries_retry_after(models, kind):
    server, reg, Req = _stack(models, kind, queue_size=1)
    before = reg.summaries()
    b = server.batcher
    b.submit(Req([1, 2], 2))
    with pytest.raises(QUEUE_FULL) as ei:
        b.submit(Req([1, 2], 2, klass="best_effort"))
    assert ei.value.retry_after_s == pytest.approx(_hint(reg, 1.0))
    assert _delta(reg, before, 'serve_shed_total{class="best_effort",'
                  'tenant_limited="no"}') == 1
    assert _delta(reg, before, "serve_retry_after_seconds") == 1
    b.drain()


def test_retry_after_scales_with_queue_wait_p99(models):
    """Both routers hint the same Retry-After from the same queue-wait
    samples (each router on a fresh registry seeded with 2 s waits): the
    p99 estimate inside the (1.0, 2.5] bucket, scaled by the full
    queue's 1.5."""
    from lstm_tensorspark_torch.serve import Replica, Router
    from lstm_tensorspark_tpu.serve.router import Replica as JReplica
    from lstm_tensorspark_tpu.serve.router import Router as JRouter

    hints = []
    for kind, reg, router_cls, replica_cls in (
            ("jax", JRegistry(), JRouter, JReplica),
            ("torch", TRegistry(), Router, Replica)):
        server, _, Req = _stack(models, kind, queue_size=4)
        router = router_cls([replica_cls(0, server.engine, server.batcher)],
                            queue_size=4, registry=reg)
        fam = reg.histogram("serve_queue_wait_seconds",
                            labelnames=("replica",))
        for _ in range(50):
            fam.labels(replica="0").observe(2.0)
        for _ in range(4):
            router.submit(Req([1, 2], 2))
        with pytest.raises(QUEUE_FULL) as ei:
            router.submit(Req([1, 2], 2))
        hints.append(ei.value.retry_after_s)
        server.batcher.drain()
    assert 2.0 <= hints[1] <= 4.5
    assert hints[0] == hints[1]


# ---- loadgen and HTTP ----------------------------------------------------


@pytest.mark.parametrize("kind", STACKS)
def test_loadgen_retries_sheds_with_backoff_and_reports_classes(models,
                                                                kind):
    server, _, _ = _stack(models, kind, queue_size=2, max_active=1,
                          best_effort_queue_frac=0.5)
    if kind == "torch":
        loadgen = run_loadgen
    else:
        from lstm_tensorspark_tpu.serve import run_loadgen as loadgen
    with server:
        report = loadgen(server, vocab_size=V, sessions=6,
                         requests_per_session=2, prompt_len=4,
                         max_new_tokens=8, mode="open", rate=400.0, seed=0,
                         priority_frac=0.5, retry_max=2, retry_base_s=0.01,
                         retry_cap_s=0.1)
    assert set(report["classes"]) == {"priority", "best_effort"}
    for cls in report["classes"].values():
        assert {"completed", "shed", "retried", "timeouts",
                "p99_ttft_ms"} <= set(cls)
    assert sum(c["retried"] for c in report["classes"].values()) >= 1
    assert report["requests"] == 12 == (
        report["completed"] + report["rejected"] + report["failed"]
        + report["timeouts"])
    for c, cls in report["classes"].items():
        assert cls["completed"] + cls["shed"] + cls["timeouts"] == 6, c


def _post(base, body, headers=None):
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _error_replies(server, Req, make_http):
    httpd = make_http(server, port=0)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    out = {}
    try:
        out["bad"] = _post(base, {"prompt": None})
        try:
            urllib.request.urlopen(base + "/nope", timeout=30)
        except urllib.error.HTTPError as e:
            out["404"] = (e.code, dict(e.headers), json.loads(e.read()))
        for _ in range(2):
            server.router.submit(Req([1, 2], 2))
        out["429"] = _post(base, {"prompt": [1, 2], "max_new_tokens": 2})
        with server:
            out["warm"] = _post(base, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 8, "greedy": True})
            out["504"] = _post(base, {"prompt": [1, 2, 3],
                                      "max_new_tokens": 100000,
                                      "greedy": True},
                               headers={"X-Deadline-S": "0.3"})
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                out["metrics"] = r.status
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def test_http_error_bodies_are_uniform_and_match_jax(models):
    replies = {}
    for kind, make_http in (("jax", jmake_http), ("torch", make_http_server)):
        server, _, Req = _stack(models, kind, queue_size=2,
                                deadline_defaults={"best_effort": 0.15})
        replies[kind] = _error_replies(server, Req, make_http)
    for kind, out in replies.items():
        code, _, body = out["bad"]
        assert code == 400 and body["code"] == "bad_request"
        assert body["retryable"] is False and body["retry_after_s"] is None
        assert out["404"][0] == 404 and out["404"][2]["code"] == "not_found"
        code, headers, body = out["429"]
        assert code == 429 and body["code"] == "queue_full"
        assert body["retryable"] is True and body["retry_after_s"] > 0
        assert int(headers["Retry-After"]) >= 1
        assert out["warm"][0] == 200
        code, _, body = out["504"]
        assert code == 504 and body["code"] == "deadline_exceeded"
        assert body["retryable"] is True and len(body["tokens"]) > 0
        assert body["tokens"] == _plain(models, len(body["tokens"]))
        assert out["metrics"] == 200, kind
    for key in ("bad", "404", "429", "504"):
        j, t = replies["jax"][key], replies["torch"][key]
        assert j[0] == t[0] and set(j[2]) == set(t[2]), key
        assert ("Retry-After" in j[1]) == ("Retry-After" in t[1]), key
    j, t = replies["jax"]["429"][2], replies["torch"]["429"][2]
    assert (j["error"].split("; retry after")[0]
            == t["error"].split("; retry after")[0])
    assert set(replies["jax"]["warm"][2]) == set(replies["torch"]["warm"][2])


def test_mixed_class_greedy_tokens_equal_plain_generate(models):
    """Requests of both classes and both deadline forms, completed under
    the weighted dequeue, carry the plain generate's greedy tokens (and
    JAX's, over its reference length)."""
    server, _, _ = _stack(models, "torch", max_active=3, queue_size=32)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, V, size=rng.randint(2, 8)).astype(np.int32)
               for _ in range(8)]
    got = [None] * len(prompts)

    def run(i):
        got[i] = server.generate(
            prompts[i], max_new_tokens=12, timeout=60.0,
            klass="best_effort" if i % 2 else "priority",
            deadline_s=30.0 if i % 3 == 0 else None).tokens

    with server:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    tcfg, tparams = models[0], models[1]
    for p, toks in zip(prompts, got):
        ref = tgen.generate(tparams, p[None, :], tcfg, max_new_tokens=12,
                            greedy=True, device="cpu")[0, p.size:].tolist()
        assert toks == ref
    assert server.engine.cache.stats()["pinned"] == 0


def test_tenant_token_bucket_matches_jax(models):
    """--tenant-rate: a tenant past its burst is refused before the class
    bound, counted as tenant-limited, with the same hint on both stacks;
    untenanted traffic is never limited."""
    outs = []
    for kind in STACKS:
        server, _, Req = _stack(models, kind, queue_size=32, tenant_rate=0.5,
                                tenant_burst=2)
        got = []
        for tenant in ("a", "a", "b", "a", None, None, None):
            try:
                server.router.submit(Req([1, 2], 1, tenant=tenant))
                got.append("ok")
            except QUEUE_FULL as e:
                got.append(("429", round(e.retry_after_s, 1)))
        st = server.router.stats()
        outs.append((got, st["tenant_limited"], st["shed_by_class"]))
        server.batcher.drain()
    assert outs[0] == outs[1]
    assert outs[1][0].count("ok") == 6 and outs[1][1]["priority"] == 1


def test_request_id_replays_the_settled_reply(models):
    server, reg, _ = _stack(models, "torch")
    httpd = make_http_server(server, port=0)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    body = {"prompt": [1, 2, 3], "max_new_tokens": 6, "greedy": True,
            "request_id": "r-1"}
    try:
        with server:
            first = _post(base, body)
            again = _post(base, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert first[0] == again[0] == 200
    assert again[2]["tokens"] == first[2]["tokens"] == _plain(models, 6)
    assert again[2]["replayed"] is True and "replayed" not in first[2]
    assert server.batcher.stats()["completed"] == 1
    s = reg.summaries()
    assert (s['serve_replay_dedup_total{result="store"}'],
            s['serve_replay_dedup_total{result="hit"}']) == (1, 1)


def test_dead_scheduler_fails_its_requests_and_refuses_new_ones(models):
    """A scheduler thread that exits outside stop() is swept on the next
    submit: its queued requests fail with the reason, the stack counts
    them, and later submits raise instead of queueing forever."""
    server, reg, _ = _stack(models, "torch")
    queued = Request(PROMPT, 4)
    server.router.submit(queued)

    server.batcher.run = lambda stop_event: None  # the thread just ends
    server.start()
    server._thread.join(10)
    with pytest.raises(RuntimeError, match="no routable replica"):
        server.router.submit(Request(PROMPT, 4))
    assert queued.done.is_set() and "scheduler died" in queued.error
    st = server.router.stats()
    assert (st["failed_on_death"], st["live"], st["retired"]) == (1, 0, [0])
    assert reg.summaries()["serve_router_death_failures_total"] == 1
    assert server.health()["status"] == "down"
    server.stop()
