"""Kept sessions and the session tiers of the port's serve plane, on the CPU
against the JAX package.

A kept session continued from wherever its state went — its device slot,
a detach to host and a restore, a pending spill whose slot was reused
before the spill was copied, the host tier, the disk tier, or the disk
after a restart — gives the tokens of one uninterrupted JAX
``make_generate_fn`` run. Without tiers an evicted continuation fails as
an unknown session; an un-kept completion discards the tiers' copies; a
corrupt session file is quarantined; ``fill_batch`` equals fills one by
one. Session files are byte-compatible with the JAX package's disk tier
in both directions, and one script of acquire / pin / unpin / release /
evict gives the same slots, evictions and tier counters on JAX's
``StateCache`` + ``SessionTiers`` and on the port's. Over HTTP,
``session_id`` and ``keep_session`` work and ``/v1/stats`` carries the
prefix-cache and tier sections; the serve parsers agree on the new flags.
"""

import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import (
    Batcher,
    Request,
    ServeEngine,
    ServeServer,
    make_http_server,
    session_file_path,
)
from lstm_tensorspark_torch.serve import state_cache as tsc
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.serve import state_cache as jsc

torch.set_num_threads(1)

V, H, L = 41, 24, 2
N_TOTAL = 12
PROMPT = np.array([3, 17, 9, 40, 1, 22, 5], np.int32)


@pytest.fixture(scope="module")
def models():
    """(port cfg, port params, the uninterrupted JAX greedy tokens of
    PROMPT): the one JAX generate shape of this file."""
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(21), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    gen = make_generate_fn(jcfg, max_new_tokens=N_TOTAL, greedy=True)
    ref = np.asarray(gen(jparams, jnp.asarray(PROMPT[None, :]),
                         jax.random.PRNGKey(0)))[0, PROMPT.size:].tolist()
    return tcfg, tparams, ref


def _engine(models, **kw):
    tcfg, tparams, _ = models
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2))
    return ServeEngine(tparams, tcfg, device="cpu", **kw)


def _run(b: Batcher, req: Request) -> Request:
    b.submit(req)
    b.drain()
    return req


def _churn(b: Batcher, sid: str, n: int = 4) -> None:
    """Admit fresh kept sessions until ``sid`` leaves its device slot."""
    for i in range(n):
        _run(b, Request(np.array([1 + i, 2], np.int32), 1, keep_session=True))
        if sid not in b.engine.cache:
            return
    raise AssertionError(f"{sid!r} never evicted")


def _continue(b: Batcher, first: Request, sid: str | None = None,
              n: int | None = None) -> Request:
    """The continuation of ``first``'s session: its last token as the
    prompt, the rest of the N_TOTAL budget."""
    return _run(b, Request(np.array([first.tokens[-1]], np.int32),
                           N_TOTAL - len(first.tokens) if n is None else n,
                           session_id=sid or first.session_id))


@pytest.mark.parametrize("where", ["device", "detach", "pending", "host",
                                   "disk", "restart"])
def test_kept_session_continues_token_identically(models, where, tmp_path,
                                                  monkeypatch):
    """A request split at token 4 and continued from each place a kept
    session's state can be equals one uninterrupted JAX run."""
    ref = models[2]
    kw = {}
    if where in ("pending", "host"):
        kw = {"tiered_cache": True}
    elif where in ("disk", "restart"):
        kw = {"session_dir": str(tmp_path), "host_tier_entries": 1}
    engine = _engine(models, **kw)
    b = Batcher(engine, max_active=2, queue_size=8)
    first = _run(b, Request(PROMPT, 4, keep_session=True))
    assert first.error is None
    sid = first.session_id
    assert sid is not None and sid in engine.cache
    if where == "detach":
        state = engine.detach_session(sid)
        assert sid not in engine.cache
        # churn: other sessions take (and dirty) its old slot
        _run(b, Request(np.array([1, 2, 3], np.int32), 3))
        _run(b, Request(np.array([4, 5], np.int32), 3))
        engine.restore_session(sid, state)
    elif where == "pending":
        # hold the spill worker off: the evicted slot is reused by the
        # churn's prefill before any host copy of the spill is made
        monkeypatch.setattr(engine.tiers, "_ensure_worker_locked",
                            lambda: None)
        _churn(b, sid)
        assert engine.tiers.resident_tier(sid) == "pending"
    elif where == "host":
        _churn(b, sid)
        assert engine.tiers.flush(timeout=30)
        assert engine.tiers.resident_tier(sid) == "host"
    elif where == "disk":
        for i in range(4):  # the host tier of 1 overflows sid to disk
            _run(b, Request(np.array([5 + i, 2, 4], np.int32), 1,
                            keep_session=True))
        assert engine.tiers.flush(timeout=30)
        assert engine.tiers.resident_tier(sid) == "disk"
    elif where == "restart":
        assert engine.tiers.flush(timeout=30)
        assert os.path.exists(session_file_path(str(tmp_path), sid))
        engine.tiers.close()
        engine = _engine(models, **kw)  # a new server on the same directory
        b = Batcher(engine, max_active=2, queue_size=8)
        assert sid not in engine.cache and engine.has_session(sid)
    cont = _continue(b, first, sid)
    assert cont.error is None, cont.error
    assert first.tokens + cont.tokens == ref
    if where in ("pending", "host"):
        assert engine.tiers.stats()["fills"]["host"] == 1
    elif where in ("disk", "restart"):
        assert engine.tiers.stats()["fills"]["disk"] == 1


def test_kept_session_continues_twice_in_place(models):
    ref = models[2]
    b = Batcher(_engine(models, num_slots=4), max_active=2, queue_size=8)
    a = _run(b, Request(PROMPT, 2, keep_session=True))
    c = _run(b, Request([a.tokens[-1]], 4, session_id=a.session_id,
                        keep_session=True))
    d = _continue(b, c, a.session_id, n=N_TOTAL - 6)
    assert a.tokens + c.tokens + d.tokens == ref
    # d was not kept: its completion released the slot
    assert a.session_id not in b.engine.cache


def test_evicted_continuation_without_tiers_fails_as_expired(models):
    engine = _engine(models, num_slots=1, batch_buckets=(1,))
    b = Batcher(engine, max_active=1, queue_size=8)
    a = _run(b, Request(np.array([1, 2], np.int32), 2, keep_session=True))
    _run(b, Request(np.array([3, 4], np.int32), 2))  # recycles the slot
    cont = _continue(b, a, n=2)
    assert cont.error is not None and "unknown session" in cont.error
    assert "expired" in cont.error
    assert b.stats()["failed"] == 1


def test_unkept_completion_discards_tier_copies(models, tmp_path):
    engine = _engine(models, session_dir=str(tmp_path))
    b = Batcher(engine, max_active=2, queue_size=8)
    a = _run(b, Request(PROMPT, 3, keep_session=True))
    sid = a.session_id
    _churn(b, sid)
    assert engine.tiers.flush(timeout=30)
    assert engine.tiers.has(sid)
    assert os.path.exists(session_file_path(str(tmp_path), sid))
    done = _continue(b, a, n=2)  # not kept: the conversation ends here
    assert done.error is None
    assert engine.tiers.flush(timeout=30)
    assert not engine.tiers.has(sid) and sid not in engine.cache
    assert not os.path.exists(session_file_path(str(tmp_path), sid))
    again = _continue(b, done, sid, n=2)
    assert again.error is not None and "unknown session" in again.error


def test_corrupt_session_file_is_quarantined(models, tmp_path):
    engine = _engine(models, session_dir=str(tmp_path))
    b = Batcher(engine, max_active=2, queue_size=8)
    a = _run(b, Request(PROMPT, 3, keep_session=True))
    assert engine.tiers.flush(timeout=30)
    path = session_file_path(str(tmp_path), a.session_id)
    engine.tiers.close()
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0xFF  # a flipped bit in c: the header's sha256 catches it
    open(path, "wb").write(bytes(data))
    engine = _engine(models, session_dir=str(tmp_path))
    b = Batcher(engine, max_active=2, queue_size=8)
    cont = _continue(b, a)
    assert cont.error is not None and "unknown session" in cont.error
    assert not os.path.exists(path)
    assert os.path.exists(path + ".quarantined")
    st = engine.tiers.stats()
    assert st["corrupt"] == 1 and st["misses"] == 1 and st["fills"] == {
        "host": 0, "disk": 0}


def _spilled_setup(models, tmp_path, seed):
    """A tiered cache of 5 slots with five random sessions spilled: two to
    disk (the host tier of 1 overflows), one to the host tier, two still
    pending; the slots are free again."""
    engine = _engine(models, num_slots=5, session_dir=str(tmp_path),
                     host_tier_entries=1)
    cache, tiers = engine.cache, engine.tiers
    rng = np.random.RandomState(seed)
    sids = [f"u{i}" for i in range(5)]
    for sid in sids:
        slot, _ = cache.acquire(sid)
        cache.write_slots([slot], rng.randn(L, 1, H), rng.randn(L, 1, H))
    for sid in ("w0", "w1", "w2"):
        cache.acquire(sid)
    assert tiers.flush(timeout=30)
    tiers._ensure_worker_locked = lambda: None  # the next two stay pending
    for sid in ("w3", "w4"):
        cache.acquire(sid)
    where = {sid: tiers.resident_tier(sid) for sid in sids}
    assert where == {"u0": "disk", "u1": "disk", "u2": "host",
                     "u3": "pending", "u4": "pending"}, where
    for sid in ("w0", "w1", "w2", "w3", "w4"):
        cache.release(sid)
    return engine, sids


def test_fill_batch_equals_fills_one_by_one(models, tmp_path):
    one, sids = _spilled_setup(models, tmp_path / "a", 4)
    many, _ = _spilled_setup(models, tmp_path / "b", 4)
    slots = {}
    for e in (one, many):
        for sid in sids:
            slots[id(e), sid] = e.cache.acquire_pinned(sid)[0]
    for sid in sids:
        assert one.tiers.fill(sid, slots[id(one), sid])
    got = many.tiers.fill_batch([(sid, slots[id(many), sid]) for sid in sids])
    assert got == {sid: True for sid in sids}
    for sid in sids:
        a, b = slots[id(one), sid], slots[id(many), sid]
        assert torch.equal(one.cache.h[:, a], many.cache.h[:, b])
        assert torch.equal(one.cache.c[:, a], many.cache.c[:, b])
    assert one.tiers.stats()["fills"] == many.tiers.stats()["fills"] == {
        "host": 3, "disk": 2}


def test_session_files_are_interchangeable_with_jax(tmp_path):
    rng = np.random.RandomState(6)
    state = (rng.randn(L, H).astype(np.float32),
             rng.randn(L, H).astype(np.float32))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jsc._DiskTier(str(jdir)).put("conv/7", jsc.DetachedState(*state))
    tsc._DiskTier(str(tdir)).put("conv/7", tsc.DetachedState(*state))
    jpath = jsc.session_file_path(str(jdir), "conv/7")
    tpath = session_file_path(str(tdir), "conv/7")
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # each package reads the other's file (a fresh index: the startup scan)
    got = tsc._DiskTier(str(jdir)).get("conv/7", L, H)
    np.testing.assert_array_equal(got.h, state[0])
    np.testing.assert_array_equal(got.c, state[1])
    back = jsc._DiskTier(str(tdir)).get("conv/7", L, H)
    np.testing.assert_array_equal(back.h, state[0])
    np.testing.assert_array_equal(back.c, state[1])


def _script(cache, tiers, write, evicted):
    """One script of session-table moves; returns what each step gave."""
    rng = np.random.RandomState(9)
    out = []
    for i in range(4):
        slot, fresh = cache.acquire(f"s{i}")
        write(cache, slot, rng.randn(L, 1, H).astype(np.float32))
        out.append((slot, fresh))
    cache.pin("s1")
    out.append(cache.acquire("s0"))  # a hit refreshes s0's recency
    out.append(cache.acquire_pinned("n0"))  # evicts s2 (s1 pinned)
    out.append(cache.acquire("n1"))  # evicts s3
    cache.unpin("s1")
    cache.release("s0")
    out.append(cache.acquire("n2"))  # the free slot s0 left
    out.append(cache.acquire("n3"))  # evicts s1
    out.append(cache.is_pinned("n0"))
    out.append(cache.session_ids())
    assert tiers.flush(timeout=30)
    out.append([tiers.resident_tier(sid) for sid in ("s0", "s1", "s2",
                                                      "s3", "n0")])
    slot, _ = cache.acquire_pinned("s3")  # evicts n1
    out.append((slot, tiers.fill("s3", slot), tiers.fill("gone", slot)))
    assert tiers.flush(timeout=30)
    out.append(list(evicted))
    st = tiers.stats()
    out.append({k: st[k] for k in ("host_entries_max", "entries", "spills",
                                   "fills", "misses", "corrupt", "lost",
                                   "disk_errors")})
    out.append(cache.stats())
    return out


def test_table_script_matches_jax_cache_and_tiers():
    def jwrite(cache, slot, rows):
        cache.write_slots(np.asarray([slot]), rows, rows * 2)

    def twrite(cache, slot, rows):
        cache.write_slots([slot], rows, rows * 2)

    runs = []
    for mod, write, kw in ((jsc, jwrite, {}), (tsc, twrite,
                                               {"device": "cpu"})):
        cache = mod.StateCache(L, 4, H, **kw)
        tiers = mod.SessionTiers(cache, host_entries=2)
        evicted = []
        cache.evict_listeners.append(lambda sid, slot: evicted.append(
            (sid, slot)))
        runs.append((_script(cache, tiers, write, evicted), cache))
    (jout, jcache), (tout, tcache) = runs
    assert tout[:-1] == jout[:-1]
    jst, tst = jout[-1], tout[-1]
    assert {k: jst[k] for k in ("slots", "live_sessions", "pinned", "free",
                                "evictions")} == {
        k: tst[k] for k in ("slots", "live_sessions", "pinned", "free",
                            "evictions")}
    # the filled session's rows (and every other slot) hold the same state
    np.testing.assert_array_equal(np.asarray(jcache.h), tcache.h.numpy())
    np.testing.assert_array_equal(np.asarray(jcache.c), tcache.c.numpy())


def test_busy_session_is_refused(models):
    b = Batcher(_engine(models, num_slots=4), max_active=2, queue_size=8)
    a = _run(b, Request(PROMPT, 2, keep_session=True))
    first = Request([a.tokens[-1]], 3, session_id=a.session_id)
    second = Request([a.tokens[-1]], 3, session_id=a.session_id)
    b.submit(first)
    b.submit(second)
    b.drain()
    assert first.error is None
    assert second.error is not None and "is busy" in second.error


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_kept_session_and_stats_sections(models, tmp_path):
    ref = models[2]
    engine = _engine(models, num_slots=4, prefix_cache=True,
                     session_dir=str(tmp_path))
    server = ServeServer(engine, max_active=2)
    httpd = make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with server:
            st, a = _post(port, {"prompt": PROMPT.tolist(),
                                 "max_new_tokens": 5, "greedy": True,
                                 "keep_session": True})
            assert st == 200 and a["session_id"]
            st, b = _post(port, {"prompt": [a["tokens"][-1]],
                                 "max_new_tokens": N_TOTAL - 5,
                                 "greedy": True, "keep_session": True,
                                 "session_id": a["session_id"]})
            assert st == 200 and a["tokens"] + b["tokens"] == ref
            st, err = _post(port, {"prompt": [1], "max_new_tokens": 2,
                                   "session_id": "never-made"})
            assert st == 500 and err["code"] == "internal"
            assert "unknown session 'never-made'" in err["error"]
            st, err = _post(port, {"prompt": [1], "max_new_tokens": 2,
                                   "session_id": "prefix/1"})
            assert st == 400 and "reserved" in err["error"]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/v1/stats")
            stats = json.loads(conn.getresponse().read())
            conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(30)
    eng = stats["engine"]
    assert eng["prefix_cache"]["mode"] == "exact"
    assert eng["tiers"]["disk_dir"] == str(tmp_path)
    assert stats["batcher"]["prefix_resumed"] == 0
    # stop() flushed the kept session's checkpoint to disk
    assert os.path.exists(session_file_path(str(tmp_path), a["session_id"]))


SESSION_FLAGS = ("prefix_cache", "prefix_stride", "prefix_entries",
                 "tiered_cache", "host_tier_entries", "session_dir",
                 "prefill_chunk")


def test_serve_parsers_agree_on_the_session_flags():
    jp, tp = jcli.build_serve_parser(), tcli.build_serve_parser()

    def flag(p, dest):
        (a,) = [a for a in p._actions if a.dest == dest]
        return a.option_strings, a.default, a.choices, a.type

    for dest in SESSION_FLAGS:
        assert flag(tp, dest) == flag(jp, dest), dest
    targs = tp.parse_args(["--selftest", "--device", "cpu"])
    assert (targs.prefix_cache, targs.tiered_cache) == ("on", "on")
    bad = ["--prefill-chunk", "6", "--prefix-stride", "4"]
    msgs = []
    for build, args in (
            (jcli._build_serve_stack, jp.parse_args(bad)),
            (tcli._build_serve_stack,
             tp.parse_args(["--selftest", "--device", "cpu", *bad]))):
        with pytest.raises(SystemExit) as e:
            build(args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "multiple or divisor" in msgs[0]
