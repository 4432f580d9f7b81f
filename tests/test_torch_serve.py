"""The port's serving stack on the CPU against the JAX package.

Weights come from the JAX package (``init_lm``) and are carried across with
``convert.params_from_numpy``. The port's engine (bucketed prefill + the
decode-window chain), its ``ServeServer`` behind ``InprocessClient`` and
over HTTP, with 4 concurrent sessions of different prompt lengths, must
produce greedy tokens identical to JAX ``make_generate_fn``. Also:
refusals (top-k / top-p → 400, full queue → 429) and no silent CPU
fallback when no card is present.
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import (
    PAD_TOKEN,
    InprocessClient,
    QueueFullError,
    Request,
    SamplingParams,
    ServeEngine,
    ServeServer,
    make_http_server,
)
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn

torch.set_num_threads(1)

V, H, L = 41, 24, 2
N_NEW = 12
PROMPT_LENS = (3, 7, 11, 16)


@pytest.fixture(scope="module")
def models():
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(21), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, V, size=t).astype(np.int32) for t in PROMPT_LENS]
    refs = []
    for p in prompts:
        gen = make_generate_fn(jcfg, max_new_tokens=N_NEW, greedy=True)
        out = gen(jparams, jnp.asarray(p[None, :]), jax.random.PRNGKey(0))
        refs.append(np.asarray(out)[0, p.size:].tolist())
    return tcfg, tparams, prompts, refs


def _engine(tcfg, tparams, **kw):
    kw.setdefault("num_slots", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2, 4))
    return ServeEngine(tparams, tcfg, device="cpu", **kw)


def test_engine_prefill_and_window_chain_match_jax(models):
    tcfg, tparams, prompts, refs = models
    eng = _engine(tcfg, tparams)
    slots = [eng.cache.acquire(f"s{i}")[0] for i in range(len(prompts))]
    first = eng.prefill([(s, True, p) for s, p in zip(slots, prompts)])
    got = [[int(t)] for t in first]
    # a first window from host values, then pipelined successors from its
    # device handles (dispatched before the previous window is fetched)
    win = eng.decode_window(slots, first, [N_NEW - 1] * len(slots), window=4)
    while True:
        nxt = eng.decode_window_next(win, window=4)
        toks, rem, alive = eng.fetch_window_summary(win)
        for row, out in zip(toks, got):
            out.extend(int(t) for t in row if t != PAD_TOKEN)
        if not alive.any():
            break
        win = nxt
    assert got == refs
    stats = eng.stats()
    assert stats["decode_kernel"] == "reference"
    assert stats["dispatches"]["decode_window"] >= 3


def test_engine_k1_decode_matches_jax(models):
    tcfg, tparams, prompts, refs = models
    eng = _engine(tcfg, tparams)
    slot, _ = eng.cache.acquire("s")
    tok = int(eng.prefill([(slot, True, prompts[1])])[0])
    got = [tok]
    for _ in range(N_NEW - 1):
        tok = int(eng.decode([slot], [tok])[0])
        got.append(tok)
    assert got == refs[1]


def test_server_inprocess_concurrent_sessions_match_jax(models):
    tcfg, tparams, prompts, refs = models
    server = ServeServer(_engine(tcfg, tparams), max_active=4)
    server.warmup(prompt_lens=PROMPT_LENS)
    client = InprocessClient(server)
    got = [None] * len(prompts)
    errors = []

    def run(i):
        try:
            got[i] = client.generate(prompts[i], max_new_tokens=N_NEW)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(repr(e))

    with server:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    assert not errors
    assert got == refs
    stats = server.stats()["batcher"]
    assert stats["completed"] == len(prompts) and stats["failed"] == 0
    assert stats["tokens_generated"] == len(prompts) * N_NEW


def _post(port, body, path="/v1/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture
def http_server(models):
    tcfg, tparams, _, _ = models
    server = ServeServer(_engine(tcfg, tparams), max_active=4, queue_size=2)
    httpd = make_http_server(server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
        server.stop()


def test_http_concurrent_sessions_match_jax_and_report(models, http_server):
    _, _, prompts, refs = models
    server, port = http_server
    server.start()
    got = [None] * len(prompts)

    def run(i):
        got[i] = _post(port, {"prompt": prompts[i].tolist(),
                              "max_new_tokens": N_NEW, "greedy": True})

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    # queue_size=2 may shed a burst of 4 with 429; retry those in turn
    for i, r in enumerate(got):
        if r[0] == 429:
            got[i] = _post(port, {"prompt": prompts[i].tolist(),
                                  "max_new_tokens": N_NEW, "greedy": True})
    assert [r[0] for r in got] == [200] * len(prompts)
    assert [r[1]["tokens"] for r in got] == refs
    status, health = _get(port, "/healthz")
    assert status == 200 and health["status"] == "ok"
    status, stats = _get(port, "/v1/stats")
    assert status == 200 and stats["engine"]["decode_kernel"] == "reference"
    # eos_id ends the reply at the first emission of that id
    eos = refs[0][2]
    status, body = _post(port, {"prompt": prompts[0].tolist(),
                                "max_new_tokens": N_NEW, "greedy": True,
                                "eos_id": eos})
    assert status == 200
    assert body["tokens"] == refs[0][:refs[0].index(eos) + 1]


@pytest.mark.parametrize("extra", [{"top_k": 5}, {"top_p": 0.9},
                                   {"top_k": 3, "temperature": 0.7}])
def test_http_refuses_top_k_and_top_p_with_400(models, http_server, extra):
    _, _, prompts, _ = models
    server, port = http_server
    server.start()
    status, body = _post(port, {"prompt": prompts[0].tolist(),
                                "max_new_tokens": 4, **extra})
    assert status == 400 and "top-k / top-p" in body["error"]


def test_http_bad_body_is_400_and_full_queue_is_429(models, http_server):
    _, _, prompts, _ = models
    server, port = http_server
    assert _post(port, {"max_new_tokens": 4})[0] == 400   # no prompt
    assert _post(port, {"prompt": [], "max_new_tokens": 4})[0] == 400
    assert _post(port, {"prompt": [1], "max_new_tokens": "x"})[0] == 400
    # the scheduler is not started: fill the bounded queue directly
    for _ in range(server.batcher.queue_size):
        server.batcher.submit(Request(prompts[0], 4))
    with pytest.raises(QueueFullError):
        server.batcher.submit(Request(prompts[0], 4))
    status, body = _post(port, {"prompt": prompts[0].tolist(),
                                "max_new_tokens": 4, "greedy": True})
    assert status == 429 and body["code"] == "queue_full"
    assert server.batcher.stats()["rejected"] == 2


def test_temperature_requests_are_served(models):
    tcfg, tparams, prompts, _ = models
    server = ServeServer(_engine(tcfg, tparams, rng_seed=3), max_active=4)
    with server:
        toks = InprocessClient(server).generate(
            prompts[2], max_new_tokens=9,
            sampling=SamplingParams(temperature=0.8))
    assert len(toks) == 9 and all(0 <= t < V for t in toks)


def test_engine_serves_any_number_of_distinct_temperatures(models):
    # temperature is a runtime argument of the decode window: a long-lived
    # server must not start refusing new client temperatures
    tcfg, tparams, prompts, _ = models
    eng = _engine(tcfg, tparams)
    for i in range(40):
        eng.check_sampling(SamplingParams(temperature=0.5 + 0.01 * i))
    first = eng.prefill([(eng.cache.scratch_slot, True, prompts[0])],
                        SamplingParams(temperature=1.37))
    assert 0 <= int(first[0]) < V
    with pytest.raises(ValueError, match="top-k / top-p"):
        eng.check_sampling(SamplingParams(temperature=0.9, top_k=4))


def test_no_silent_cpu_fallback(models, monkeypatch):
    tcfg, tparams, prompts, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tparams, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.generate(tparams, prompts[0][None], tcfg, max_new_tokens=2,
                      greedy=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"embedding": np.zeros((2, 2), np.float32),
                           "layers": [], "head": {}})
    # asking for the CPU is the explicit way to run there
    assert ServeEngine(tparams, tcfg, device="cpu").device.type == "cpu"
