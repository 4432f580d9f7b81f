"""Two repairs of the port held on the CPU: inference drops ``remat_chunk``
as the JAX package does, and the scheduler refuses prompt ids outside the
vocabulary.

- ``generate`` and ``ServeEngine`` with ``LMConfig(remat_chunk=3)``: a
  4-token prompt (``generate``) and a 3-token prompt (prefill bucket 4)
  would be refused by the remat scan; both must give the JAX package's
  tokens, and the prefilled carries must agree to 1e-6.
- ``Batcher.submit`` raises ``ValueError`` for an id outside [0, V) before
  the request is queued (the HTTP front end answers 400): on the card an
  out-of-range gather is a device-side assert that would take the server
  down. The JAX package reads a NaN row there and answers token 0; the
  port's refusal is a difference by design. The next valid request must be
  served token-identical to ``generate``.
"""

import dataclasses
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
from lstm_tensorspark_torch.serve import (InprocessClient, Request,
                                          ServeEngine, ServeServer,
                                          make_http_server)
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.models import generate as jax_generate
from lstm_tensorspark_tpu.serve import ServeEngine as JaxServeEngine

torch.set_num_threads(1)

V, H = 29, 12
N_NEW = 6
CARRY_TOL = 1e-6


@pytest.fixture(scope="module")
def models():
    jcfg = LMConfig(vocab_size=V, hidden_size=H, remat_chunk=3)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, remat_chunk=3)
    jparams = init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, V, size=n).astype(np.int32)


def test_generate_drops_remat_chunk_like_jax(models):
    jcfg, tcfg, jparams, tparams = models
    prompt = _prompt(4, 3)  # 4 is not a multiple of remat_chunk=3
    ref = jax_generate(jparams, jnp.asarray(prompt[None]), jcfg,
                       jax.random.PRNGKey(0), max_new_tokens=N_NEW,
                       greedy=True)
    got = tgen.generate(tparams, prompt[None], tcfg, max_new_tokens=N_NEW,
                        greedy=True, device="cpu")
    assert got.tolist() == np.asarray(ref).tolist()
    assert tcfg.remat_chunk == 3  # the caller's config is left as it was


def test_engine_prefill_drops_remat_chunk_like_jax(models):
    jcfg, tcfg, jparams, tparams = models
    prompt = _prompt(3, 4)  # bucket 4, not a multiple of remat_chunk=3
    jeng = JaxServeEngine(jparams, jcfg, num_slots=4, prefill_buckets=(4, 8),
                          batch_buckets=(1, 2))
    teng = ServeEngine(tparams, tcfg, device="cpu", num_slots=4,
                       prefill_buckets=(4, 8), batch_buckets=(1, 2))
    assert teng.cfg.remat_chunk is None
    jslot, jfresh = jeng.cache.acquire("s")
    tslot, tfresh = teng.cache.acquire("s")
    jtok = jeng.prefill([(jslot, jfresh, prompt)])
    ttok = teng.prefill([(tslot, tfresh, prompt)])
    assert ttok.tolist() == np.asarray(jtok).tolist()
    for name in ("h", "c"):
        ref = np.asarray(getattr(jeng.cache, name))[:, jslot]
        got = getattr(teng.cache, name)[:, tslot].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=CARRY_TOL)


@pytest.fixture
def server(models):
    _, tcfg, _, tparams = models
    eng = ServeEngine(tparams, dataclasses.replace(tcfg, remat_chunk=None),
                      device="cpu", num_slots=4, prefill_buckets=(4, 8),
                      batch_buckets=(1, 2))
    srv = ServeServer(eng, max_active=2)
    with srv:
        yield srv


@pytest.mark.parametrize("bad", [V, -1, 10 * V])
def test_out_of_range_prompt_id_refused_then_served(models, server, bad):
    _, tcfg, _, tparams = models
    client = InprocessClient(server)
    prompt = _prompt(5, 6)
    wrong = prompt.copy()
    wrong[2] = bad
    with pytest.raises(ValueError, match="outside the vocabulary"):
        client.generate(wrong, max_new_tokens=N_NEW)
    got = client.generate(prompt, max_new_tokens=N_NEW)
    ref = tgen.generate(tparams, prompt[None], tcfg, max_new_tokens=N_NEW,
                        greedy=True, device="cpu")[0, prompt.size:].tolist()
    assert got == ref
    stats = server.stats()["batcher"]
    assert stats["submitted"] == 1 and stats["failed"] == 0


def test_submit_refuses_before_queueing(server):
    with pytest.raises(ValueError, match=rf"\[0, {V}\)"):
        server.batcher.submit(Request([1, V + 3, 2], 4))
    assert server.stats()["batcher"]["submitted"] == 0


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_out_of_range_prompt_id_is_a_400_over_http(models, server):
    _, tcfg, _, tparams = models
    httpd = make_http_server(server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        status, body = _post(port, {"prompt": [1, 2, V], "greedy": True,
                                    "max_new_tokens": N_NEW})
        assert status == 400 and body["code"] == "bad_request"
        prompt = _prompt(7, 8)
        status, body = _post(port, {"prompt": prompt.tolist(), "greedy": True,
                                    "max_new_tokens": N_NEW})
        assert status == 200
        ref = tgen.generate(tparams, prompt[None], tcfg, max_new_tokens=N_NEW,
                            greedy=True, device="cpu")
        assert body["tokens"] == ref[0, prompt.size:].tolist()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
