"""Sampling as JAX's ``cli serve`` samples by default, on the CPU against
the JAX package.

- ``sample_logits`` and ``generate`` with temperature, top-k, top-p and
  both, fed the Gumbel draws ``jax.random.gumbel`` makes from the keys JAX
  splits (``jax.random.categorical`` is argmax(logits + those draws)):
  the same tokens as JAX's;
- the engine's scan window against the port's ``generate`` on the same
  noise, and against the fused window (its plain version here) for
  temperature sampling;
- ``_window_fn_for``'s routing and the ``decode_window_scan_fallbacks``
  count for each sampling kind and each ``decode_kernel``; a model the
  window plan refuses is no fallback;
- ``/v1/generate`` with ``top_k`` / ``top_p`` answered 200, each token in
  the top-k set or nucleus of its own prefix;
- ``serve --loadgen`` samples at temperature 1.0 unless ``--greedy``, as
  JAX's command does; ``--decode-kernel pallas,scan`` (``kernel_sweep``)
  is greedy-identical;
- the new serve and train flags have JAX's defaults and choices.
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import cuda_decode
from lstm_tensorspark_torch.serve import (GREEDY, PAD_TOKEN, SamplingParams,
                                          ServeEngine, ServeServer,
                                          make_http_server)
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.models.generate import sample_logits as jsample

torch.set_num_threads(1)

V, H, L = 37, 16, 2
KINDS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.8),
    "top_k_top_p": dict(temperature=1.3, top_k=9, top_p=0.6),
    "top_k_ge_v": dict(top_k=V + 3, top_p=1.0),
}


@pytest.fixture(scope="module")
def models():
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _gumbel(key, shape):
    return torch.from_numpy(np.array(
        jax.random.gumbel(key, shape, jnp.float32)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_logits_equals_jax_on_shared_draws(kind):
    kw = KINDS[kind]
    rng = np.random.RandomState(11)
    for i in range(4):
        logits = (rng.randn(16, 64) * 3).astype(np.float32)
        logits[:, :4] = logits[:, 4:8]  # exact ties, across the cut too
        key = jax.random.PRNGKey(100 + i)
        ref = np.asarray(jsample(key, jnp.asarray(logits), **kw))
        got = tgen.sample_logits(torch.from_numpy(logits),
                                 noise=_gumbel(key, logits.shape), **kw)
        np.testing.assert_array_equal(got.numpy(), ref)


def _jax_generate_draws(key, n, shape):
    """The Gumbel draws of JAX's ``generate``: the first token's key is
    the first split of ``key``, every later one the split of the carried
    key."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_gumbel(sub, shape))
    return torch.stack(out)


@pytest.mark.parametrize("kind", ["temperature", "top_k", "top_p",
                                  "top_k_top_p"])
def test_generate_equals_jax_on_shared_draws(models, kind):
    jcfg, tcfg, jparams, tparams = models
    kw = KINDS[kind]
    prompt = np.random.RandomState(3).randint(0, V, size=(3, 6)).astype(
        np.int32)
    key = jax.random.PRNGKey(7)
    n = 10
    ref = np.asarray(make_generate_fn(jcfg, max_new_tokens=n, **kw)(
        jparams, jnp.asarray(prompt), key))
    got = tgen.generate(tparams, prompt, tcfg, max_new_tokens=n,
                        noise=_jax_generate_draws(key, n, (3, V)),
                        device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


def _engine(tcfg, tparams, **kw):
    kw.setdefault("num_slots", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2, 4))
    return ServeEngine(tparams, tcfg, device="cpu", **kw)


def _feed_noise(eng, noise):
    """Make ``eng`` draw its Gumbel noise from ``noise`` [N, B, V], in
    order: the prefill takes one step's [B, V], a window K steps'."""
    pos = [0]

    def draw(shape):
        k = 1 if len(shape) == 2 else shape[0]
        out = noise[pos[0]:pos[0] + k]
        pos[0] += k
        return out[0] if len(shape) == 2 else out

    eng._noise = draw


def _engine_tokens(eng, prompts, sampling, n_new, window):
    slots = [eng.cache.acquire(f"s{i}")[0] for i in range(len(prompts))]
    first = eng.prefill([(s, True, p) for s, p in zip(slots, prompts)],
                        sampling)
    win = eng.decode_window(slots, first, [n_new - 1] * len(slots),
                            sampling=sampling, window=window)
    rest = eng.fetch_window(win)
    return [[int(f)] + [int(t) for t in r if t != PAD_TOKEN]
            for f, r in zip(first, rest)]


@pytest.mark.parametrize("kind", ["top_k", "top_p", "top_k_top_p"])
def test_scan_window_equals_generate_on_the_same_noise(models, kind):
    _, tcfg, _, tparams = models
    sampling = SamplingParams(**KINDS[kind])
    prompts = np.random.RandomState(4).randint(0, V, size=(2, 5)).astype(
        np.int32)
    n_new, window = 7, 6
    gen = torch.Generator().manual_seed(9)
    noise = tgen.gumbel_noise((n_new, 2, V), generator=gen)
    ref = tgen.generate(tparams, prompts, tcfg, max_new_tokens=n_new,
                        noise=noise, device="cpu", **KINDS[kind])
    for decode_kernel in ("pallas", "scan"):
        eng = _engine(tcfg, tparams, decode_kernel=decode_kernel)
        _feed_noise(eng, noise)
        plain = eng.stats()["reference_windows"]
        got = _engine_tokens(eng, prompts, sampling, n_new, window)
        assert got == ref[:, 5:].tolist()
        st = eng.stats()
        # top-k / top-p never reach the fused window (its plain version)
        assert st["reference_windows"] == plain
        assert st["decode_window_scan_fallbacks"] == (
            1 if decode_kernel == "pallas" else 0)


def test_scan_and_fused_windows_agree_with_eos_and_budgets(models):
    _, tcfg, _, tparams = models
    sampling = SamplingParams(temperature=0.8)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, V, size=t) for t in (3, 5, 8)]
    outs = {}
    for decode_kernel in ("pallas", "scan"):
        eng = _engine(tcfg, tparams, decode_kernel=decode_kernel)
        _feed_noise(eng, tgen.gumbel_noise(
            (12, 4, V), generator=torch.Generator().manual_seed(2)))
        slots = [eng.cache.acquire(f"s{i}")[0] for i in range(3)]
        first = eng.prefill([(s, True, p) for s, p in zip(slots, prompts)],
                            sampling)
        # row 1 ends its budget mid-window; row 2 stops at its first 4
        win = eng.decode_window(slots, first, [8, 3, 8], [-1, -1, 4],
                                sampling, window=8)
        toks, rem, alive = eng.fetch_window_summary(win)
        h, c = eng.cache.read_slots(torch.tensor(slots))
        outs[decode_kernel] = (first.tolist(), toks.tolist(), rem.tolist(),
                               alive.tolist(), h, c)
    p, s = outs["pallas"], outs["scan"]
    assert p[:4] == s[:4]
    torch.testing.assert_close(p[4], s[4], rtol=0, atol=1e-6)
    torch.testing.assert_close(p[5], s[5], rtol=0, atol=1e-6)


@pytest.mark.parametrize("decode_kernel", ["auto", "pallas", "scan"])
@pytest.mark.parametrize("kind", ["greedy", "temperature", "top_k",
                                  "top_p", "top_k_top_p"])
def test_window_fn_for_routes_and_counts(models, decode_kernel, kind):
    _, tcfg, _, tparams = models
    sampling = GREEDY if kind == "greedy" else SamplingParams(**KINDS[kind])
    eng = _engine(tcfg, tparams, decode_kernel=decode_kernel)
    assert eng.decode_kernel == ("scan" if decode_kernel == "scan"
                                 else "pallas")
    fused = kind in ("greedy", "temperature") and decode_kernel != "scan"
    fn = eng._window_fn_for(sampling)
    assert fn == (eng._fused_window if fused else eng._scan_window)
    # a fallback is a "pallas" choice the fused window does not compute
    fell = not fused and decode_kernel != "scan"
    assert eng.stats()["decode_window_scan_fallbacks"] == int(fell)
    plain = eng.stats()["reference_windows"]
    eng.decode_window([eng.cache.scratch_slot] * 3, [1, 2, 3], [2, 2, 2],
                      sampling=sampling, window=2)
    st = eng.stats()
    assert st["decode_window_scan_fallbacks"] == 2 * int(fell)
    assert st["reference_windows"] - plain == int(fused)
    assert st["dispatches"]["decode_window"] == 1


def test_a_model_the_plan_refuses_is_not_a_fallback(capsys):
    """Only top-k / top-p falls back to the scan window. A model the
    window plan refuses is no cause: ``auto`` still resolves to the fused
    window (its plain version here), and the card's launch raises at the
    plan, as ``card_plan`` refuses before it asks the card anything."""
    cfg = tlm.LMConfig(vocab_size=11, hidden_size=4, num_layers=9)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = _engine(cfg, params)  # auto
    assert eng.decode_kernel == "pallas"
    plain = eng.stats()["reference_windows"]
    for _ in range(2):
        eng.decode([eng.cache.scratch_slot], [1])
    st = eng.stats()
    assert st["decode_window_scan_fallbacks"] == 0
    assert st["reference_windows"] == plain + 2
    with pytest.raises(ValueError, match="1..8 layers, got 9"):
        cuda_decode.card_plan(((9, 4, 4),), 11, 1, None,
                              torch.device("cuda", 0))
    # a top-k window falls back, counted, and says so once
    for _ in range(2):
        eng.decode([eng.cache.scratch_slot], [1],
                   sampling=SamplingParams(top_k=3))
    assert eng.stats()["decode_window_scan_fallbacks"] == 2
    assert eng.stats()["reference_windows"] == plain + 2
    out = capsys.readouterr().out
    assert out.count("top-k / top-p sampling is not computed") == 1
    with pytest.raises(ValueError, match="decode_kernel must be one of"):
        _engine(cfg, params, decode_kernel="cuda")


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _allowed(tparams, tcfg, context, kw):
    """The top-k set / nucleus of the next token after ``context``, as
    JAX's truncation computes it (temperature applied first)."""
    logits, _ = tlm.lm_forward(tparams, torch.tensor([context]), tcfg)
    last = logits[:, -1].float()
    t = kw.get("temperature", 1.0)
    if t != 1.0:
        last = last / torch.tensor(t)
    cut = tgen.truncate_logits(last, kw.get("top_k"), kw.get("top_p"))
    return set(torch.nonzero(torch.isfinite(cut[0])).flatten().tolist())


def test_http_serves_top_k_and_top_p(models):
    _, tcfg, _, tparams = models
    server = ServeServer(_engine(tcfg, tparams, rng_seed=4), max_active=4)
    httpd = make_http_server(server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    prompts = np.random.RandomState(12).randint(0, V, size=(4, 6))
    bodies = [{"prompt": p.tolist(), "max_new_tokens": 6, **KINDS[k]}
              for p, k in zip(prompts, ("top_k", "top_p", "top_k_top_p",
                                        "top_k"))]
    try:
        with server:
            before = server.engine.stats()
            got = [_post(httpd.server_address[1], b) for b in bodies]
            st = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
    for (status, body), req in zip(got, bodies):
        assert status == 200, body
        assert len(body["tokens"]) == 6
        kw = {k: req[k] for k in ("temperature", "top_k", "top_p")
              if k in req}
        for i, tok in enumerate(body["tokens"]):
            ctx = req["prompt"] + body["tokens"][:i]
            assert tok in _allowed(tparams, tcfg, ctx, kw)
    # every decode window of these requests fell back to the scan window
    windows = (st["engine"]["dispatches"]["decode_window"]
               - before["dispatches"]["decode_window"])
    assert (st["engine"]["decode_window_scan_fallbacks"]
            - before["decode_window_scan_fallbacks"]) == windows > 0
    assert st["engine"]["reference_windows"] == before["reference_windows"]


SMALL = ["serve", "--loadgen", "--device", "cpu", "--hidden-units", "16",
         "--num-layers", "1", "--vocab-size", "31", "--sessions", "2",
         "--requests-per-session", "2", "--max-new-tokens", "6",
         "--prefill-buckets", "8,16", "--batch-buckets", "1,2,4"]


@pytest.mark.parametrize("flags", [[], ["--greedy"], ["--top-k", "3"],
                                   ["--top-p", "0.5", "--temperature",
                                    "0.8"]])
def test_loadgen_samples_as_jax_by_default(flags, monkeypatch):
    import lstm_tensorspark_torch.serve as tserve

    seen = []

    def sweep(server, **kw):
        seen.append(kw["sampling"])
        return {"levels": {}}

    monkeypatch.setattr(tserve, "concurrency_sweep", sweep)
    assert tcli.main(SMALL + flags) == 0
    jargs = jcli.build_serve_parser().parse_args(["--loadgen"] + flags)
    assert seen == [tcli._serve_sampling(
        tcli.build_serve_parser().parse_args(["--loadgen"] + flags))]
    assert seen[0] == SamplingParams(**{
        k: getattr(jcli._serve_sampling(jargs), k)
        for k in ("temperature", "top_k", "top_p", "greedy")})
    assert seen[0].greedy == ("--greedy" in flags)


def test_loadgen_counts_the_top_k_fallbacks(tmp_path):
    path = tmp_path / "lg.json"
    assert tcli.main(SMALL + ["--compare", "", "--top-k", "3", "--json",
                              str(path)]) == 0
    rep = json.loads(path.read_text())
    eng = rep["engine"]
    assert rep["failed"] == 0 and rep["completed"] == 4
    assert eng["decode_kernel"] == "pallas"
    assert eng["decode_window_scan_fallbacks"] == (
        eng["dispatches"]["decode_window"]) > 0


def test_kernel_sweep_is_greedy_identical(tmp_path, capsys):
    path = tmp_path / "ks.json"
    assert tcli.main(SMALL + ["--decode-kernel", "pallas,scan", "--greedy",
                              "--json", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert rep["parity_ok"] is True
    assert set(rep["kernels"]) == {"pallas", "scan"}
    assert rep["scan_fallbacks"] == {"pallas": 0, "scan": 0}
    assert {k: r["decode_kernel"] for k, r in rep["kernels"].items()} == {
        "pallas": "pallas", "scan": "scan"}
    assert "pallas_vs_scan" in rep
    with pytest.raises(SystemExit, match="--decode-kernel"):
        tcli.main(SMALL + ["--decode-kernel", "pallas,cuda"])


SERVE_FLAGS = ("temperature", "top_k", "top_p", "greedy", "decode_kernel",
               "trace", "autotune", "autotune_interval", "slo_ms",
               "autotune_chunks", "autotune_host_tier_max",
               "autotune_be_floor")
TRAIN_FLAGS = ("generate_tokens", "prompt", "temperature", "top_k", "top_p",
               "greedy", "trace")


def _flag(p, dest):
    (a,) = [a for a in p._actions if a.dest == dest]
    return a.option_strings, a.default, a.choices, a.type, a.nargs


@pytest.mark.parametrize("dest", SERVE_FLAGS)
def test_serve_flags_equal_jax(dest):
    assert (_flag(tcli.build_serve_parser(), dest)
            == _flag(jcli.build_serve_parser(), dest))


@pytest.mark.parametrize("dest", TRAIN_FLAGS)
def test_train_flags_equal_jax(dest):
    assert (_flag(tcli.build_train_parser(), dest)
            == _flag(jcli.build_parser(), dest))
