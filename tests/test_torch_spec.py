"""Speculative greedy serving in the port against the JAX package.

- ``ops/cuda_spec.spec_window_reference`` (the version the CUDA kernel is
  held against on the card) and ``ops/pallas_decode.spec_window_call`` in
  interpret mode get the same bridged target and draft weights, carries
  and latches. Tokens, next, alive and remaining must be identical; the
  four carry arrays agree within 1e-5 (float32 rounding of differently
  ordered sums). Three drafts: random, all-reject (zero weights and one
  spiked head bias on a token the target never emits) and all-accept (the
  target as its own draft). Each batch holds a live row, a row dead at
  entry, a row that hits EOS inside the window and rows whose budget ends
  inside it (remaining 1 and 2).
- ``train/distill.draft_config`` equals JAX's field for field.
- The engine on the CPU: chained spec windows equal the JAX engine's and
  the port's ``generate``; the all-reject draft leaves the target's slot
  state bitwise equal to plain decode; the draft prefill equals JAX's.
- The batcher and the CLI serve the plain greedy sequence while
  dispatching spec windows.
- The kernel's shared-memory plan, and the launch path's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import cuda_decode, cuda_spec
from lstm_tensorspark_torch.ops.lstm_cell import FusedLSTMParams
from lstm_tensorspark_torch.serve import (
    PAD_TOKEN,
    Batcher,
    Request,
    SamplingParams,
    ServeEngine,
)
from lstm_tensorspark_torch.serve.batcher import _Session
from lstm_tensorspark_torch.train.distill import draft_config
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.models.generate import fuse_layers as j_fuse_layers
from lstm_tensorspark_tpu.ops import pallas_decode
from lstm_tensorspark_tpu.serve import ServeEngine as JServeEngine
from lstm_tensorspark_tpu.train.distill import draft_config as j_draft_config

torch.set_num_threads(1)

TOL = 1e-5
MODELS = {  # name -> (V, H, L, tied): the JAX spec tests' target, a tied
    "base": (37, 16, 2, False),  # pair and config 1's layout at L=1, H=32
    "tied": (37, 16, 2, True),
    "wide": (50, 32, 1, False),
}


def _tcfg(jcfg):
    return tlm.LMConfig(vocab_size=jcfg.vocab_size,
                        hidden_size=jcfg.hidden_size,
                        num_layers=jcfg.num_layers,
                        tie_embeddings=jcfg.tie_embeddings)


def _bridge(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _weights(tparams, tcfg):
    return cuda_decode.decode_weights(
        tparams, tgen.fuse_layers(tparams, tcfg), tcfg.tie_embeddings)


def _wrong_draft(jdcfg, avoid):
    """Zero weights and one spiked head bias on a token not in ``avoid``:
    every proposal is that token, so every one is rejected."""
    wrong = next(t for t in range(jdcfg.vocab_size) if t not in set(avoid))
    zeros = jax.tree.map(np.zeros_like,
                         jax.tree.map(np.asarray,
                                      init_lm(jax.random.PRNGKey(0), jdcfg)))
    zeros["head"]["bias"] = zeros["head"]["bias"].copy()
    zeros["head"]["bias"][wrong] = 10.0
    return zeros, wrong


@pytest.fixture(scope="module")
def targets():
    out = {}
    for name, (V, H, L, tied) in MODELS.items():
        jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        tie_embeddings=tied)
        jparams = jax.tree.map(
            np.asarray, init_lm(jax.random.PRNGKey(11 + L + H), jcfg))
        out[name] = (jcfg, jparams)
    return out


def _draft(kind, jcfg, jparams, avoid=()):
    """(JAX draft config, JAX draft params) of one of the three kinds."""
    if kind == "accept":
        return jcfg, jparams
    jdcfg = j_draft_config(jcfg)
    if kind == "random":
        return jdcfg, jax.tree.map(
            np.asarray, init_lm(jax.random.PRNGKey(5), jdcfg))
    return jdcfg, _wrong_draft(jdcfg, avoid)[0]


def _port_window(tw, dw, arrays, k):
    return cuda_spec.spec_window_reference(
        tw, dw, *(torch.from_numpy(a) for a in arrays), k_draft=k)


# (target, draft, k_draft): every draft at every k on the base pair, every
# draft on the tied pair, and the L=1 pair
CASES = ([("base", d, k) for d in ("random", "reject", "accept")
          for k in (1, 2, 4)]
         + [("tied", d, 2) for d in ("random", "reject", "accept")]
         + [("wide", "random", 4), ("wide", "accept", 4)])


@pytest.mark.parametrize("model,draft,k", CASES)
def test_reference_matches_jax_kernel(targets, model, draft, k):
    jcfg, jparams = targets[model]
    tcfg = _tcfg(jcfg)
    tw = _weights(_bridge(jparams), tcfg)
    V, W, B = jcfg.vocab_size, k + 1, 6
    rng = np.random.RandomState(100 * k + len(draft) + jcfg.hidden_size)
    L, H = jcfg.num_layers, jcfg.hidden_size
    h = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    c = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    tok = rng.randint(0, V, size=B).astype(np.int32)
    alive = np.ones(B, np.int32)
    rem = np.full(B, W + 3, np.int32)
    eos = np.full(B, -1, np.int32)
    # row 1 dead at entry; rows 3 and 4 end their budget inside the window
    alive[1], rem[1], tok[1] = 0, 0, 5
    rem[3], rem[4] = 1, 2
    # the target's own greedy tokens over the window (an all-accept probe)
    probe = _port_window(tw, tw, (h, c, h, c, tok, alive, rem, eos), k)[4]
    probe = probe.numpy()
    jdcfg, jdparams = _draft(draft, jcfg, jparams,
                             avoid=probe[probe >= 0].tolist())
    dtcfg = _tcfg(jdcfg)
    dw = _weights(_bridge(jdparams), dtcfg)
    Ld, Hd = jdcfg.num_layers, jdcfg.hidden_size
    dh = (rng.randn(Ld, B, Hd) * 0.5).astype(np.float32)
    dc = (rng.randn(Ld, B, Hd) * 0.5).astype(np.float32)
    if draft == "accept":  # the draft's carries are the target's
        dh, dc = h.copy(), c.copy()
    # row 2's EOS id: a token this window really emits for it (its last)
    first = _port_window(tw, dw, (h, c, dh, dc, tok, alive, rem, eos), k)[4]
    emitted = [int(t) for t in first[:, 2] if t != PAD_TOKEN]
    eos[2] = emitted[-1]
    arrays = (h, c, dh, dc, tok, alive, rem, eos)

    got = _port_window(tw, dw, arrays, k)
    ref = pallas_decode.spec_window_call(
        jparams, j_fuse_layers(jparams, jcfg), jcfg, jdparams,
        j_fuse_layers(jdparams, jdcfg), jdcfg, *map(jnp.asarray, arrays[:4]),
        jnp.asarray(tok), jnp.asarray(alive.astype(bool)), jnp.asarray(rem),
        jnp.asarray(eos), k_draft=k, interpret=True)
    for name, a, b in zip(("toks", "next", "alive", "rem"), got[4:], ref[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name, a, b in zip(("h", "c", "dh", "dc"), got[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=name)

    toks = got[4].numpy()
    n_emit = (toks != PAD_TOKEN).sum(axis=0)
    # the edge rows did what they are there for
    assert n_emit[1] == 0 and got[5][1] == 0 and got[6][1] == 0
    for a, b in zip(got[:4], (h, c, dh, dc)):  # dead row: bitwise frozen
        np.testing.assert_array_equal(a.numpy()[:, 1], b[:, 1])
    assert toks[n_emit[2] - 1, 2] == eos[2] and got[6][2] == 0
    assert n_emit[3] == 1 and got[7][3] == 0 and got[6][3] == 0
    assert n_emit[4] <= 2 and got[6][4] == (n_emit[4] == 1)
    if draft == "reject":
        assert (n_emit[[0, 2, 3, 4, 5]] == 1).all()
    if draft == "accept":
        assert n_emit[0] == W and n_emit[5] == W


def test_dispatch_runs_the_plain_version_for_cpu_tensors(targets):
    jcfg, jparams = targets["wide"]
    tcfg = _tcfg(jcfg)
    tw = _weights(_bridge(jparams), tcfg)
    z, dz = torch.zeros(1, 2, 32), torch.zeros(1, 2, 32)
    row = torch.zeros(2, dtype=torch.int32)
    args = (tw, tw, z, z.clone(), dz, dz.clone(), row,
            torch.ones(2, dtype=torch.bool), torch.full((2,), 3), row - 1)
    before = (cuda_spec.counts.kernel, cuda_spec.counts.reference)
    out = cuda_spec.spec_window(*args, k_draft=2)
    ref = cuda_spec.spec_window_reference(*args, k_draft=2)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_spec.counts.kernel == before[0]
    assert cuda_spec.counts.reference == before[1] + 1
    with pytest.raises(ValueError, match="k_draft"):
        cuda_spec.spec_window(*args, k_draft=0)


@pytest.mark.parametrize("V,H,L,tied,div,layers", [
    (50, 128, 1, False, 4, 1),   # config 1: H=32
    (33278, 650, 2, False, 4, 1),  # config 3's width: H=162
    (37, 16, 2, False, 4, 1),    # H < 32: the floor of 8
    (37, 20, 3, True, 4, 1),     # tied; the floor again
    (89, 64, 2, False, 2, 2),    # another divisor and depth
])
def test_draft_config_matches_jax(V, H, L, tied, div, layers):
    jd = j_draft_config(LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                                 tie_embeddings=tied),
                        hidden_div=div, num_layers=layers)
    td = draft_config(tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                                   tie_embeddings=tied),
                      hidden_div=div, num_layers=layers)
    for f in dataclasses.fields(td):
        assert getattr(td, f.name) == getattr(jd, f.name), f.name
    with pytest.raises(ValueError):
        draft_config(tlm.LMConfig(vocab_size=V), hidden_div=0)


# ---- the engine ---------------------------------------------------------


def _engines(targets, draft="random", avoid=(), name="base"):
    """(port engine, JAX engine), both with the same bridged target and
    draft attached."""
    jcfg, jparams = targets[name]
    jdcfg, jdparams = _draft(draft, jcfg, jparams, avoid)
    kw = dict(num_slots=8, prefill_buckets=(4, 8), batch_buckets=(1, 2, 4))
    eng = ServeEngine(_bridge(jparams), _tcfg(jcfg), device="cpu", **kw)
    eng.attach_draft(_bridge(jdparams), _tcfg(jdcfg))
    jeng = JServeEngine(jparams, jcfg, **kw)
    jeng.attach_draft(jdparams, jdcfg)
    return eng, jeng


def _generate(targets, prompt, n_new, name="base"):
    jcfg, jparams = targets[name]
    out = tgen.generate(_bridge(jparams), prompt[None, :], _tcfg(jcfg),
                        max_new_tokens=n_new, greedy=True, device="cpu")
    return out[0, prompt.size:].tolist()


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 37, size=n).astype(np.int32)


def _spec_stream(engine, slot, first, n_new, k):
    """Chain fresh spec windows until ``n_new`` tokens; (tokens, emitted
    per window)."""
    out, per_window = [int(first)], []
    while len(out) < n_new:
        win = engine.spec_window([slot], [out[-1]], [n_new - len(out)],
                                 k_draft=k)
        row = engine.fetch_window(win)[0]
        emitted = [int(t) for t in row if int(t) != PAD_TOKEN]
        per_window.append(len(emitted))
        out.extend(emitted)
    return out, per_window


def test_engine_spec_chain_matches_jax_engine_and_generate(targets):
    eng, jeng = _engines(targets)
    p, n_new = _prompt(5, 1), 14
    streams, states = {}, {}
    for name, e in (("port", eng), ("jax", jeng)):
        slot, _ = e.cache.acquire("s")
        first = e.prefill([(slot, True, p)])[0]
        e.draft_prefill([(slot, True, p)])
        streams[name] = _spec_stream(e, slot, first, n_new, k=2)
        states[name] = slot
    assert streams["port"] == streams["jax"]
    assert streams["port"][0] == _generate(targets, p, n_new)
    # the committed states of both models agree after the chain
    s, js = states["port"], states["jax"]
    jh, jc = jeng.cache.read_slots([js])
    h, c = eng.cache.read_slots(torch.tensor([s]))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(eng.draft_cache.h[:, s].numpy(),
                               np.asarray(jeng._draft_h)[:, js], atol=TOL,
                               rtol=0)
    stats = eng.stats()
    assert stats["has_draft"] and stats["dispatches"]["spec_window"] > 0
    assert stats["spec_kernel_launches"] == cuda_spec.counts.kernel


def test_engine_spec_window_next_moves_k_mid_chain(targets):
    eng, _ = _engines(targets)
    p, n_new = _prompt(6, 2), 20
    slot, _ = eng.cache.acquire("s")
    out = [int(eng.prefill([(slot, True, p)])[0])]
    eng.draft_prefill([(slot, True, p)])
    win = eng.spec_window([slot], [out[0]], [n_new - 1], k_draft=2)
    ks = iter([4, 4, 2, 4] + [4] * n_new)
    while True:
        nxt = eng.spec_window_next(win, k_draft=next(ks))  # before the fetch
        toks, _, alive = eng.fetch_window_summary(win)
        out.extend(int(t) for t in toks[0] if t != PAD_TOKEN)
        if not alive[0]:
            break
        win = nxt
    assert win.spec and nxt.spec
    assert out == _generate(targets, p, n_new)
    with pytest.raises(ValueError, match="spec"):
        eng.decode_window_next(win)


def test_engine_all_reject_state_bitwise_equals_plain_decode(targets):
    p, n_new = _prompt(4, 9), 10
    ref = _generate(targets, p, n_new)
    spec, _ = _engines(targets, draft="reject", avoid=ref)
    jcfg, jparams = targets["base"]
    plain = ServeEngine(_bridge(jparams), _tcfg(jcfg), device="cpu",
                        num_slots=8, prefill_buckets=(4, 8),
                        batch_buckets=(1, 2, 4))
    sslot, _ = spec.cache.acquire("s")
    pslot, _ = plain.cache.acquire("s")
    first = spec.prefill([(sslot, True, p)])[0]
    spec.draft_prefill([(sslot, True, p)])
    got, per_window = _spec_stream(spec, sslot, first, n_new, k=2)
    assert got == ref and per_window == [1] * (n_new - 1)
    out = [int(plain.prefill([(pslot, True, p)])[0])]
    while len(out) < n_new:
        win = plain.decode_window([pslot], [out[-1]], [n_new - len(out)],
                                  window=1)
        out.extend(int(t) for t in plain.fetch_window(win)[0])
    assert out == ref
    sh, sc = spec.cache.read_slots(torch.tensor([sslot]))
    ph, pc = plain.cache.read_slots(torch.tensor([pslot]))
    torch.testing.assert_close(sh, ph, rtol=0, atol=0)
    torch.testing.assert_close(sc, pc, rtol=0, atol=0)


def test_engine_all_accept_emits_whole_windows(targets):
    eng, _ = _engines(targets, draft="accept")
    p, n_new, k = _prompt(3, 4), 15, 3
    slot, _ = eng.cache.acquire("s")
    first = eng.prefill([(slot, True, p)])[0]
    eng.draft_prefill([(slot, True, p)])
    got, per_window = _spec_stream(eng, slot, first, n_new, k=k)
    assert got == _generate(targets, p, n_new)
    # 14 tokens after prefill: W=4 per window until the budget ends
    assert per_window == [4, 4, 4, 2]


def test_engine_draft_prefill_matches_jax(targets):
    eng, jeng = _engines(targets)
    items = [(0, True, _prompt(3, 5)), (1, True, _prompt(7, 6))]
    eng.draft_prefill(items)
    jeng.draft_prefill(items)
    for a, b in ((eng.draft_cache.h, jeng._draft_h),
                 (eng.draft_cache.c, jeng._draft_c)):
        np.testing.assert_allclose(a[:, :2].numpy(), np.asarray(b)[:, :2],
                                   atol=TOL, rtol=0)
    assert float(eng.draft_cache.h[:, :2].abs().max()) > 0
    # a fresh row starts from zero: the same prompt again gives the same
    eng.draft_prefill([(0, True, _prompt(3, 5))])
    np.testing.assert_allclose(eng.draft_cache.h[:, 0].numpy(),
                               np.asarray(jeng._draft_h)[:, 0], atol=TOL,
                               rtol=0)


def test_engine_refuses_vocab_mismatch_and_missing_draft(targets):
    jcfg, jparams = targets["base"]
    eng = ServeEngine(_bridge(jparams), _tcfg(jcfg), device="cpu",
                      num_slots=4, batch_buckets=(1, 2))
    with pytest.raises(ValueError, match="vocab"):
        other = tlm.LMConfig(vocab_size=40, hidden_size=8)
        eng.attach_draft(tlm.init_lm(torch.Generator().manual_seed(0), other),
                         other)
    assert not eng.has_draft
    with pytest.raises(ValueError, match="draft"):
        eng.spec_window([0], [1], [4], k_draft=2)
    with pytest.raises(ValueError, match="draft"):
        eng.draft_prefill([(0, True, _prompt(3, 0))])
    with pytest.raises(ValueError, match="draft"):
        Batcher(eng, max_active=2, queue_size=4, speculative=True)
    dcfg = dataclasses.replace(draft_config(_tcfg(jcfg)), remat_chunk=4)
    eng.attach_draft(tlm.init_lm(torch.Generator().manual_seed(1), dcfg), dcfg)
    assert eng.draft["cfg"].remat_chunk is None
    assert tuple(eng.draft_cache.h.shape) == (1, 5, 8)


# ---- the batcher --------------------------------------------------------


def _batcher(targets, draft="random", **kw):
    eng, _ = _engines(targets, draft=draft)
    kw.setdefault("spec_ladder", (2, 4))
    return Batcher(eng, max_active=4, queue_size=16, speculative=True, **kw)


def test_batcher_speculative_serves_greedy_sequence(targets):
    b = _batcher(targets)
    prompts = [_prompt(3 + i, 7 + i) for i in range(4)]
    reqs = [Request(p, 14) for p in prompts]
    for r in reqs:
        b.submit(r)
    b.drain()
    for p, r in zip(prompts, reqs):
        assert r.error is None
        assert r.tokens == _generate(targets, p, 14)
    stats = b.stats()
    assert sum(stats["spec_windows_dispatched"].values()) > 0
    assert stats["draft_prefills_dispatched"] == 1
    assert stats["draft_prefill_failures"] == 0


def test_batcher_all_accept_counts_accepted_tokens(targets):
    b = _batcher(targets, draft="accept")
    eng = b.engine
    windows = []
    for name in ("spec_window", "spec_window_next"):
        fn = getattr(eng, name)

        def record(*a, _fn=fn, **kw):
            win = _fn(*a, **kw)
            windows.append(win)
            return win
        setattr(eng, name, record)
    prompts = [_prompt(4, 20 + i) for i in range(3)]
    reqs = [Request(p, 17) for p in prompts]
    for r in reqs:
        b.submit(r)
    b.drain()
    for p, r in zip(prompts, reqs):
        assert r.tokens == _generate(targets, p, 17)
    reckoned, rows = 0, 0
    for win in windows:
        for row in eng.fetch_window(win):
            emitted = int((row != PAD_TOKEN).sum())
            reckoned += max(emitted - 1, 0)
            rows += emitted > 0
    assert windows and b.spec_accepted_tokens == reckoned
    assert b.spec_rows_verified == rows
    # the target as its own draft: every live row accepts all K proposals
    assert reckoned == sum(
        (w.window - 1) * int((eng.fetch_window(w)[:, 0] != PAD_TOKEN).sum())
        for w in windows)


def test_set_spec_k_validates_rungs_and_mode(targets):
    b = _batcher(targets)
    assert b.spec_ladder == (0, 2, 4) and b.spec_k == 4
    b.set_spec_k(0)
    assert b.spec_k == 0
    with pytest.raises(ValueError):
        b.set_spec_k(3)
    with pytest.raises(ValueError):
        Batcher(b.engine, max_active=2, queue_size=4, speculative=True,
                spec_ladder=(2, 4), spec_k=3)
    with pytest.raises(ValueError):
        Batcher(b.engine, max_active=2, queue_size=4, speculative=True,
                spec_ladder=(-1,))
    plain = Batcher(b.engine, max_active=2, queue_size=4)
    assert plain.spec_k == 0
    with pytest.raises(ValueError):
        plain.set_spec_k(2)


def test_spec_k_for_greedy_only_and_two_tokens_left(targets):
    b = _batcher(targets)
    greedy = [_Session(Request([1, 2], 8), "a", 0)]
    temp = [_Session(Request([1, 2], 8,
                             sampling=SamplingParams(temperature=0.7)),
                     "b", 1)]
    assert b._spec_k_for(greedy, 8) == 4
    assert b._spec_k_for(greedy, 4) == 2  # W = 5 would overshoot
    assert b._spec_k_for(greedy, 2) == 0  # rung 2 needs 3 tokens
    assert b._spec_k_for(greedy, 1) == 0
    assert b._spec_k_for(temp, 8) == 0
    b.set_spec_k(2)
    assert b._spec_k_for(greedy, 8) == 2
    b.set_spec_k(0)
    assert b._spec_k_for(greedy, 8) == 0


def test_batcher_mixed_greedy_and_temperature_burst(targets):
    b = _batcher(targets)
    temp = SamplingParams(temperature=0.7)
    prompts = [_prompt(3 + i, 30 + i) for i in range(4)]
    reqs = [Request(p, 12, sampling=temp if i % 2 else SamplingParams(
        greedy=True)) for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.drain()
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        assert r.error is None and len(r.tokens) == 12
        assert all(0 <= t < 37 for t in r.tokens)
        if i % 2 == 0:
            assert r.tokens == _generate(targets, p, 12)
    assert b.stats()["failed"] == 0


def test_failed_draft_prefill_is_counted_not_fatal(targets, monkeypatch):
    b = _batcher(targets)

    def boom(items):
        raise RuntimeError("injected draft prefill fault")
    monkeypatch.setattr(b.engine, "draft_prefill", boom)
    prompts = [_prompt(4 + i, 40 + i) for i in range(3)]
    reqs = [Request(p, 11) for p in prompts]
    for r in reqs:
        b.submit(r)
    b.drain()
    for p, r in zip(prompts, reqs):
        assert r.error is None and r.tokens == _generate(targets, p, 11)
    stats = b.stats()
    assert stats["draft_prefill_failures"] == 1
    assert stats["draft_prefills_dispatched"] == 0
    assert sum(stats["spec_windows_dispatched"].values()) > 0


# ---- the CLI and the plan -------------------------------------------------


def test_cli_serve_selftest_speculative(capsys):
    rc = tcli.main(["serve", "--selftest", "--speculative", "--device", "cpu",
                    "--sessions", "3", "--max-new-tokens", "10",
                    "--vocab-size", "37", "--hidden-units", "32",
                    "--num-layers", "1", "--prefill-buckets", "8,16",
                    "--batch-buckets", "1,2,4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert '"mismatches": 0' in out and "serve selftest: PASS" in out
    assert '"spec_windows_dispatched": {}' not in out
    with pytest.raises(SystemExit):
        tcli._parse_spec_ladder("0")


def test_spec_shared_memory_plan_and_refusals():
    # x + target h, c + 4 draft carry arrays + z, f32; the proposals int32
    cfg1 = cuda_spec.spec_smem_bytes(1, 128, 128, 1, 32, 32, 4)
    assert cfg1 == 4 * (128 + 2 * 128 + 4 * 32 + 4 * 128) + 16
    cfg3 = cuda_spec.spec_smem_bytes(2, 650, 650, 1, 162, 162, 4)
    assert cfg3 == 4 * (650 + 2 * 2 * 650 + 4 * 162 + 4 * 650) + 16
    assert cfg1 < cfg3 < 48 * 1024 < cuda_spec.MAX_SMEM_BYTES
    assert cuda_spec.check_plan(2, 650, 650, 1, 162, 162, 4) == cfg3
    with pytest.raises(ValueError, match="shared memory"):
        cuda_spec.check_plan(8, 3000, 3000, 1, 750, 750, 4)
    with pytest.raises(ValueError, match="layers"):
        cuda_spec.check_plan(9, 16, 16, 1, 8, 8, 2)
    # the launch path refuses an oversized shape before it touches a card
    layer = FusedLSTMParams(torch.zeros(1), torch.zeros(1), torch.zeros(1))
    tw = cuda_decode.DecodeWeights(torch.zeros(37, 3000), (layer,) * 8,
                                   torch.zeros(1), torch.zeros(1))
    dw = cuda_decode.DecodeWeights(torch.zeros(37, 8), (layer,),
                                   torch.zeros(1), torch.zeros(1))
    row = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_spec._launch(tw, dw, torch.zeros(8, 1, 3000),
                          torch.zeros(8, 1, 3000), torch.zeros(1, 1, 8),
                          torch.zeros(1, 1, 8), row, row, row, row, 4)
    assert cuda_spec.PAD_TOKEN == pallas_decode.PAD_TOKEN
