"""The prefix cache and chunked prefill of the port's serve plane, on the CPU
against the JAX package.

One script of lookups, inserts, releases and backing-slot evictions gives
the same hits, misses, evictions, invalidations, spills and promotions on
JAX's ``PrefixCache`` and on the port's; the reserved ``prefix/``
namespace is refused. Greedy tokens with the prefix cache cold, hot, off,
and chunked at 8 and 16 equal JAX's ``make_generate_fn``; a 300-token
prompt at ``prefill_chunk`` 64, beside a decoding session, equals it too,
and without chunking gets JAX's refusal. ``_stop_from`` and the lengths
``warmup`` replays equal JAX's over a grid; an incompatible chunk and
stride are refused as JAX refuses them; ``use_prefix=False`` bypasses the
cache; speculative greedy output with kept sessions and prefix hits
equals plain greedy output.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import Batcher, Request, ServeEngine
from lstm_tensorspark_torch.serve import state_cache as tsc
from lstm_tensorspark_torch.train.distill import draft_config
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.serve import Batcher as JBatcher
from lstm_tensorspark_tpu.serve import Request as JRequest
from lstm_tensorspark_tpu.serve import ServeEngine as JServeEngine
from lstm_tensorspark_tpu.serve import state_cache as jsc

torch.set_num_threads(1)

V, H, L = 41, 24, 2
N_NEW = 6
SHARED, SUFFIX = 24, 8  # three prompts of 32 tokens sharing 24
LONG = 300
BUCKETS = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg and params, port cfg and params, the shared-prefix prompts
    and their JAX tokens, the long prompt and its JAX tokens): two JAX
    generate shapes, (3, 32) and (1, 300)."""
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=L)
    jparams = init_lm(jax.random.PRNGKey(21), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.RandomState(12)
    shared = rng.randint(0, V, size=SHARED)
    prompts = np.stack([np.concatenate([shared, rng.randint(0, V, SUFFIX)])
                        for _ in range(3)]).astype(np.int32)
    long = rng.randint(0, V, size=(1, LONG)).astype(np.int32)
    gen = make_generate_fn(jcfg, max_new_tokens=N_NEW, greedy=True)
    key = jax.random.PRNGKey(0)
    refs = np.asarray(gen(jparams, jnp.asarray(prompts), key))[:, -N_NEW:]
    long_ref = np.asarray(gen(jparams, jnp.asarray(long), key))[0, -N_NEW:]
    return (jcfg, jparams, tcfg, tparams, list(prompts), refs.tolist(),
            long[0], long_ref.tolist())


def _engine(models, **kw):
    tcfg, tparams = models[2], models[3]
    kw.setdefault("num_slots", 16)
    kw.setdefault("prefill_buckets", BUCKETS)
    kw.setdefault("batch_buckets", (1, 2, 4))
    return ServeEngine(tparams, tcfg, device="cpu", **kw)


def _run(b, prompts, n_new, **kw):
    reqs = [Request(p, n_new, **kw) for p in prompts]
    for r in reqs:
        b.submit(r)
    b.drain()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return reqs


def _prefix_script(mod, tiered: bool, **kw):
    """Lookups, inserts, releases and backing-slot evictions on one
    package's StateCache + PrefixCache (+ SessionTiers)."""
    cache = mod.StateCache(1, 4, 3, **kw)
    tiers = mod.SessionTiers(cache, host_entries=4) if tiered else None
    prefix = mod.PrefixCache(cache, stride=2, max_entries=3, tiers=tiers)
    rows = np.arange(5 * 3, dtype=np.float32).reshape(1, 5, 3)
    cache.write_slots(np.arange(5), rows, -rows)
    seed, _ = cache.acquire("seed")
    out = []

    def look(tokens):
        entry, n = prefix.lookup(np.asarray(tokens, np.int32))
        out.append(n)
        return entry

    out.append(prefix.insert(np.array([1, 2], np.int32), seed))
    out.append(prefix.insert(np.array([1, 2, 3, 4], np.int32), seed))
    out.append(prefix.insert(np.array([1, 2], np.int32), seed))  # dedup
    e = look([1, 2, 3, 4, 9])  # the longest entry
    look([1, 2, 3, 4])  # capped at len - 1: the 2-token entry
    look([7, 7, 7])  # miss
    prefix.release(e)
    out.append(prefix.insert(np.array([5, 6], np.int32), seed))
    held = look([5, 6, 0])
    # a fourth entry evicts the oldest zero-ref one
    out.append(prefix.insert(np.array([8, 8], np.int32), seed))
    look([1, 2, 3])
    look([1, 2, 3, 4, 5])
    # session traffic takes the backing slots: invalidations or spills
    for i in range(4):
        cache.acquire(f"sess{i}")
    if tiers is not None:
        assert tiers.flush(timeout=30)
    for i in range(4):
        cache.release(f"sess{i}")
    look([5, 6, 1])  # still ref-held: its slot was never evicted
    prefix.release(held)
    look([8, 8, 1])  # spilled: promoted back (tiered), else a miss
    look([1, 2, 3, 4, 5])
    out.append(prefix.stats())
    out.append(cache.stats()["evictions"])
    return out


@pytest.mark.parametrize("tiered", [False, True])
def test_prefix_script_matches_jax(tiered):
    jout = _prefix_script(jsc, tiered)
    tout = _prefix_script(tsc, tiered, device="cpu")
    assert tout == jout
    st = tout[-2]
    if tiered:
        assert st["spilled"] >= 1 and st["promoted"] >= 1
    else:
        assert st["invalidated"] >= 1
    assert st["hits"] >= 3 and st["misses"] >= 1 and st["evictions"] >= 1


def test_reserved_namespace_is_refused():
    for cls in (Request, JRequest):
        with pytest.raises(ValueError, match="reserved"):
            cls(np.array([1, 2], np.int32), 2, session_id="prefix/7")


@pytest.mark.parametrize("prefix,chunk", [(False, None), (True, None),
                                          (True, 8), (True, 16)])
def test_greedy_tokens_cold_hot_off_chunked_match_jax(models, prefix, chunk):
    prompts, refs = models[4], models[5]
    engine = _engine(models, prefix_cache=prefix)
    b = Batcher(engine, max_active=4, queue_size=8, prefill_chunk=chunk)
    for _ in range(2):  # cold, then hot
        assert [r.tokens for r in _run(b, prompts, N_NEW)] == refs
    st = b.stats()
    if prefix:
        px = engine.prefix.stats()
        assert px["hits"] >= 3 and px["inserts"] >= 1
        assert st["prefix_resumed"] >= 3
        assert st["prefix_tokens_saved"] >= 3 * SHARED
    else:
        assert st["prefix_resumed"] == 0
    if chunk is not None:
        assert st["prefill_chunks_dispatched"] >= 32 // chunk - 1


def test_long_prompt_chunked_beside_decoding_session(models):
    prompts, refs, long, long_ref = models[4], models[5], models[6], \
        models[7]
    b = Batcher(_engine(models, prefix_cache=True), max_active=4,
                queue_size=8, prefill_chunk=64)
    short = Request(prompts[0], N_NEW)
    b.submit(short)
    b.step()  # the short session is decoding
    req = Request(long, N_NEW)
    b.submit(req)
    b.drain()
    assert req.error is None and short.error is None
    assert req.tokens == long_ref and short.tokens == refs[0]
    # head-less chunks: the long prompt's at 64, 128, 192, 256 and its last
    # insert boundary 296 (then a 4-token final), the short one's at 24
    assert b.stats()["prefill_chunks_dispatched"] == 6


def test_long_prompt_without_chunking_gets_jax_refusal(models):
    jcfg, jparams, long = models[0], models[1], models[6]
    jb = JBatcher(JServeEngine(jparams, jcfg, num_slots=16,
                               prefill_buckets=BUCKETS,
                               batch_buckets=(1, 2, 4)))
    tb = Batcher(_engine(models))
    msgs = []
    for b, cls in ((jb, JRequest), (tb, Request)):
        with pytest.raises(ValueError) as e:
            b.submit(cls(long, N_NEW))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "prefill_chunk" in msgs[0]


def _stop_from(cls, prefix, pos, total, fresh, chunk):
    fake = types.SimpleNamespace(prefill_chunk=None,
                                 engine=types.SimpleNamespace(prefix=prefix))
    return cls._stop_from(fake, pos, total, fresh, chunk=chunk)


def test_stop_from_matches_jax_over_a_grid():
    for stride in (None, 4, 8):
        prefixes = (None, None) if stride is None else (
            jsc.PrefixCache(jsc.StateCache(1, 2, 2), stride=stride),
            tsc.PrefixCache(tsc.StateCache(1, 2, 2, "cpu"), stride=stride))
        for chunk in (None, 4, 8, 16, 32):
            for total in range(1, 41):
                for pos in range(total):
                    for fresh in (True, False):
                        args = (pos, total, fresh, chunk)
                        assert (_stop_from(Batcher, prefixes[1], *args)
                                == _stop_from(JBatcher, prefixes[0], *args)
                                ), (stride, *args)


@pytest.mark.parametrize("chunk", [None, 16, 8])
def test_warmup_replays_jax_stop_lengths(models, chunk, monkeypatch):
    jcfg, jparams = models[0], models[1]
    seen = []
    for b in (JBatcher(JServeEngine(jparams, jcfg, num_slots=16,
                                    prefill_buckets=BUCKETS,
                                    batch_buckets=(1, 2, 4),
                                    prefix_cache=True),
                       prefill_chunk=chunk),
              Batcher(_engine(models, prefix_cache=True),
                      prefill_chunk=chunk)):
        monkeypatch.setattr(b.engine, "warmup",
                            lambda *a, **kw: seen.append(
                                (kw["prompt_lens"], kw["chunk_lens"])) or 0)
        b.warmup(prompt_lens=(5, 17, 40, 100))
    assert seen[0] == seen[1]


def test_incompatible_chunk_and_stride_are_refused(models):
    jcfg, jparams = models[0], models[1]
    jeng = JServeEngine(jparams, jcfg, num_slots=16, prefill_buckets=BUCKETS,
                        batch_buckets=(1, 2, 4), prefix_cache=True,
                        prefix_stride=4)
    teng = _engine(models, prefix_cache=True, prefix_stride=4)
    msgs = []
    for cls, eng in ((JBatcher, jeng), (Batcher, teng)):
        with pytest.raises(ValueError, match="multiple or divisor") as e:
            cls(eng, max_active=4, queue_size=8, prefill_chunk=6)
        msgs.append(str(e.value))
        cls(eng, max_active=4, queue_size=8, prefill_chunk=8)
        cls(eng, max_active=4, queue_size=8, prefill_chunk=2)
    assert msgs[0] == msgs[1]
    Batcher(_engine(models), prefill_chunk=6)  # no prefix cache: any chunk


def test_use_prefix_false_bypasses_the_cache(models):
    prompts, refs = models[4], models[5]
    engine = _engine(models, prefix_cache=True)
    b = Batcher(engine, max_active=4, queue_size=8)
    for _ in range(2):
        reqs = _run(b, prompts, N_NEW, use_prefix=False)
        assert [r.tokens for r in reqs] == refs
    st = engine.prefix.stats()
    assert (st["hits"], st["misses"], st["inserts"], st["entries"]) == (
        0, 0, 0, 0)


def test_speculative_kept_sessions_and_prefix_hits_equal_plain(models):
    prompts, refs = models[4], models[5]
    tcfg = models[2]
    dcfg = draft_config(tcfg)
    dparams = tlm.init_lm(torch.Generator().manual_seed(1), dcfg)
    got = {}
    for spec in (False, True):
        engine = _engine(models, prefix_cache=True, tiered_cache=True,
                         num_slots=5)
        kw = {}
        if spec:
            engine.attach_draft(dparams, dcfg)
            kw = {"speculative": True, "spec_ladder": (2, 4)}
        b = Batcher(engine, max_active=4, queue_size=8, **kw)
        firsts = _run(b, prompts, N_NEW, keep_session=True)  # cold
        firsts += _run(b, prompts, N_NEW, keep_session=True)  # prefix hits
        assert [r.tokens for r in firsts] == refs + refs
        conts = []
        for r in firsts:  # continue every kept session (some from a tier)
            cont = Request([r.tokens[-1]], 9, session_id=r.session_id)
            b.submit(cont)
            b.drain()
            assert cont.error is None, cont.error
            conts.append(cont.tokens)
        got[spec] = conts
        st = b.stats()
        assert st["prefix_resumed"] >= 3
        if spec:
            assert sum(st["spec_windows_dispatched"].values()) >= 1
            assert st["draft_prefill_failures"] == 0
        assert engine.tiers.stats()["fills"]["host"] >= 1
    assert got[True] == got[False]
