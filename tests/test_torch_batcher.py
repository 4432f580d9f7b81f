"""Scheduler behaviours of the port's ``Batcher`` on the CPU.

The JAX package's serve tests pin these behaviours of its batcher; here
they are replayed on the port: windowed decode (ladder picks, dispatch
ahead of the previous window's fetch) gives the same greedy tokens as the
one-token path and as the plain ``generate``; EOS and budget end retire a
session inside a window; a short request submitted late finishes while a
long one is still decoding; cancelled requests are dropped; mixed sampling
configs are batched apart.
"""

import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import (
    Batcher,
    Request,
    SamplingParams,
    ServeEngine,
)

torch.set_num_threads(1)

V, H = 33, 20
CFG = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=2)


@pytest.fixture(scope="module")
def params():
    return tlm.init_lm(torch.Generator().manual_seed(5), CFG)


def _engine(params):
    return ServeEngine(params, CFG, device="cpu", num_slots=16,
                       prefill_buckets=(8, 16), batch_buckets=(1, 2, 4))


def _ref(params, prompt, n):
    out = tgen.generate(params, prompt[None, :], CFG, max_new_tokens=n,
                        greedy=True, device="cpu")
    return out[0, prompt.size:].tolist()


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=t).astype(np.int32) for t in lens]


@pytest.mark.parametrize("ladder", [(1,), (1, 4, 8)])
def test_windowed_and_token_paths_match_plain_generate(params, ladder):
    prompts = _prompts(0, (2, 6, 13))
    budgets = (17, 9, 12)
    refs = [_ref(params, p, n) for p, n in zip(prompts, budgets)]
    eos = refs[2][5]  # session 2 stops at the first emission of this id
    b = Batcher(_engine(params), max_active=4, window_ladder=ladder)
    reqs = [Request(p, n, eos_id=eos if i == 2 else None)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        b.submit(r)
    b.drain()
    assert [r.tokens for r in reqs[:2]] == refs[:2]
    assert reqs[2].tokens == refs[2][:refs[2].index(eos) + 1]
    assert all(r.done.is_set() and r.error is None for r in reqs)
    stats = b.stats()
    assert stats["completed"] == 3 and stats["active"] == 0
    assert b.engine.cache.stats()["live_sessions"] == 0  # slots released
    if ladder == (1,):
        assert set(stats["windows_dispatched"]) <= {1}
    else:
        assert stats["windows_dispatched"].get(8, 0) >= 1
        assert stats["windows_pipelined"] >= 1


def test_pick_window_never_overshoots(params):
    b = Batcher(_engine(params), window_ladder=(4, 8))
    assert b.window_ladder == (1, 4, 8)
    assert [b._pick_window(r) for r in (1, 3, 4, 7, 8, 100)] == [1, 1, 4, 4, 8, 8]


def test_late_short_request_finishes_first(params):
    long_p, short_p = _prompts(1, (5, 3))
    b = Batcher(_engine(params), max_active=4)
    long_r = Request(long_p, 40)
    b.submit(long_r)
    for _ in range(3):
        b.step()
    short_r = Request(short_p, 2)
    b.submit(short_r)
    while not short_r.done.is_set():
        assert b.step()
    assert not long_r.done.is_set()
    b.drain()
    assert long_r.tokens == _ref(params, long_p, 40)
    assert short_r.tokens == _ref(params, short_p, 2)


def test_budget_of_one_finishes_at_prefill(params):
    (p,) = _prompts(2, (4,))
    b = Batcher(_engine(params))
    r = Request(p, 1)
    b.submit(r)
    b.step()
    assert r.done.is_set() and r.tokens == _ref(params, p, 1)


def test_cancelled_request_is_dropped_before_admission(params):
    p, q = _prompts(3, (4, 5))
    b = Batcher(_engine(params))
    gone, kept = Request(p, 5), Request(q, 5)
    b.submit(gone)
    b.submit(kept)
    gone.cancelled = True
    b.drain()
    assert gone.error == "cancelled before admission" and not gone.tokens
    assert kept.tokens == _ref(params, q, 5)
    assert b.stats()["failed"] == 1


def test_mixed_sampling_configs_are_batched_apart(params):
    p, q = _prompts(4, (6, 7))
    b = Batcher(_engine(params))
    greedy = Request(p, 10)
    sampled = Request(q, 10, sampling=SamplingParams(temperature=0.9))
    b.submit(greedy)
    b.submit(sampled)
    b.drain()
    assert greedy.tokens == _ref(params, p, 10)
    assert len(sampled.tokens) == 10 and all(0 <= t < V for t in sampled.tokens)
    assert b.stats()["prefills_dispatched"] == 2  # one per sampling config


def test_submit_validation(params):
    b = Batcher(_engine(params), queue_size=1)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        b.submit(Request(np.zeros(17, np.int32), 2))
    with pytest.raises(ValueError, match="top-k / top-p"):
        b.submit(Request([1], 2, sampling=SamplingParams(top_p=0.5)))
    with pytest.raises(ValueError, match="slots"):
        Batcher(b.engine, max_active=17)
    with pytest.raises(ValueError):
        Request([], 2)
    with pytest.raises(ValueError):
        Request([1], 0)
