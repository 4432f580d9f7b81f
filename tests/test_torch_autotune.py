"""The port's online serve autotuner (``serve/autotune.py``) and the knobs
it drives, on the CPU against the JAX package.

- **control law**: the same seeded signal windows fed to JAX's
  ``AutoTuner.tick`` and the port's, each over its own one-replica stack
  built alike, give the same move records, knob positions, streaks and
  stats (the cases of ``tests/test_serve_autotune.py``: K up on ITL-bound
  windows, K down under pressure, no move on flat / sparse / alternating
  windows, cooldown, the chunk knob opposite to K, the host tier grown
  under spill thrash and shrunk back, best-effort tightened at the
  capacity ceiling and relaxed, and a long random mix of all of them);
- **warmed set**: every setter refuses a value outside what warmup
  warmed, and ``Batcher.warmup`` warms the lengths JAX's warms for every
  mix of chunk choices;
- **off**: no controller, no thread and no ``autotune`` section by
  default; with it on, greedy tokens are those of the stack without it,
  every move stays in its warmed set, and ``serve_autotune_moves_total``
  equals the stats' move counts;
- **CLI**: ``--autotune-chunks`` derived and refused as JAX's command
  does.
"""

import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.obs import MetricsRegistry as TRegistry
from lstm_tensorspark_torch.serve import AutoTuneConfig as TConfig
from lstm_tensorspark_torch.serve import AutoTuner as TTuner
from lstm_tensorspark_torch.serve import ServeEngine as TEngine
from lstm_tensorspark_torch.serve import ServeServer as TServer
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.obs import MetricsRegistry as JRegistry
from lstm_tensorspark_tpu.serve import AutoTuneConfig as JConfig
from lstm_tensorspark_tpu.serve import AutoTuner as JTuner
from lstm_tensorspark_tpu.serve import ServeEngine as JEngine
from lstm_tensorspark_tpu.serve import ServeServer as JServer

torch.set_num_threads(1)

V, H = 29, 16


@pytest.fixture(scope="module")
def params():
    jcfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    jparams = init_lm(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _servers(params, tmp_path, *, tiered=False, host_tier_entries=4, **kw):
    """A JAX and a port one-replica stack, built alike."""
    jcfg, jparams, tparams = params
    kw.setdefault("max_active", 4)
    kw.setdefault("queue_size", 8)
    kw.setdefault("window_ladder", (1, 2, 4))
    ekw = dict(num_slots=8, prefill_buckets=(4, 8, 16),
               batch_buckets=(1, 2, 4), tiered_cache=tiered,
               host_tier_entries=host_tier_entries)
    out = []
    for name, engine, server, reg, p, cfg, extra in (
            ("jax", JEngine, JServer, JRegistry, jparams, jcfg, {}),
            ("torch", TEngine, TServer, TRegistry, tparams,
             tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=1),
             {"device": "cpu"})):
        sdir = str(tmp_path / name) if tiered else None
        eng = engine(p, cfg, registry=reg(), session_dir=sdir, **ekw,
                     **extra)
        out.append(server(eng, **kw))
    return out


def _sig(*, itl=(0, None), qwait=(0, None), ttft=(0, None), queued=0,
         queue_size=8, chunks=0.0, tiers=None):
    def h(pair):
        count, p99 = pair
        out = {"count": count, "sum": 0.0}
        if p99 is not None:
            out["p50"] = p99 / 2
            out["p99"] = p99
        return out

    return {"ttft": h(ttft), "itl": h(itl), "queue_wait": h(qwait),
            "queued": queued, "queue_size": queue_size,
            "prefill_chunks": chunks, "tiers": tiers}


HEADROOM = dict(itl=(20, 0.002), qwait=(6, 0.001), ttft=(6, 0.005))
PRESSURE = dict(itl=(20, 0.002), qwait=(8, 0.15), ttft=(8, 0.18))
THRASH = {"host": 4, "host_max": 4, "disk_spills": 3.0, "disk_fills": 2.0,
          "lost": 1.0}
IDLE = {"host": 0, "host_max": 4, "disk_spills": 0.0, "disk_fills": 0.0,
        "lost": 0.0}


def _random_windows(n, seed):
    """A seeded mix of every kind of window the tests above use."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = [{}, HEADROOM, PRESSURE, dict(HEADROOM, itl=(2, 0.002))][
            rng.randint(4)]
        sig = dict(base)
        if rng.rand() < 0.5:
            sig["chunks"] = float(rng.randint(0, 4))
        if rng.rand() < 0.4:
            host_max = int(rng.choice([4, 8, 16]))
            t = THRASH if rng.rand() < 0.5 else IDLE
            sig["tiers"] = dict(t, host_max=host_max,
                                host=min(t["host"] * host_max // 4,
                                         host_max))
        if rng.rand() < 0.2:
            sig["queued"] = int(rng.randint(0, 8))
        out.append(_sig(**sig))
    return out


CASES = {
    "k_up_on_headroom": (
        dict(), dict(), {"window_cap": 2}, [HEADROOM] * 6),
    "k_down_on_pressure": (dict(), dict(), {}, [PRESSURE] * 5),
    "no_moves_on_flat_sparse_alternating": (
        dict(), dict(patience_up=2, patience_down=2), {"window_cap": 2},
        [{}] * 6 + [dict(HEADROOM, itl=(2, 0.002))] * 6
        + [HEADROOM, PRESSURE] * 4),
    "cooldown": (dict(), dict(cooldown=2), {}, [PRESSURE] * 4),
    "chunk_opposite_to_k": (
        dict(prefill_chunk=4, prefill_chunk_choices=(2, 4, 8)), dict(), {},
        [PRESSURE, dict(PRESSURE, chunks=3.0)]
        + [dict(HEADROOM, chunks=3.0)] * 4),
    "host_tier_grows_and_shrinks": (
        dict(tiered=True), dict(host_tier_max=16), {},
        [dict(tiers=THRASH), dict(tiers=dict(THRASH, host=8, host_max=8))]
        + [dict(tiers=dict(THRASH, host=16, host_max=16))] * 3
        + [dict(tiers=dict(IDLE, host=1, host_max=16))] * 8),
    "best_effort_tightens_and_relaxes": (
        dict(tiered=True), dict(host_tier_max=4, best_effort_floor=0.1), {},
        [dict(tiers=THRASH)] * 5 + [dict(tiers=IDLE)] * 8),
}


def _tuner_cfg(extra):
    kw = dict(slo_s=0.2, min_events=4, patience_up=2, patience_down=1,
              cooldown=0)
    kw.update(extra)
    return kw


def _drive(params, tmp_path, server_kw, cfg_kw, setup, windows):
    server_kw = dict(server_kw)
    records = []
    for server, config, tuner in zip(
            _servers(params, tmp_path, **server_kw), (JConfig, TConfig),
            (JTuner, TTuner)):
        if "window_cap" in setup:
            server.batcher.set_window_cap(setup["window_cap"])
        t = tuner(server, config(**_tuner_cfg(cfg_kw)))
        moves = [t.tick(copy.deepcopy(w)) for w in windows]
        st = t.stats()
        b = server.batcher
        # JAX's slot leg is not ported; without a rollout controller it
        # makes no move, and only its bookkeeping is left to drop
        for part in ("moves", "streaks", "knobs"):
            st[part].pop("slots", None)
        records.append({
            "moves": moves, "history": st["history"],
            "counts": st["moves"], "streaks": st["streaks"],
            "knobs": st["knobs"], "window": st["window"],
            "ticks": st["ticks"],
            "live": (b.window_cap, b.prefill_chunk,
                     server.router.best_effort_frac,
                     None if server.engine.tiers is None
                     else server.engine.tiers.host_entries)})
        if server.engine.tiers is not None:
            server.engine.tiers.close()
    return records


@pytest.mark.parametrize("case", sorted(CASES))
def test_tick_makes_jax_moves(params, tmp_path, case):
    server_kw, cfg_kw, setup, windows = CASES[case]
    jrec, trec = _drive(params, tmp_path, server_kw, cfg_kw, setup,
                        [_sig(**w) for w in windows])
    assert trec == jrec
    if case != "no_moves_on_flat_sparse_alternating":
        assert sum(map(len, trec["moves"])) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tick_makes_jax_moves_on_a_random_mix(params, tmp_path, seed):
    server_kw = dict(tiered=True, prefill_chunk=4,
                     prefill_chunk_choices=(2, 4, 8))
    jrec, trec = _drive(params, tmp_path, server_kw,
                        dict(host_tier_max=16, cooldown=1), {},
                        _random_windows(60, seed))
    assert trec == jrec
    assert sum(map(len, trec["moves"])) > 5


def test_setters_refuse_unwarmed_values(params, tmp_path):
    _, server = _servers(params, tmp_path, prefill_chunk=4,
                         prefill_chunk_choices=(2, 4, 8))
    b = server.batcher
    assert b.window_cap == 4  # the top rung: the uncapped pick
    b.set_window_cap(2)
    assert b.stats()["window_cap"] == 2
    with pytest.raises(ValueError, match="warmed ladder rung"):
        b.set_window_cap(3)
    b.set_prefill_chunk(8)
    assert b.stats()["prefill_chunk"] == 8
    assert b.stats()["prefill_chunk_choices"] == [2, 4, 8]
    with pytest.raises(ValueError, match="warmed choice set"):
        b.set_prefill_chunk(6)
    with pytest.raises(ValueError, match="non-speculative"):
        b.set_spec_k(2)
    b.set_max_active(2)
    assert b.stats()["max_active"] == 2
    for n in (0, 9):
        with pytest.raises(ValueError, match="max_active"):
            b.set_max_active(n)
    with pytest.raises(ValueError, match="best_effort_frac"):
        server.router.set_best_effort_frac(0.0)
    with pytest.raises(ValueError, match="needs prefill_chunk"):
        _servers(params, tmp_path, prefill_chunk_choices=(2, 4))
    _, tiered = _servers(params, tmp_path, tiered=True)
    with pytest.raises(ValueError, match="host_entries"):
        tiered.engine.tiers.set_host_entries(0)
    tiered.engine.tiers.set_host_entries(2)
    assert tiered.engine.tiers.stats()["host_entries_max"] == 2
    tiered.engine.tiers.close()


def _warmup_lengths(server, prompt_lens):
    """What the batcher's warmup asks the engine to warm."""
    seen = {}

    def warmup(sampling, **kw):
        seen.update(kw)
        return 0

    server.engine.warmup = warmup
    server.batcher.warmup(prompt_lens=prompt_lens)
    return {k: tuple(v) for k, v in seen.items()}


@pytest.mark.parametrize("chunk_kw", [
    dict(prefill_chunk=4, prefill_chunk_choices=(2, 4, 8)),
    dict(prefill_chunk=8, prefill_chunk_choices=(4, 8, 16)),
    dict(prefill_chunk=4)])
def test_warmup_warms_every_chunk_mix_as_jax(params, tmp_path, chunk_kw):
    jserver, tserver = _servers(params, tmp_path, **chunk_kw)
    lens = (4, 8, 13, 16)
    assert (_warmup_lengths(tserver, lens)
            == _warmup_lengths(jserver, lens))


def test_off_by_default_and_on_keeps_greedy_tokens(params, tmp_path):
    tparams = params[2]
    cfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=1)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, V, size=int(n)) for n in
               rng.randint(3, 16, size=10)]
    outs, stats = [], []
    for autotune in (None, TConfig(interval_s=0.01, slo_s=0.0005,
                                   min_events=1, patience_up=1,
                                   patience_down=1, cooldown=0)):
        reg = TRegistry()
        eng = TEngine(tparams, cfg, device="cpu", num_slots=8,
                      prefill_buckets=(4, 8, 16), batch_buckets=(1, 2, 4),
                      registry=reg)
        server = TServer(eng, max_active=4, queue_size=16,
                         window_ladder=(1, 2, 4), prefill_chunk=4,
                         prefill_chunk_choices=(2, 4, 8), autotune=autotune)
        with server:
            server.warmup(prompt_lens=(4, 8, 16))
            if autotune is not None:
                assert server.autotuner._thread is not None
            got = [None] * len(prompts)

            def one(i):
                got[i] = list(server.generate(prompts[i],
                                              max_new_tokens=9).tokens)

            for _ in range(3):  # bursts the controller sees as pressure
                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(len(prompts))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(60)
                time.sleep(0.05)
            st = server.stats()
        outs.append(got)
        stats.append((st, reg))
        assert (server.autotuner is None) == (autotune is None)
        if autotune is not None:
            assert server.autotuner._thread is None  # joined by stop()
    assert outs[0] == outs[1]
    off, _ = stats[0]
    assert off["autotune"] is None and off["batcher"]["window_cap"] == 4
    on, reg = stats[1]
    at = on["autotune"]
    assert at["ticks"] > 0 and at["errors"] == 0
    assert at["history"], "the controller never moved under pressure"
    warmed = {"window_k": {1, 2, 4}, "prefill_chunk": {2, 4, 8}}
    for move in at["history"]:
        assert move["to"] in warmed[move["knob"]], move
    fam = reg.counter("serve_autotune_moves_total",
                      labelnames=("knob", "direction"))
    for knob, dirs in at["moves"].items():
        for d, n in dirs.items():
            assert fam.labels(knob=knob, direction=d).value == n
    # the history keeps every move of a short run
    assert sum(sum(d.values()) for d in at["moves"].values()) == len(
        at["history"])


@pytest.mark.parametrize("flags", [
    ["--prefill-chunk", "16"], ["--prefill-chunk", "8", "--prefix-cache",
                                "off"],
    ["--prefill-chunk", "16", "--autotune-chunks", "8,32"],
    ["--prefill-chunk", "16", "--autotune-chunks", "5"],
    ["--autotune-chunks", "8"]])
def test_autotune_chunk_choices_equal_jax(flags):
    jargs = jcli.build_serve_parser().parse_args(["--http"] + flags)
    targs = tcli.build_serve_parser().parse_args(["--http"] + flags)
    outs = []
    for mod, args in ((jcli, jargs), (tcli, targs)):
        try:
            outs.append(mod._autotune_chunk_choices(
                args, args.prefill_chunk or None))
        except SystemExit as e:
            outs.append(("exit", str(e)))
    assert outs[0] == outs[1]


def test_autotune_needs_telemetry(capsys):
    with pytest.raises(SystemExit, match="needs --telemetry on"):
        tcli.main(["serve", "--selftest", "--device", "cpu", "--autotune",
                   "on", "--telemetry", "off"])
