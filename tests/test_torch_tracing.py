"""The port's host-side tracer (``utils/tracing.py``) against the JAX
package's, and the traces its commands write.

- one script of spans, complete events, instants, named rows and a ring
  overflow, on one fake clock, saves the same JSON from both tracers;
- the batchers' ``_emit_timeline`` of one request's phases (and of a
  failed one) saves the same JSON from both packages;
- nothing is recorded, and ``span`` yields None, with no tracer;
- a served burst under a tracer has one timeline row a request, its phases
  in order (queue first, prefill before decode);
- ``serve --loadgen --trace`` and ``train --trace --generate-tokens`` write
  traces with their spans, and a trace that cannot be written leaves the
  command's exit code alone.
"""

import itertools
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.serve import ServeEngine, ServeServer
from lstm_tensorspark_torch.serve.batcher import Batcher as TBatcher
from lstm_tensorspark_torch.utils import tracing as ttracing
from lstm_tensorspark_tpu.serve.batcher import Batcher as JBatcher
from lstm_tensorspark_tpu.utils import tracing as jtracing

torch.set_num_threads(1)


@pytest.fixture
def fake_clock(monkeypatch):
    """``time.perf_counter`` as a counter of 1.25 ms steps, restarted by
    calling the fixture's value."""
    state = {}

    def reset():
        state["it"] = itertools.count()

    reset()
    monkeypatch.setattr(time, "perf_counter",
                        lambda: 100.0 + 0.00125 * next(state["it"]))
    return reset


def _script(mod, path):
    t = mod.Tracer(max_events=6)
    with t.span("load", dataset="ptb_char"):
        with t.span("inner"):
            pass
    t.complete("prefill", 100.01, 100.02, tid=7, request=7)
    t.complete("decode", 100.02, 100.019, tid=7, request=7)  # dur < 0 → 0
    t.set_tid_name(7, "request 7")
    t.instant("mark", step=3)
    for i in range(3):
        t.instant("tick", i=i)  # the ring drops the oldest
    t.save(str(path))
    return json.loads(path.read_text()), t.dropped


def test_tracer_saves_jax_json(tmp_path, fake_clock):
    fake_clock()
    jout, jdropped = _script(jtracing, tmp_path / "j.json")
    fake_clock()
    tout, tdropped = _script(ttracing, tmp_path / "t.json")
    assert tout == jout and tdropped == jdropped == 2
    names = [e["name"] for e in tout["traceEvents"]]
    assert "tracer_dropped_events" in names and "thread_name" in names
    with pytest.raises(ValueError, match="max_events"):
        ttracing.Tracer(max_events=0)


def _request(error=None):
    return types.SimpleNamespace(
        id=41, error=error, t_done=100.5,
        phases=[("queue", 100.0, 100.1), ("prefill", 100.1, 100.2),
                ("decode_window", 100.2, 100.35),
                ("readback", 100.3, 100.4)])


@pytest.mark.parametrize("error", [None, "decode failed: boom"])
def test_emit_timeline_equals_jax(tmp_path, fake_clock, error):
    outs = []
    for mod, batcher in ((jtracing, JBatcher), (ttracing, TBatcher)):
        fake_clock()
        t = mod.Tracer()
        mod.set_tracer(t)
        try:
            batcher._emit_timeline(_request(error))
        finally:
            mod.set_tracer(None)
        path = tmp_path / f"{mod.__name__}.json"
        t.save(str(path))
        outs.append(json.loads(path.read_text()))
    assert outs[0] == outs[1]
    rows = [e for e in outs[1]["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in rows] == (
        ["queue", "prefill", "decode_window", "readback"]
        + (["failed"] if error else []))
    assert {e["tid"] for e in rows} == {41}


def test_nothing_is_recorded_without_a_tracer():
    assert ttracing.get_tracer() is None
    with ttracing.span("free", x=1) as t:
        assert t is None
    ttracing.instant("free")
    TBatcher._emit_timeline(_request())  # no tracer: a no-op
    t = ttracing.Tracer()
    ttracing.set_tracer(t)
    try:
        with ttracing.span("on") as got:
            assert got is t
        ttracing.instant("here")
    finally:
        ttracing.set_tracer(None)
    assert [e["name"] for e in t._events] == ["on", "here"]


def test_served_requests_each_have_a_timeline_row(tmp_path):
    cfg = tlm.LMConfig(vocab_size=29, hidden_size=12, num_layers=1)
    params = tlm.init_lm(torch.Generator().manual_seed(1), cfg)
    engine = ServeEngine(params, cfg, device="cpu", num_slots=8,
                         prefill_buckets=(8, 16), batch_buckets=(1, 2, 4))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 29, size=int(n)) for n in (3, 9, 5, 12)]
    t = ttracing.Tracer()
    ttracing.set_tracer(t)
    try:
        with ServeServer(engine, max_active=4) as server:
            reqs = [None] * len(prompts)

            def one(i):
                reqs[i] = server.generate(prompts[i], max_new_tokens=7)

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
    finally:
        ttracing.set_tracer(None)
    path = tmp_path / "serve.json"
    t.save(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ids = {r.id for r in reqs}
    names = {e["tid"]: e["args"]["name"] for e in events
             if e["name"] == "thread_name" and e["tid"] in ids}
    assert names == {i: f"request {i}" for i in ids}
    for r in reqs:
        row = [e for e in events if e["ph"] == "X" and e["tid"] == r.id]
        assert [e["name"] for e in row] == [n for n, _, _ in r.phases]
        assert row[0]["name"] == "queue"
        kinds = [e["name"] for e in row]
        assert kinds.index("prefill") < min(
            kinds.index(k) for k in kinds if k.startswith("decode"))
        assert all(e["dur"] >= 0 for e in row)


SMALL = ["serve", "--loadgen", "--device", "cpu", "--hidden-units", "16",
         "--num-layers", "1", "--vocab-size", "31", "--sessions", "2",
         "--requests-per-session", "2", "--max-new-tokens", "6",
         "--prefill-buckets", "8,16", "--batch-buckets", "1,2,4",
         "--compare", ""]


def test_serve_trace_flag_writes_the_run(tmp_path, capsys):
    path = tmp_path / "sub" / "serve.json"
    assert tcli.main(SMALL + ["--trace", str(path)]) == 0
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"loadgen", "queue", "prefill", "readback"} <= names
    rows = {e["tid"] for e in events if e["name"] == "prefill"}
    assert len(rows) == 4  # one a request
    assert ttracing.get_tracer() is None  # uninstalled after the run
    # a trace that cannot be written warns and keeps the exit code
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert tcli.main(SMALL + ["--trace", str(blocker / "t.json")]) == 0
    assert "could not write --trace file" in capsys.readouterr().out


TRAIN = ["train", "--device", "cpu", "--hidden-units", "16",
         "--batch-size", "4", "--seq-len", "8", "--num-steps", "4",
         "--log-every", "2", "--compute-dtype", "float32"]


def test_train_trace_and_generate(tmp_path, capsys):
    path, jsonl = tmp_path / "train.json", tmp_path / "m.jsonl"
    ckpt = tmp_path / "ck"
    assert tcli.main(TRAIN + ["--trace", str(path), "--jsonl", str(jsonl),
                              "--checkpoint-dir", str(ckpt),
                              "--checkpoint-every", "2",
                              "--generate-tokens", "12", "--top-k", "5",
                              "--prompt", "the "]) == 0
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"]
    for span in ("load_dataset", "setup", "train", "checkpoint_save",
                 "eval_final", "generate"):
        assert span in names, span
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    gen = [r for r in recs if r.get("note") == "generate"]
    assert len(gen) == 1
    assert {k: gen[0][k] for k in ("prompt", "temperature", "top_k",
                                   "top_p", "greedy")} == {
        "prompt": "the ", "temperature": 1.0, "top_k": 5, "top_p": None,
        "greedy": False}
    assert len(gen[0]["continuation"]) == 12
    assert "--- continuation ---" in capsys.readouterr().out


def test_generate_tokens_refused_off_the_lm_datasets():
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "--dataset", "imdb", "--device", "cpu",
                   "--generate-tokens", "4"])
    assert str(e.value) == ("--generate-tokens applies to the LM datasets "
                            "only (got --dataset imdb)")
