"""Load generator for the serve stack (runs on the CPU and on the card).

Port of ``lstm_tensorspark_tpu/serve/loadgen.py`` (its ``replica_sweep``
and ``mesh_sweep`` need replicas and a mesh, which the port does not
have). Two modes:

- **closed-loop**: N session threads, each issuing its requests back to
  back through the server — N always-busy clients;
- **open-loop**: requests arrive on a schedule whatever the server does
  (:func:`arrival_offsets`: a fixed rate, bursts, a sine-shaped rate or a
  replayed trace), which exposes queueing delay and shedding.

Traffic is split between the admission classes (``priority_frac``), may
carry a deadline (``deadline_s``), and a shed request may be retried
(``retry_max``), sleeping the server's ``Retry-After`` floored by the
shared capped backoff (:func:`~..backoff.backoff_delay`). The report is a
JSON-ready dict: latency, TTFT and inter-token-gap percentiles (pooled
over every token gap of every completed request), tokens/s and requests/s,
per-class counts and percentiles (``classes``, always present, ``None``
percentiles for a class without traffic), the router's deltas, the prefix
cache's deltas, and the server-side histograms of the registry next to the
client-side numbers. :func:`run_template_mix` drives the tenant-preamble x
template x suffix workload on a bounded worker pool;
:func:`run_longtail` the Zipf-popularity kept-session workload the tiered
cache serves; :func:`concurrency_sweep` the closed loop at several session
counts on one warm server; :func:`kernel_sweep` the same closed loop on a
fresh server per decode-window program (``--decode-kernel pallas,scan``).
Each run is a span of the installed tracer (``--trace``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..backoff import backoff_delay
from ..utils import span
from .batcher import CLASSES, DeadlineExceededError, QueueFullError
from .engine import GREEDY, SamplingParams
from .server import ServeServer
from .state_cache import PREFIX_STATS_CONFIG_KEYS


def arrival_offsets(
    n: int,
    *,
    rate: float | None = None,
    arrival: str = "fixed",
    arrival_times: list[float] | None = None,
    burst_n: int = 8,
    burst_gap_s: float = 0.5,
    sine_period_s: float = 2.0,
    sine_amp: float = 0.8,
) -> list[float]:
    """Arrival schedule for ``n`` open-loop requests: seconds-from-start
    offsets, non-decreasing. The autotuner bench and the chaos drill
    drive phase shifts through these instead of the single fixed rate.

    - ``arrival_times`` (trace replay, ``--arrival-trace``): explicit
      offsets, one request each. A trace shorter than ``n`` LOOPS —
      replayed shifted by its span plus one mean gap, so the recorded
      diurnal/burst shape repeats instead of truncating the workload.
    - ``"fixed"``: the classic constant rate (needs ``rate`` > 0).
    - ``"burst"``: groups of ``burst_n`` simultaneous arrivals every
      ``burst_gap_s`` seconds — with ``rate`` set, requests inside a
      burst are spaced ``1/rate`` apart instead of landing at once.
    - ``"sine"``: a diurnal-shaped rate ``rate * (1 + amp *
      sin(2*pi*t/period))``, generated by stepping ``dt = 1/rate(t)``
      (amp < 1 keeps the instantaneous rate positive).
    """
    if n < 1:
        return []
    if arrival_times is not None:
        trace = [float(t) for t in arrival_times]
        if not trace or any(t < 0 for t in trace):
            raise ValueError("arrival trace needs >= 1 offset, all >= 0")
        if trace != sorted(trace):
            raise ValueError("arrival trace offsets must be sorted")
        gap = trace[-1] / max(len(trace) - 1, 1)
        period = trace[-1] + max(gap, 1e-3)
        return [trace[i % len(trace)] + (i // len(trace)) * period
                for i in range(n)]
    if arrival == "fixed":
        if not rate or rate <= 0:
            raise ValueError("fixed arrivals need rate > 0 (req/s)")
        return [i / rate for i in range(n)]
    if arrival == "burst":
        if burst_n < 1 or burst_gap_s <= 0:
            raise ValueError(
                f"burst arrivals need burst_n >= 1 and burst_gap_s > 0, "
                f"got {burst_n}, {burst_gap_s}")
        intra = 1.0 / rate if rate and rate > 0 else 0.0
        if (burst_n - 1) * intra > burst_gap_s:
            # a burst spilling past the next burst's start silently
            # degenerates into a continuous stream while the report
            # still claims distinct bursts — refuse, don't mislead
            raise ValueError(
                f"burst arrivals overlap: {burst_n} requests spaced "
                f"1/rate = {intra:g}s span past the {burst_gap_s}s "
                "burst gap — raise rate/burst_gap_s or lower burst_n")
        return [(i // burst_n) * burst_gap_s + (i % burst_n) * intra
                for i in range(n)]
    if arrival == "sine":
        if not rate or rate <= 0:
            raise ValueError("sine arrivals need rate > 0 (mean req/s)")
        if not 0.0 <= sine_amp < 1.0 or sine_period_s <= 0:
            raise ValueError(
                f"sine arrivals need 0 <= amp < 1 and period > 0, got "
                f"{sine_amp}, {sine_period_s}")
        import math

        out, t = [], 0.0
        for _ in range(n):
            out.append(t)
            r = rate * (1.0 + sine_amp
                        * math.sin(2.0 * math.pi * t / sine_period_s))
            t += 1.0 / max(r, 1e-6)
        return out
    raise ValueError(
        f"arrival must be 'fixed', 'burst' or 'sine', got {arrival!r}")


def _percentile(sorted_vals: list[float], pct: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = int(round(pct / 100.0 * (len(sorted_vals) - 1)))
    return sorted_vals[min(max(idx, 0), len(sorted_vals) - 1)]


def _random_prompts(n: int, prompt_len: int, vocab_size: int, seed: int,
                    shared_prefix_len: int = 0):
    """``shared_prefix_len > 0`` models the shared-system-prompt workload:
    every prompt starts with the SAME random prefix of that length and
    differs only in its suffix — the prefix cache's target case."""
    if shared_prefix_len >= prompt_len:
        raise ValueError(
            f"shared_prefix_len {shared_prefix_len} must be < prompt_len "
            f"{prompt_len} (each prompt needs a unique suffix)")
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab_size, size=shared_prefix_len)
    return [
        np.concatenate([
            shared,
            rng.randint(0, vocab_size, size=prompt_len - shared_prefix_len),
        ]).astype(np.int32)
        for _ in range(n)
    ]


def _per_replica(results: list[dict]) -> dict:
    """Completed-request / token counts by the replica that served them
    (``Request.replica``, stamped by the router) — the scaling gate's
    routed-request evidence. Single-replica runs report one bucket."""
    out: dict[str, dict] = {}
    for r in results:
        if r.get("replica") is None:
            continue
        d = out.setdefault(str(r["replica"]), {"completed": 0, "tokens": 0})
        d["completed"] += 1
        d["tokens"] += r["tokens"]
    return out


def _class_report(recs: list[dict], shed: int, retried: int,
                  timeouts: int, wall: float) -> dict:
    """Per-admission-class slice of a run: completion/shed/retry/timeout
    counts plus TTFT and latency percentiles (priority p99 TTFT holding
    while best_effort sheds is what a burst shows). ``tokens_per_sec`` is the
    class's ACCEPTED-token throughput over the run's wall clock, so a
    speculative win (or a shedding loss) shows up per SLO class instead
    of being averaged away in the aggregate rate."""
    ttft = sorted(r["ttft_s"] for r in recs if r["ttft_s"] is not None)
    lat = sorted(r["latency_s"] for r in recs)
    tokens = sum(r["tokens"] for r in recs)

    def pct(vals, p):
        # None (JSON null), never NaN: the classes section is ALWAYS
        # present, so a zero-traffic class in a default single-class run
        # must not make every --json report unparseable to strict
        # RFC-8259 consumers (json.dump writes bare NaN)
        if not vals:
            return None
        return round(_percentile(vals, p) * 1e3, 3)

    return {
        "completed": len(recs),
        "shed": shed,
        "retried": retried,
        "timeouts": timeouts,
        "tokens": tokens,
        "tokens_per_sec": round(tokens / wall, 3) if wall > 0 else None,
        "p50_ttft_ms": pct(ttft, 50),
        "p99_ttft_ms": pct(ttft, 99),
        "p50_latency_ms": pct(lat, 50),
        "p99_latency_ms": pct(lat, 99),
    }


def prefix_totals(server: ServeServer) -> dict | None:
    """Prefix-store stats summed across every replica's store (entries
    are replica-local; the workload-level hit rate is the sum's). Config
    keys (:data:`~.state_cache.PREFIX_STATS_CONFIG_KEYS` — shared with
    the server's heartbeat fan-in) keep replica 0's value; the ONE
    aggregation used by loadgen reports and the CLI's engine section, so
    the two can never drift. Works unchanged for both store modes —
    the flat-int stats contract is exactly what makes the sum legal."""
    totals = None
    for rep in server.replicas:
        if rep.engine.prefix is None:
            continue
        st = rep.engine.prefix.stats()
        if totals is None:
            totals = dict(st)
            continue
        for k, v in st.items():
            if k not in PREFIX_STATS_CONFIG_KEYS:
                totals[k] += v
    return totals


def _report(results: list[dict], rejected: int, failed: int, wall_s: float,
            mode: str, sessions: int) -> dict:
    lat = sorted(r["latency_s"] for r in results)
    ttft = sorted(r["ttft_s"] for r in results if r["ttft_s"] is not None)
    # inter-token latency: pooled token-arrival gaps across all requests
    # (a request with T tokens contributes T-1 gaps; TTFT is reported
    # separately and is NOT a gap here)
    itl = sorted(g for r in results for g in r.get("itl_s", ()))
    tokens = sum(r["tokens"] for r in results)
    return {
        "mode": mode,
        "sessions": sessions,
        "requests": len(results) + rejected + failed,
        "completed": len(results),
        "rejected": rejected,
        "failed": failed,
        "wall_s": round(wall_s, 4),
        "p50_latency_ms": round(_percentile(lat, 50) * 1e3, 3),
        "p99_latency_ms": round(_percentile(lat, 99) * 1e3, 3),
        "mean_latency_ms": round(
            (sum(lat) / len(lat) if lat else float("nan")) * 1e3, 3),
        "p50_ttft_ms": round(_percentile(ttft, 50) * 1e3, 3),
        "p99_ttft_ms": round(_percentile(ttft, 99) * 1e3, 3),
        "p50_itl_ms": round(_percentile(itl, 50) * 1e3, 3),
        "p99_itl_ms": round(_percentile(itl, 99) * 1e3, 3),
        "max_itl_ms": round(max(itl) * 1e3, 3) if itl else float("nan"),
        "tokens_generated": tokens,
        "tokens_per_sec": round(tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "requests_per_sec": round(len(results) / wall_s, 2)
        if wall_s > 0 else 0.0,
    }


def run_loadgen(
    server: ServeServer,
    *,
    vocab_size: int,
    sessions: int = 8,
    requests_per_session: int = 4,
    prompt_len: int = 8,
    max_new_tokens: int = 16,
    sampling: SamplingParams = GREEDY,
    mode: str = "closed",
    rate: float | None = None,
    seed: int = 0,
    timeout: float = 300.0,
    shared_prefix_len: int = 0,
    inject_prompt_len: int = 0,
    inject_delay_s: float = 0.25,
    priority_frac: float = 1.0,
    deadline_s: float | None = None,
    retry_max: int = 0,
    retry_base_s: float = 0.05,
    retry_cap_s: float = 2.0,
    arrival: str = "fixed",
    arrival_times: list[float] | None = None,
    burst_n: int = 8,
    burst_gap_s: float = 0.5,
    sine_period_s: float = 2.0,
    sine_amp: float = 0.8,
) -> dict:
    """Drive a started :class:`ServeServer`; returns the report dict.

    ``shared_prefix_len``: prompts share their first N tokens (the
    prefix-cache workload). ``inject_prompt_len > 0``: one extra request
    with a prompt of that length is submitted ``inject_delay_s`` seconds
    into the run — the head-of-line-blocking probe (does a max-bucket
    prefill mid-run stall everyone else's ITL?); it is reported under
    ``"injected"`` and EXCLUDED from the pooled latency stats.

    ``priority_frac``: share of traffic submitted as the "priority"
    admission class; the rest goes "best_effort" (interleaved, so a
    burst mixes both). ``deadline_s`` rides on every request.
    ``retry_max > 0``: a 429 shed is retried up to that many times,
    sleeping the server's ``Retry-After`` hint floored by the shared
    capped exponential backoff + jitter (``backoff.backoff_delay``), both
    capped at
    ``retry_cap_s``; per-class shed/retried/timeout counts land in the
    report's ``classes`` section."""
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
    if not 0.0 <= priority_frac <= 1.0:
        raise ValueError(
            f"priority_frac must be in [0, 1], got {priority_frac}")
    if (arrival != "fixed" or arrival_times is not None) and mode != "open":
        raise ValueError(
            "arrival shaping (trace / burst / sine) is an OPEN-loop "
            "feature: closed-loop arrivals are completion-driven")
    total = sessions * requests_per_session
    prompts = _random_prompts(total, prompt_len, vocab_size, seed,
                              shared_prefix_len)
    n_priority = int(round(sessions * priority_frac))
    results: list[dict] = []
    rejected = [0]
    failed = [0]
    shed = {c: 0 for c in CLASSES}
    retried = {c: 0 for c in CLASSES}
    timeouts = {c: 0 for c in CLASSES}
    lock = threading.Lock()
    prefix_before = prefix_totals(server)
    router_before = server.router.stats()

    def one_request(prompt, klass: str = "priority") -> None:
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                req = server.generate(
                    prompt, max_new_tokens=max_new_tokens,
                    sampling=sampling, timeout=timeout, klass=klass,
                    deadline_s=deadline_s,
                )
                break
            except QueueFullError as e:
                if attempt >= retry_max:
                    # shed for good: an honest 429 the client accepted
                    with lock:
                        rejected[0] += 1
                        shed[klass] += 1
                    return
                attempt += 1
                with lock:
                    retried[klass] += 1
                # honor Retry-After, floored by the shared backoff curve
                # (jittered so a shed burst doesn't re-arrive in
                # lockstep), both capped at retry_cap_s
                hint = getattr(e, "retry_after_s", None) or 0.0
                time.sleep(min(
                    max(hint, backoff_delay(retry_base_s, attempt,
                                            cap=retry_cap_s)),
                    retry_cap_s))
            except DeadlineExceededError:
                # server-side expiry: honest partial output, counted as
                # a timeout for this class — not a failure
                with lock:
                    timeouts[klass] += 1
                return
            except Exception:
                # a timeout or scheduler-side failure must not kill the
                # worker thread (its remaining requests would silently
                # vanish from the report) — count it and keep going
                with lock:
                    failed[0] += 1
                return
        rec = {
            "latency_s": time.perf_counter() - t0,
            "ttft_s": (req.t_first_token - req.t_submit)
            if req.t_first_token and req.t_submit else None,
            "tokens": len(req.tokens),
            "itl_s": req.itl_gaps(),
            "replica": req.replica,
            "klass": klass,
        }
        with lock:
            results.append(rec)

    injected: dict = {}

    def inject() -> None:
        time.sleep(inject_delay_s)
        # a fresh random prompt (distinct seed → shares nothing): a cold
        # max-bucket prefill landing in the middle of steady-state decode
        prompt = _random_prompts(1, inject_prompt_len, vocab_size,
                                 seed + 7919)[0]
        t0 = time.perf_counter()
        try:
            # use_prefix=False: the probe must neither perturb the shared
            # cache (stride-stop inserts would evict real entries) nor
            # skew the report's prefix_cache deltas with its cold miss
            req = server.generate(prompt, max_new_tokens=max_new_tokens,
                                  sampling=sampling, use_prefix=False,
                                  timeout=timeout)
        except Exception as e:
            injected["error"] = f"{type(e).__name__}: {e}"
            return
        injected.update({
            "prompt_len": inject_prompt_len,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3)
            if req.t_first_token and req.t_submit else None,
            "tokens": len(req.tokens),
        })

    with span("loadgen", mode=mode, sessions=sessions, total=total):
        t_start = time.perf_counter()
        inject_thread = None
        if inject_prompt_len > 0:
            inject_thread = threading.Thread(target=inject, daemon=True)
            inject_thread.start()
        if mode == "closed":
            def worker(wid: int) -> None:
                # per-session class: the first n_priority sessions are
                # priority, the rest best-effort
                klass = "priority" if wid < n_priority else "best_effort"
                for r in range(requests_per_session):
                    one_request(prompts[wid * requests_per_session + r],
                                klass)

            threads = [
                threading.Thread(target=worker, args=(i,), daemon=True)
                for i in range(sessions)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:  # open loop: arrivals follow the schedule, not completion
            offsets = arrival_offsets(
                len(prompts), rate=rate, arrival=arrival,
                arrival_times=arrival_times, burst_n=burst_n,
                burst_gap_s=burst_gap_s, sine_period_s=sine_period_s,
                sine_amp=sine_amp)
            threads = []
            for i, prompt in enumerate(prompts):
                # interleaved class pattern (period = sessions): a burst
                # carries both classes throughout, not one then the other
                klass = ("priority"
                         if (i % max(sessions, 1)) < n_priority
                         else "best_effort")
                target = t_start + offsets[i]
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                t = threading.Thread(
                    target=one_request, args=(prompt, klass), daemon=True
                )
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
    # wall covers the POOLED workload only — joining the probe after
    # would charge its sleep+request tail to tokens_per_sec while its
    # tokens are excluded from results
    wall = time.perf_counter() - t_start
    if inject_thread is not None:
        inject_thread.join()
    report = _report(results, rejected[0], failed[0], wall, mode, sessions)
    # per-class accounting (shed/retried/timeout + TTFT percentiles):
    # always present so report consumers have a stable shape; a
    # single-class run simply shows zeros for the other class
    report["timeouts"] = sum(timeouts.values())
    report["requests"] += report["timeouts"]
    report["priority_frac"] = priority_frac
    if deadline_s is not None:
        report["deadline_s"] = deadline_s
    if retry_max:
        report["retry_max"] = retry_max
    report["classes"] = {
        c: _class_report([r for r in results if r.get("klass") == c],
                         shed[c], retried[c], timeouts[c], wall)
        for c in CLASSES
    }
    if rate:
        report["offered_rate_rps"] = rate
    if mode == "open":
        report["arrival"] = ("trace" if arrival_times is not None
                             else arrival)
        if arrival_times is not None:
            report["arrival_trace_len"] = len(arrival_times)
        elif arrival == "burst":
            report["burst_n"] = burst_n
            report["burst_gap_s"] = burst_gap_s
        elif arrival == "sine":
            report["sine_period_s"] = sine_period_s
            report["sine_amp"] = sine_amp
    report["prompt_len"] = prompt_len
    report["shared_prefix_len"] = shared_prefix_len
    if inject_prompt_len > 0:
        report["injected"] = injected
    # per-replica routing evidence: completed/token counts by serving
    # replica (from the requests) + the router's routed/requeue deltas
    report["replicas"] = _per_replica(results)
    ra, rb = server.router.stats(), router_before
    report["router"] = {
        "replicas": ra["replicas"],
        "live": ra["live"],
        "routed": {k: ra["routed"][k] - rb["routed"].get(k, 0)
                   for k in ra["routed"]},
        "rejected": ra["rejected"] - rb["rejected"],
        "shed_by_class": {
            c: ra["shed_by_class"][c] - rb.get("shed_by_class", {}).get(c, 0)
            for c in ra.get("shed_by_class", {})
        },
        "requeued": ra["requeued"] - rb["requeued"],
        "rerouted": ra["rerouted"] - rb.get("rerouted", 0),
        "failed_on_death": ra["failed_on_death"] - rb["failed_on_death"],
        "migrated_sessions":
            ra["migrated_sessions"] - rb["migrated_sessions"],
    }
    if prefix_before is not None:
        after = prefix_totals(server)
        hits = after["hits"] - prefix_before["hits"]
        misses = after["misses"] - prefix_before["misses"]
        report["prefix_cache"] = {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "inserts": after["inserts"] - prefix_before["inserts"],
            "entries": after["entries"],
            "invalidated": after["invalidated"] - prefix_before["invalidated"],
        }
    # server-side latency distributions (obs/ registry histograms) next to
    # the loadgen-side percentiles above, so the two views are directly
    # diffable. NOTE: the registry is CUMULATIVE over the server's life —
    # a sweep's later levels include earlier levels' samples.
    summary = server.metrics_summary()
    hists = {k: summary[k] for k in ("serve_ttft_seconds",
                                     "serve_itl_seconds",
                                     "serve_queue_wait_seconds")
             if isinstance(summary.get(k), dict)}
    if hists:
        report["server_histograms"] = hists
    return report


def template_mix_prompts(sessions: int, *, vocab_size: int,
                         tenants: int = 4, templates: int = 25,
                         preamble_len: int = 128, template_len: int = 32,
                         suffix_len: int = 8, seed: int = 0):
    """The template-mix workload: each
    prompt is tenant preamble × few-shot template × UNIQUE suffix —
    ``tenants`` distinct preambles, ``templates`` templates per tenant,
    sessions assigned round-robin over the (tenant, template) pairs.
    Every prompt's first ``preamble_len + template_len`` tokens are
    shared with every sibling of its pair (and its first
    ``preamble_len`` with every session of its tenant) while the suffix
    keeps it unique — the shape the radix fabric exploits at two depths
    and the exact-match cache cannot (no two FULL prompts ever match).
    Returns ``(prompts, pair_ids)`` with pair_ids[i] the (tenant,
    template) index of prompt i — the parity harness groups by it."""
    if min(tenants, templates, preamble_len, template_len,
           suffix_len) < 1:
        raise ValueError("template-mix dimensions must all be >= 1")
    rng = np.random.RandomState(seed)
    preambles = [rng.randint(0, vocab_size, size=preamble_len)
                 for _ in range(tenants)]
    temps = [[rng.randint(0, vocab_size, size=template_len)
              for _ in range(templates)] for _ in range(tenants)]
    prompts, pair_ids = [], []
    for i in range(sessions):
        tn = i % tenants
        tm = (i // tenants) % templates
        prompts.append(np.concatenate([
            preambles[tn], temps[tn][tm],
            rng.randint(0, vocab_size, size=suffix_len),
        ]).astype(np.int32))
        pair_ids.append((tn, tm))
    return prompts, pair_ids


def run_template_mix(
    server: ServeServer,
    *,
    vocab_size: int,
    sessions: int = 1000,
    tenants: int = 4,
    templates: int = 25,
    preamble_len: int = 128,
    template_len: int = 32,
    suffix_len: int = 8,
    max_new_tokens: int = 8,
    sampling: SamplingParams = GREEDY,
    workers: int = 32,
    seed: int = 0,
    timeout: float = 300.0,
    collect_tokens: bool = False,
) -> dict:
    """Closed-loop template-mix run on a BOUNDED worker pool (a
    thread-per-session closed loop cannot shoulder 10k sessions; this
    pool pulls prompts off a shared index, so ``sessions`` scales to the
    gate's population). One request per session — the workload measures
    PREFILL sharing, not decode. The report adds the prefix-store
    deltas, the computed-vs-offered prefill token split (the fabric
    gate's numerator: ``prefill_tokens_computed`` counts tokens that
    actually ran through the model; offered = Σ len(prompt)), and —
    with ``collect_tokens`` — per-session output-token digests keyed by
    session index for cross-arm greedy-parity comparison."""
    prompts, pair_ids = template_mix_prompts(
        sessions, vocab_size=vocab_size, tenants=tenants,
        templates=templates, preamble_len=preamble_len,
        template_len=template_len, suffix_len=suffix_len, seed=seed)
    results: list[dict] = []
    tokens_by_session: dict[int, list[int]] = {}
    failed = [0]
    lock = threading.Lock()
    next_idx = [0]
    prefix_before = prefix_totals(server)
    batcher_before = server.stats()["batcher"]

    def worker() -> None:
        while True:
            with lock:
                i = next_idx[0]
                if i >= len(prompts):
                    return
                next_idx[0] += 1
            t0 = time.perf_counter()
            try:
                req = server.generate(
                    prompts[i], max_new_tokens=max_new_tokens,
                    sampling=sampling, timeout=timeout)
            except Exception:
                with lock:
                    failed[0] += 1
                continue
            rec = {
                "latency_s": time.perf_counter() - t0,
                "ttft_s": (req.t_first_token - req.t_submit)
                if req.t_first_token and req.t_submit else None,
                "tokens": len(req.tokens),
                "itl_s": req.itl_gaps(),
                "replica": req.replica,
            }
            with lock:
                results.append(rec)
                if collect_tokens:
                    tokens_by_session[i] = [int(t) for t in req.tokens]

    with span("template_mix", sessions=sessions, workers=workers):
        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(workers, sessions))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.perf_counter() - t_start
    report = _report(results, 0, failed[0], wall, "closed", sessions)
    report["workload"] = "template-mix"
    report["tenants"] = tenants
    report["templates_per_tenant"] = templates
    report["prompt_len"] = preamble_len + template_len + suffix_len
    report["replicas"] = _per_replica(results)
    offered = sum(len(p) for p in prompts)
    b_after = server.stats()["batcher"]
    computed = (b_after["prefill_tokens_computed"]
                - batcher_before["prefill_tokens_computed"])
    report["prefill"] = {
        "tokens_offered": offered,
        "tokens_computed": computed,
        "tokens_saved": (b_after["prefix_tokens_saved"]
                         - batcher_before["prefix_tokens_saved"]),
        "sessions_resumed": (b_after["prefix_resumed"]
                             - batcher_before["prefix_resumed"]),
        "compute_ratio": round(computed / offered, 4) if offered else None,
    }
    if prefix_before is not None:
        after = prefix_totals(server)
        hits = after["hits"] - prefix_before["hits"]
        misses = after["misses"] - prefix_before["misses"]
        report["prefix_cache"] = {
            "mode": after.get("mode", "exact"),
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "inserts": after["inserts"] - prefix_before["inserts"],
            "entries": after["entries"],
            "invalidated": (after["invalidated"]
                            - prefix_before["invalidated"]),
        }
        # fabric-only detail: spill/promote traffic and the host-bound
        # evidence the memory gate reads (absent in exact mode)
        if "spilled_bytes" in after:
            report["prefix_cache"]["spilled_bytes"] = after["spilled_bytes"]
            report["prefix_cache"]["host_bytes"] = after["host_bytes"]
            report["prefix_cache"]["spilled"] = (
                after["spilled"] - prefix_before.get("spilled", 0))
            report["prefix_cache"]["promoted"] = (
                after["promoted"] - prefix_before.get("promoted", 0))
    if collect_tokens:
        report["tokens_by_session"] = tokens_by_session
    return report


def tier_totals(server: ServeServer) -> dict | None:
    """SessionTiers stats summed across replicas (same aggregation policy
    as :func:`prefix_totals`): counters summed, per-tier entry counts
    summed, config keys keep replica 0's value."""
    totals = None
    for rep in server.replicas:
        if rep.engine.tiers is None:
            continue
        st = rep.engine.tiers.stats()
        if totals is None:
            totals = {
                "host_entries_max": st["host_entries_max"],
                "entries": dict(st["entries"]),
                "spills": dict(st["spills"]),
                "fills": dict(st["fills"]),
                "misses": st["misses"],
                "corrupt": st["corrupt"],
                "lost": st["lost"],
                "disk_errors": st["disk_errors"],
            }
            continue
        for k in ("entries", "spills", "fills"):
            for t, v in st[k].items():
                totals[k][t] = totals[k].get(t, 0) + v
        for k in ("misses", "corrupt", "lost", "disk_errors"):
            totals[k] += st[k]
    return totals


def run_longtail(
    server: ServeServer,
    *,
    vocab_size: int,
    sessions: int,
    requests_per_session: int = 3,
    prompt_len: int = 8,
    max_new_tokens: int = 8,
    sampling: SamplingParams = GREEDY,
    zipf_s: float = 1.1,
    concurrency: int = 8,
    seed: int = 0,
    timeout: float = 300.0,
) -> dict:
    """Long-tail multi-tenant workload (``cli serve --loadgen
    --idle-churn``): ``sessions`` live kept sessions — size it to ~10x
    the device slots — each created once and then continued by draws
    from a Zipf(``zipf_s``) popularity distribution, so a small hot set
    sees most of the traffic while the long tail sits idle and gets
    LRU-evicted: the workload the tiered cache exists for. Without
    tiers, every evicted session's
    continuation fails "expired" and the client re-prefills its FULL
    accumulated history (counted as ``re_prefills`` /
    ``re_prefill_tokens``); with tiers, continuations fill from host or
    disk for one tiny state copy.

    The report extends :func:`_report` with per-tier hit counts and
    rates for the continuations (``tiers``: device/host/disk/lost),
    the re-prefill cost, and the HOT-SET throughput
    (``hot_set.tokens_per_sec`` over the top-10% sessions by rank).

    Each logical session's full token history is tracked so a
    re-prefilled session resumes token-identically — re-prefill changes
    the COST, never the output."""
    if sessions < 1:
        raise ValueError(f"sessions must be >= 1, got {sessions}")
    rng = np.random.RandomState(seed)
    prompts = _random_prompts(sessions, prompt_len, vocab_size, seed)
    # Zipf-ish popularity: session rank r drawn with weight (r+1)^-s
    weights = (np.arange(sessions) + 1.0) ** -float(zipf_s)
    weights /= weights.sum()
    schedule = list(rng.choice(sessions, size=sessions * requests_per_session,
                               p=weights))
    hot_k = max(1, sessions // 10)

    lock = threading.Lock()
    cond = threading.Condition(lock)
    # per logical session: server-side sid (None until created), full
    # history (prompt + every generated token), token count, in-flight
    # flag (two concurrent requests on one session would be rejected
    # "busy" — the driver serialises per session, like a real client)
    sids: list[str | None] = [None] * sessions
    history: list[list[int]] = [list(map(int, p)) for p in prompts]
    tokens_by_session = [0] * sessions
    busy: set[int] = set()
    rejected = [0]
    failed = [0]
    re_prefills = [0]
    re_prefill_tokens = [0]
    continuations = [0]  # session_id continuations that COMPLETED
    results: list[dict] = []

    tiers_before = tier_totals(server)
    prefix_before = prefix_totals(server)

    def _generate(logical: int, prompt, *, session_id):
        t0 = time.perf_counter()
        req = server.generate(
            prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            session_id=session_id, keep_session=True, timeout=timeout,
        )
        rec = {
            "latency_s": time.perf_counter() - t0,
            "ttft_s": (req.t_first_token - req.t_submit)
            if req.t_first_token and req.t_submit else None,
            "tokens": len(req.tokens),
            "itl_s": req.itl_gaps(),
            "replica": req.replica,
            "session": logical,
        }
        with lock:
            sids[logical] = req.session_id
            history[logical].extend(int(t) for t in req.tokens)
            tokens_by_session[logical] += len(req.tokens)
            results.append(rec)

    def one_turn(logical: int) -> None:
        with lock:
            sid = sids[logical]
        try:
            if sid is None:
                _generate(logical, prompts[logical], session_id=None)
                return
            with lock:
                cont = [history[logical][-1]]
            try:
                _generate(logical, np.asarray(cont, np.int32),
                          session_id=sid)
                with lock:
                    continuations[0] += 1
                return
            except RuntimeError as e:
                if "unknown session" not in str(e):
                    raise
            # evicted with no restorable tier state: the honest client
            # re-sends its FULL history — the cost the tiers exist to kill
            with lock:
                full = list(history[logical])
                re_prefills[0] += 1
                re_prefill_tokens[0] += len(full)
                sids[logical] = None
            _generate(logical, np.asarray(full, np.int32), session_id=None)
        except QueueFullError:
            with lock:
                rejected[0] += 1
        except Exception:
            with lock:
                failed[0] += 1

    def worker() -> None:
        while True:
            with cond:
                idx = next((i for i, s in enumerate(schedule)
                            if s not in busy), None)
                if idx is None:
                    if not schedule:
                        return
                    # every remaining turn targets an in-flight session:
                    # wait for one to free up
                    cond.wait(timeout=0.05)
                    continue
                logical = schedule.pop(idx)
                busy.add(logical)
            try:
                one_turn(logical)
            finally:
                with cond:
                    busy.discard(logical)
                    cond.notify_all()

    with span("loadgen_longtail", sessions=sessions,
              turns=len(schedule)):
        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.perf_counter() - t_start

    report = _report(results, rejected[0], failed[0], wall, "longtail",
                     sessions)
    report["prompt_len"] = prompt_len
    report["zipf_s"] = zipf_s
    report["requests_per_session"] = requests_per_session
    report["re_prefills"] = re_prefills[0]
    report["re_prefill_tokens"] = re_prefill_tokens[0]
    hot_tokens = sum(tokens_by_session[:hot_k])
    report["hot_set"] = {
        "sessions": hot_k,
        "tokens_generated": hot_tokens,
        "tokens_per_sec": round(hot_tokens / wall, 2) if wall > 0 else 0.0,
    }
    # per-tier continuation accounting: fills by tier from the tiers'
    # own counters; device hits are the continuations that needed none.
    # Re-prefills count the evicted-and-unrestorable tail ("lost" from
    # the client's point of view), whatever the tiers' miss counter saw.
    conts = continuations[0] + re_prefills[0]
    ta, tb = tier_totals(server), tiers_before
    if ta is not None:
        host = ta["fills"]["host"] - (tb["fills"]["host"] if tb else 0)
        disk = ta["fills"]["disk"] - (tb["fills"]["disk"] if tb else 0)
        lost = re_prefills[0]
        spills = {t: ta["spills"][t] - (tb["spills"][t] if tb else 0)
                  for t in ta["spills"]}
        device = max(continuations[0] - host - disk, 0)
        total = max(conts, 1)
        report["tiers"] = {
            "continuations": conts,
            "hits": {"device": device, "host": host, "disk": disk},
            "lost": lost,
            "spills": spills,
            "hit_rates": {
                "device": round(device / total, 4),
                "host": round(host / total, 4),
                "disk": round(disk / total, 4),
            },
            "entries": dict(ta["entries"]),
        }
    else:
        report["tiers"] = {
            "continuations": conts,
            "hits": {"device": continuations[0], "host": 0, "disk": 0},
            "lost": re_prefills[0],
            "spills": {},
            "hit_rates": {
                "device": round(continuations[0] / max(conts, 1), 4),
                "host": 0.0, "disk": 0.0,
            },
            "entries": {},
        }
    report["replicas"] = _per_replica(results)
    if prefix_before is not None:
        after = prefix_totals(server)
        report["prefix_cache"] = {
            k: after[k] - prefix_before[k]
            for k in ("hits", "misses", "inserts", "invalidated")
        }
    return report


def concurrency_sweep(
    server: ServeServer,
    *,
    vocab_size: int,
    levels: tuple[int, ...] = (1, 8),
    requests_per_session: int = 4,
    prompt_len: int = 8,
    max_new_tokens: int = 16,
    sampling: SamplingParams = GREEDY,
    seed: int = 0,
) -> dict:
    """Closed-loop throughput at each concurrency level on ONE warm server
    (the server warms every program the levels dispatch before timing, so
    no level is charged a first launch). Returns
    ``{"levels": {n: report}, "speedup_max_vs_1": x}``."""
    with span("loadgen_warmup"):
        # the batcher derives its own window-ladder / chunk / prefix-split
        # programs, so no level is charged a first launch mid-run
        server.warmup(sampling, prompt_lens=(prompt_len,))
    reports = {}
    for n in levels:
        reports[n] = run_loadgen(
            server, vocab_size=vocab_size, sessions=n,
            requests_per_session=requests_per_session,
            prompt_len=prompt_len, max_new_tokens=max_new_tokens,
            sampling=sampling, seed=seed + n,
        )
    out = {"levels": reports}
    if 1 in reports:
        base = reports[1]["tokens_per_sec"] or 1e-9
        out["speedup_max_vs_1"] = round(
            max(r["tokens_per_sec"] for r in reports.values()) / base, 3
        )
    return out


def kernel_sweep(
    make_server,
    *,
    vocab_size: int,
    kernels: tuple[str, ...] = ("scan", "pallas"),
    sessions: int = 8,
    requests_per_session: int = 4,
    prompt_len: int = 8,
    max_new_tokens: int = 16,
    sampling: SamplingParams = GREEDY,
    seed: int = 0,
    parity_prompts: int = 4,
) -> dict:
    """The decode-window comparison (``serve --loadgen --decode-kernel
    pallas,scan``): the same closed-loop workload on a fresh
    ``make_server(kernel)`` stack per kernel, with tokens/s and TTFT / ITL
    percentiles per kernel, the pallas-against-scan deltas, each arm's
    scan fallbacks, and greedy token parity across kernels (the window must
    give the same stream whichever program computes it)."""
    kernels = tuple(dict.fromkeys(kernels))  # dedupe, keep order
    if not kernels:
        raise ValueError("kernels must name at least one decode kernel")
    check_parity = parity_prompts > 0 and sampling.greedy
    probes = (_random_prompts(parity_prompts, prompt_len, vocab_size,
                              seed + 4242) if check_parity else [])
    out: dict = {"kernels": {}}
    parity: dict[str, list[list[int]]] = {}
    fallbacks: dict[str, int] = {}
    for kern in kernels:
        server = make_server(kern)
        with server:
            with span("kernel_sweep_warmup", kernel=kern):
                server.warmup(sampling, prompt_lens=(prompt_len,))
            out["kernels"][kern] = run_loadgen(
                server, vocab_size=vocab_size, sessions=sessions,
                requests_per_session=requests_per_session,
                prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                sampling=sampling, seed=seed,
            )
            if probes:
                parity[kern] = [
                    list(server.generate(p, max_new_tokens=max_new_tokens,
                                         sampling=sampling).tokens)
                    for p in probes
                ]
            es = server.engine.stats()
            out["kernels"][kern]["decode_kernel"] = es["decode_kernel"]
            fallbacks[kern] = es["decode_window_scan_fallbacks"]
    out["scan_fallbacks"] = fallbacks
    if "scan" in out["kernels"] and "pallas" in out["kernels"]:
        s, p = out["kernels"]["scan"], out["kernels"]["pallas"]
        out["pallas_vs_scan"] = {
            "tokens_per_sec_ratio": round(
                p["tokens_per_sec"] / (s["tokens_per_sec"] or 1e-9), 3),
            "p50_itl_delta_ms": round(
                p["p50_itl_ms"] - s["p50_itl_ms"], 3),
            "p99_itl_delta_ms": round(
                p["p99_itl_ms"] - s["p99_itl_ms"], 3),
            "p50_ttft_delta_ms": round(
                p["p50_ttft_ms"] - s["p50_ttft_ms"], 3),
        }
    if parity:
        base = kernels[0]
        out["parity_ok"] = all(parity[k] == parity[base] for k in kernels)
    return out
