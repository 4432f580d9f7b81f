"""Online serve autotuner: closed-loop control of the live serve stack
from windowed telemetry deltas.

Port of ``lstm_tensorspark_tpu/serve/autotune.py`` (the same control law,
the same move records on the same signal windows). A controller thread
watches delta-since-last-window views of the live ``serve_ttft_seconds``
/ ``serve_itl_seconds`` / ``serve_queue_wait_seconds`` histograms
(``obs._Family.snapshot_delta``: the registry is cumulative) plus tier
occupancy and spill-thrash counters, and moves five knobs, each within
what the stack warmed:

- **window_k** — the decode-window ceiling (``Batcher.set_window_cap``),
  one rung at a time within the warmed K ladder: larger K when the stack
  is ITL-bound and queues are short, smaller K when the TTFT / queue-wait
  p99 approaches the SLO (an in-flight K-token window is what a new
  arrival waits behind);
- **prefill_chunk** — the chunk size (``Batcher.set_prefill_chunk``),
  among the warmed ``prefill_chunk_choices``: larger under TTFT pressure,
  smaller in ITL-bound steady decode;
- **host_tier** — the host tier's bound (``SessionTiers.
  set_host_entries``): grown under spill thrash, shrunk back toward the
  configured size when occupancy falls;
- **best_effort** — the admission bound (``Router.set_best_effort_frac``):
  tightened when the state plane thrashes at the host tier's ceiling,
  relaxed back toward the configured policy when the thrash clears;
- **spec_k** — the speculative draft depth (``Batcher.set_spec_k``), one
  rung at a time within the warmed spec ladder from the windowed
  ``serve_spec_accept_len`` delta; inert on a non-speculative stack.

**Within the warmed set.** JAX's invariant is that the controller never
triggers a compile in the middle of traffic. The port compiles nothing at
run time, so its form is that every move stays within the set
``Batcher.warmup`` warmed: ``set_window_cap`` accepts only ladder rungs,
``set_prefill_chunk`` only the warmed choices (warmup walks the chunk
stops of every mix of them), ``set_spec_k`` only spec-ladder rungs, and
the capacity and admission knobs touch no kernel. JAX's slot leg
(``_consider_slots``, a device-slot resize through its rollout
controller) is not ported: the port has no rollout controller, and JAX's
leg without one makes no move.

**Hysteresis.** A knob moves only after ``patience_up`` (grow) /
``patience_down`` (shrink) consecutive windows agree on the direction,
then rests for ``cooldown`` windows; a window with fewer than
``min_events`` samples casts no vote.

Decisions, knob positions and the last window's signals are in the
``/v1/stats`` ``autotune`` section and counted in
``serve_autotune_moves_total{knob,direction}``; the controller thread is
started and joined by ``ServeServer.start`` / ``stop``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

#: the knobs, in evaluation order (also the metric label values)
KNOBS = ("window_k", "prefill_chunk", "host_tier", "best_effort", "spec_k")


@dataclasses.dataclass(frozen=True)
class AutoTuneConfig:
    """Controller policy. Thresholds are fractions of ``slo_s`` so one
    flag (``--slo-ms``) re-anchors the whole policy to an SLO."""

    #: seconds between control windows (each tick reads one delta)
    interval_s: float = 0.25
    #: the TTFT p99 the controller protects (``--slo-ms`` / 1e3)
    slo_s: float = 0.25
    #: a delta histogram with fewer samples than this casts no vote
    min_events: int = 8
    #: consecutive agreeing windows before a GROW move (K up, chunk
    #: down, tier shrink, best-effort relax — the optimization side)
    patience_up: int = 3
    #: consecutive agreeing windows before a SHRINK move (K down, chunk
    #: up, tier grow, best-effort tighten — the SLO-protection side)
    patience_down: int = 1
    #: quiet windows after any move of a knob
    cooldown: int = 2
    #: pressure: ttft p99 above this fraction of the SLO
    ttft_high_frac: float = 0.7
    #: headroom: ttft p99 below this fraction of the SLO
    ttft_low_frac: float = 0.35
    #: pressure: queue-wait p99 above this fraction of the SLO
    queue_high_frac: float = 0.35
    #: headroom: queue-wait p99 below this fraction of the SLO
    queue_low_frac: float = 0.15
    #: pressure: live queue depth above this fraction of queue_size
    depth_high_frac: float = 0.5
    #: host-tier growth ceiling (None = 4x the configured entries)
    host_tier_max: int | None = None
    #: best-effort admission-frac floor the tightening leg stops at
    best_effort_floor: float = 0.1
    #: decision records kept for the /stats autotune section
    history: int = 32

    def validate(self) -> "AutoTuneConfig":
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")
        if self.min_events < 1:
            raise ValueError(f"min_events must be >= 1, got {self.min_events}")
        if self.patience_up < 1 or self.patience_down < 1:
            raise ValueError("patience_up/patience_down must be >= 1")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if not 0.0 < self.best_effort_floor <= 1.0:
            raise ValueError(
                f"best_effort_floor must be in (0, 1], got "
                f"{self.best_effort_floor}")
        if self.host_tier_max is not None and self.host_tier_max < 1:
            raise ValueError(
                f"host_tier_max must be >= 1, got {self.host_tier_max}")
        return self


class AutoTuner:
    """The controller (module docstring). Build it over a constructed
    :class:`~.server.ServeServer`; ``start()``/``stop()`` manage the
    thread (the server's own lifecycle drives them), ``tick()`` runs one
    control window directly (tests drive it with injected signals)."""

    def __init__(self, server, config: AutoTuneConfig | None = None):
        self.server = server
        self.cfg = (config or AutoTuneConfig()).validate()
        reg = server.engine.metrics
        # the watched families — idempotent re-registration hands back
        # the SAME live families the batchers record into (name + labels
        # + buckets must match; obs enforces that)
        self._f_ttft = reg.histogram(
            "serve_ttft_seconds", "submit → first token (server-side)",
            labelnames=("replica",))
        self._f_itl = reg.histogram(
            "serve_itl_seconds",
            "inter-token gaps, host arrival times (0 within a window burst)",
            labelnames=("replica",))
        self._f_qwait = reg.histogram(
            "serve_queue_wait_seconds", "submit → admission wait",
            labelnames=("replica",))
        self._f_spec_accept = reg.histogram(
            "serve_spec_accept_len",
            "draft proposals accepted per speculative verify window, "
            "per live row",
            labelnames=("replica",),
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        fam = reg.counter(
            "serve_autotune_moves_total",
            "autotuner knob movements, by knob and direction (both "
            "directions climbing together on a flat workload = the "
            "controller is oscillating; pin the knob and diagnose)",
            labelnames=("knob", "direction"))
        self._m_moves = {(k, d): fam.labels(knob=k, direction=d)
                         for k in KNOBS
                         for d in ("up", "down")}
        # per-consumer delta cursors (only the tick thread touches them)
        self._cur_ttft: dict | None = None
        self._cur_itl: dict | None = None
        self._cur_qwait: dict | None = None
        self._cur_spec: dict | None = None
        self._prev_chunks: float | None = None
        self._prev_tiers: dict | None = None
        # the knobs' CONFIGURED operating points — the relax targets
        b0 = self._local_batchers()[0]
        self._initial_host_entries = self._host_entries()
        self._initial_be_frac = server.router.best_effort_frac
        self._host_max = (self.cfg.host_tier_max
                          if self.cfg.host_tier_max is not None
                          else (None if self._initial_host_entries is None
                                else 4 * self._initial_host_entries))
        if (self._initial_host_entries is not None
                and self._host_max is not None
                and self._host_max < self._initial_host_entries):
            raise ValueError(
                f"host_tier_max {self._host_max} is below the configured "
                f"host tier size {self._initial_host_entries}")
        # the chunk knob needs a warmed choice SET to move within; a
        # single-size (or unchunked) batcher pins the knob
        self._chunk_choices = tuple(b0.prefill_chunk_choices)
        # hysteresis state + history (guarded by _lock: tick() writes,
        # stats() reads from HTTP threads)
        self._lock = threading.Lock()
        self._streak = {k: 0 for k in KNOBS}
        self._cooldown = {k: 0 for k in KNOBS}
        self.moves = {k: {"up": 0, "down": 0} for k in KNOBS}
        self._history: deque = deque(maxlen=self.cfg.history)
        self._last_window: dict = {}
        self.ticks = 0
        self.errors = 0
        self._last_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> "AutoTuner":
        if self._thread is not None:
            raise RuntimeError("autotuner already started")
        self._stop.clear()
        t = threading.Thread(target=self._run, name="serve-autotuner",
                             daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        # the wait IS the cadence: stop() parks the loop within one
        # interval of a shutdown
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception as e:
                # a controller bug must degrade to "knobs stop moving",
                # never to a dead serve plane — recorded, retried next
                # window, surfaced in /stats
                with self._lock:
                    self.errors += 1
                    self._last_error = f"{type(e).__name__}: {e}"

    # ---- plumbing ------------------------------------------------------

    def _local_batchers(self) -> list:
        """The knob surfaces this controller owns: LOCAL replicas only
        (a remote replica's knobs belong to its own host's controller)."""
        return [r.batcher for r in self.server.replicas
                if hasattr(r.batcher, "set_window_cap")]

    def _local_tiers(self) -> list:
        return [r.engine.tiers for r in self.server.replicas
                if getattr(r, "engine", None) is not None
                and getattr(r.engine, "tiers", None) is not None]

    def _host_entries(self) -> int | None:
        tiers = self._local_tiers()
        return tiers[0].host_entries if tiers else None

    # ---- signals -------------------------------------------------------

    def _signals(self) -> dict:
        """One control window's evidence: delta views of the watched
        histograms, the live queue depth, prefill-chunk activity, and
        the tier occupancy/thrash deltas."""
        ttft, self._cur_ttft = self._f_ttft.snapshot_delta(self._cur_ttft)
        itl, self._cur_itl = self._f_itl.snapshot_delta(self._cur_itl)
        qwait, self._cur_qwait = self._f_qwait.snapshot_delta(
            self._cur_qwait)
        spec_accept, self._cur_spec = self._f_spec_accept.snapshot_delta(
            self._cur_spec)
        batchers = self._local_batchers()
        queued = sum(b.queued() for b in batchers)
        chunks_now = float(sum(b.stats()["prefill_chunks_dispatched"]
                               for b in batchers))
        chunk_delta = (0.0 if self._prev_chunks is None
                       else chunks_now - self._prev_chunks)
        self._prev_chunks = chunks_now
        tiers_sig = None
        all_tiers = self._local_tiers()
        if all_tiers:
            snap = {"host": 0, "host_max": 0, "disk_spills": 0.0,
                    "disk_fills": 0.0, "lost": 0.0}
            for t in all_tiers:
                st = t.stats()
                snap["host"] += st["entries"]["host"]
                snap["host_max"] += st["host_entries_max"]
                snap["disk_spills"] += st["spills"]["disk"]
                snap["disk_fills"] += st["fills"]["disk"]
                snap["lost"] += st["lost"]
            prev = self._prev_tiers or snap
            tiers_sig = {
                "host": snap["host"],
                "host_max": snap["host_max"],
                "disk_spills": snap["disk_spills"] - prev["disk_spills"],
                "disk_fills": snap["disk_fills"] - prev["disk_fills"],
                "lost": snap["lost"] - prev["lost"],
            }
            self._prev_tiers = snap
        return {
            "ttft": ttft, "itl": itl, "queue_wait": qwait,
            "queued": queued,
            "queue_size": self.server.router.queue_size,
            "prefill_chunks": chunk_delta,
            "tiers": tiers_sig,
            "spec_accept": spec_accept,
        }

    # ---- verdicts (pure in the signals dict; unit-testable) ------------

    def _pressure(self, sig: dict) -> bool:
        """TTFT / queue-wait approaching the SLO — the shrink signal."""
        cfg = self.cfg
        tt, qw = sig["ttft"], sig["queue_wait"]
        if (tt["count"] >= cfg.min_events
                and tt.get("p99", 0.0) > cfg.slo_s * cfg.ttft_high_frac):
            return True
        if (qw["count"] >= cfg.min_events
                and qw.get("p99", 0.0) > cfg.slo_s * cfg.queue_high_frac):
            return True
        qsize = sig["queue_size"]
        return bool(qsize and sig["queued"] / qsize >= cfg.depth_high_frac)

    def _headroom(self, sig: dict) -> bool:
        """ITL-bound steady decode with short queues — the grow signal.
        Requires POSITIVE evidence of decode traffic (the ITL delta):
        an idle server has headroom by any definition, but moving knobs
        for traffic that does not exist is how controllers oscillate."""
        cfg = self.cfg
        if sig["itl"]["count"] < cfg.min_events:
            return False
        if sig["queued"]:
            return False
        qw, tt = sig["queue_wait"], sig["ttft"]
        if (qw["count"]
                and qw.get("p99", 0.0) > cfg.slo_s * cfg.queue_low_frac):
            return False
        if (tt["count"]
                and tt.get("p99", 0.0) > cfg.slo_s * cfg.ttft_low_frac):
            return False
        return True

    def _spec_batchers(self) -> list:
        return [b for b in self._local_batchers()
                if getattr(b, "speculative", False)]

    def _spec_desire(self, sig: dict) -> int:
        """K_draft vote from the windowed acceptance delta. The draft's
        cost model is simple: one spec window does K_draft cheap draft
        steps + ONE target pass of W=K+1 verify steps, and emits
        accepted+1 tokens. Mean accepted length near the current K
        means the draft is saturating its depth — try the next rung up
        (patience_up: an optimization). Mean below half the depth means
        most verify positions are wasted work — step down (fast,
        patience_down), bottoming out at rung 0 = plain decode. At rung
        0 no spec windows run, so no acceptance evidence can ever
        accumulate; live decode traffic (the ITL delta) is the re-probe
        vote instead — the workload may have shifted back."""
        spec = self._spec_batchers()
        if not spec:
            return 0
        cur = spec[0].spec_k
        cfg = self.cfg
        if cur == 0:
            up = sig["itl"]["count"] >= cfg.min_events
            return 1 if up else 0
        acc = sig.get("spec_accept") or {}
        if acc.get("count", 0) < cfg.min_events:
            return 0
        mean = acc["sum"] / acc["count"]
        if mean >= 0.8 * cur:
            return 1
        if mean < 0.5 * cur:
            return -1
        return 0

    def _thrash(self, sig: dict) -> bool:
        """Spill thrash: the host tier is (near) full while states churn
        through the disk tier or drop as overflow — the tiers' counters
        as the autoscaler's evidence."""
        t = sig.get("tiers")
        if not t or not t["host_max"]:
            return False
        full = t["host"] >= 0.9 * t["host_max"]
        churn = (t["disk_spills"] > 0 or t["disk_fills"] > 0
                 or t["lost"] > 0)
        return bool(full and churn)

    # ---- the control law ----------------------------------------------

    def tick(self, signals: dict | None = None) -> list[dict]:
        """One control window: read the deltas (or use injected
        ``signals`` — tests), update each knob's hysteresis streak, and
        apply at most one move per knob. Returns the applied moves."""
        sig = self._signals() if signals is None else signals
        pressure = self._pressure(sig)
        headroom = self._headroom(sig)
        thrash = self._thrash(sig)
        # desires are URGENCY-signed: -1 = the SLO-PROTECTION side
        # (reacts after patience_down windows — fast), +1 = the
        # optimization side (patience_up — slow). _apply maps the sign
        # to each knob's concrete movement: protecting the SLO means K
        # DOWN but chunk UP (fewer prefill dispatches per prompt), tier
        # GROW, admission TIGHTEN.
        desires = {
            "window_k": -1 if pressure else (1 if headroom else 0),
            # the chunk knob only moves while prefill chunks are
            # actually dispatching — a decode-only window carries no
            # evidence about chunk sizing
            "prefill_chunk": 0 if (not self._chunk_choices
                                   or sig["prefill_chunks"] <= 0)
            else (-1 if pressure else (1 if headroom else 0)),
            "host_tier": -1 if thrash else (
                1 if self._tier_shrinkable(sig) else 0),
            "best_effort": -1 if (thrash and self._tier_at_max()) else (
                1 if (not thrash and self._be_relaxable()) else 0),
            "spec_k": self._spec_desire(sig),
        }
        applied: list[dict] = []
        for knob in KNOBS:
            move = self._consider(knob, desires[knob])
            if move is not None:
                applied.append(move)
        with self._lock:
            self.ticks += 1
            self._last_window = {
                "ttft": sig["ttft"], "itl": sig["itl"],
                "queue_wait": sig["queue_wait"], "queued": sig["queued"],
                "pressure": pressure, "headroom": headroom,
                "thrash": thrash,
                "spec_accept": sig.get("spec_accept"),
            }
            for move in applied:
                move["tick"] = self.ticks  # when, in control windows
                self.moves[move["knob"]][move["direction"]] += 1
                self._history.append(move)
        for move in applied:
            self._m_moves[(move["knob"], move["direction"])].inc()
        return applied

    def _tier_shrinkable(self, sig: dict) -> bool:
        t = sig.get("tiers")
        if not t:
            return False
        cur = self._host_entries()
        return (cur is not None
                and self._initial_host_entries is not None
                and cur > self._initial_host_entries
                and t["host"] < 0.25 * t["host_max"])

    def _tier_at_max(self) -> bool:
        cur = self._host_entries()
        return (cur is not None and self._host_max is not None
                and cur >= self._host_max)

    def _be_relaxable(self) -> bool:
        return (self.server.router.best_effort_frac
                < self._initial_be_frac - 1e-9)

    def _consider(self, knob: str, desired: int) -> dict | None:
        """Hysteresis gate: ``desired`` (+1 grow / -1 shrink / 0 hold)
        must repeat for the direction's patience before the move
        applies; a move starts the knob's cooldown; a disagreeing
        window resets the streak."""
        with self._lock:
            if self._cooldown[knob] > 0:
                self._cooldown[knob] -= 1
                self._streak[knob] = 0
                return None
            if desired == 0:
                self._streak[knob] = 0
                return None
            s = self._streak[knob]
            s = s + desired if (s == 0 or (s > 0) == (desired > 0)) \
                else desired
            self._streak[knob] = s
            need = (self.cfg.patience_up if desired > 0
                    else self.cfg.patience_down)
            if abs(s) < need:
                return None
            self._streak[knob] = 0
        move = self._apply(knob, desired)
        if move is not None:
            with self._lock:
                self._cooldown[knob] = self.cfg.cooldown
        return move

    def _apply(self, knob: str, desired: int) -> dict | None:
        """Apply one bounded step; None when already at the bound.
        ``desired`` is the urgency sign (-1 protect / +1 optimize);
        the reported ``direction`` is the knob VALUE's movement. Every
        target value is inside the warmed set (the setters
        re-validate)."""
        if knob == "window_k":
            # protect = cap down (an in-flight K-window is what a new
            # arrival waits behind), optimize = cap up
            batchers = self._local_batchers()
            ladder = batchers[0].window_ladder
            cur = batchers[0].window_cap
            i = ladder.index(cur) + desired
            if not 0 <= i < len(ladder):
                return None
            for b in batchers:
                b.set_window_cap(ladder[i])
            return {"knob": knob,
                    "direction": "up" if desired > 0 else "down",
                    "from": cur, "to": ladder[i]}
        if knob == "prefill_chunk":
            # protect = chunk UP (a prompt finishes in fewer bounded
            # dispatches — the TTFT side), optimize = chunk down (bound
            # the stall running sessions' gaps absorb — the ITL side)
            batchers = self._local_batchers()
            choices = self._chunk_choices
            cur = batchers[0].prefill_chunk
            i = choices.index(cur) - desired
            if not 0 <= i < len(choices):
                return None
            for b in batchers:
                b.set_prefill_chunk(choices[i])
            return {"knob": knob,
                    "direction": "up" if desired < 0 else "down",
                    "from": cur, "to": choices[i]}
        if knob == "host_tier":
            # protect = grow under spill thrash, optimize = shrink back
            # toward the configured size when occupancy collapses
            cur = self._host_entries()
            if cur is None:
                return None
            if desired < 0:
                new = cur * 2 if self._host_max is None \
                    else min(self._host_max, cur * 2)
            else:
                new = max(self._initial_host_entries, cur // 2)
            if new == cur:
                return None
            for t in self._local_tiers():
                t.set_host_entries(new)
            return {"knob": knob,
                    "direction": "up" if new > cur else "down",
                    "from": cur, "to": new}
        if knob == "spec_k":
            # the draft-depth leg: one rung at a time within the warmed
            # spec ladder (rung 0 = plain decode — the cost fallback);
            # set_spec_k re-validates membership
            spec = self._spec_batchers()
            if not spec:
                return None
            ladder = spec[0].spec_ladder
            cur = spec[0].spec_k
            i = ladder.index(cur) + desired
            if not 0 <= i < len(ladder):
                return None
            for b in spec:
                b.set_spec_k(ladder[i])
            return {"knob": knob,
                    "direction": "up" if desired > 0 else "down",
                    "from": cur, "to": ladder[i]}
        # best_effort: protect = tighten (shed earlier), optimize = relax
        router = self.server.router
        cur = router.best_effort_frac
        new = (min(self._initial_be_frac, cur * 2) if desired > 0
               else max(self.cfg.best_effort_floor, cur / 2))
        if abs(new - cur) < 1e-9:
            return None
        router.set_best_effort_frac(new)
        return {"knob": knob, "direction": "up" if new > cur else "down",
                "from": round(cur, 4), "to": round(new, 4)}

    # ---- views ---------------------------------------------------------

    def stats(self) -> dict:
        """The ``/stats`` ``autotune`` section: knob positions + bounds,
        the LAST control window's delta signals (the recent-biased p99s
        the lifetime ``metrics`` summaries cannot show), move counts,
        and the bounded decision history."""
        batchers = self._local_batchers()
        b0 = batchers[0]
        knobs = {
            "window_k": {"value": b0.window_cap,
                         "ladder": list(b0.window_ladder)},
            "prefill_chunk": {"value": b0.prefill_chunk,
                              "choices": list(self._chunk_choices)},
            "host_tier": {"value": self._host_entries(),
                          "initial": self._initial_host_entries,
                          "max": self._host_max},
            "best_effort": {
                "value": round(self.server.router.best_effort_frac, 4),
                "initial": round(self._initial_be_frac, 4),
                "floor": self.cfg.best_effort_floor},
        }
        spec = self._spec_batchers()
        knobs["spec_k"] = (
            {"value": spec[0].spec_k, "ladder": list(spec[0].spec_ladder)}
            if spec else {"value": None, "ladder": []})
        with self._lock:
            return {
                "interval_s": self.cfg.interval_s,
                "slo_ms": round(self.cfg.slo_s * 1e3, 3),
                "running": self._thread is not None,
                "ticks": self.ticks,
                "errors": self.errors,
                "last_error": self._last_error,
                "knobs": knobs,
                "window": dict(self._last_window),
                "moves": {k: dict(v) for k, v in self.moves.items()},
                "streaks": dict(self._streak),
                "history": list(self._history),
            }
