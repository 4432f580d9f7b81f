"""Admission router in front of the serve stack's replica.

Port of the one-replica part of ``lstm_tensorspark_tpu/serve/router.py``:
the JAX server builds a :class:`Router` for every stack, one replica
included, and so does the port's :class:`~.server.ServeServer`. A replica
is one engine and one :class:`~.batcher.Batcher` with its scheduler
thread; the port serves exactly one (the JAX package's ``--replicas N``,
remote replicas, drain and canary are not ported, and the router refuses
more than one replica).

:meth:`Router.submit` admits a request, in order:

1. **tenant token bucket** (``tenant_rate`` req/s per ``tenant``, burst
   ``tenant_burst``; off by default): an over-rate tenant is refused with
   the time until its next token as ``Retry-After``, floored by the queue
   drain policy;
2. **class bound**: ``best_effort`` is shed once the live queue reaches
   ``best_effort_frac * queue_size`` (default half), ``priority`` only at
   the full bound. Every shed carries a ``Retry-After`` from the live
   queue-wait p99 (:func:`~.batcher.retry_after_from_p99`) and is counted
   by class;
3. **dispatch** to the replica, stamping ``Request.replica``.

:meth:`Router.sweep` (on every submit) marks a replica whose scheduler
thread exited outside ``stop()`` as retired; with one replica that means
the stack is down, and later submits raise ``RuntimeError``. The JAX
router's requeue of a dead replica's queue onto its peers has no peer to
go to here. Families and ``stats()`` keys are the JAX router's, the
requeue, migration and reroute counters included (they stay 0).

Lock order: ``Router._lock`` is taken above the batcher's lock, never
below it.
"""

from __future__ import annotations

import threading
import time

from .batcher import (CLASSES, Batcher, QueueFullError, Request,
                      register_shed_instruments, retry_after_from_p99)
from .engine import ServeEngine


class Replica:
    """One engine and scheduler pair. ``thread`` is set by the server;
    ``retired`` marks a dead replica, claimed once under the router
    lock."""

    __slots__ = ("index", "engine", "batcher", "thread", "retired")

    def __init__(self, index: int, engine: ServeEngine, batcher: Batcher):
        self.index = index
        self.engine = engine
        self.batcher = batcher
        self.thread: threading.Thread | None = None
        self.retired = False

    def alive(self) -> bool:
        """Never started (requests queue until ``start()``) or running;
        started and exited is dead."""
        return not self.retired and (
            self.thread is None or self.thread.is_alive())

    def stale(self, stale_after: float) -> bool:
        """Running, but its heartbeat is older than ``stale_after``: the
        wedge (a dispatch that never returns). An unstarted replica is not
        stale."""
        hb = self.batcher.last_heartbeat
        return (self.thread is not None and hb is not None
                and time.monotonic() - hb > stale_after)


class Router:
    """Admission front of the stack's replica (module docstring)."""

    #: tenant token-bucket table cap: past it, fully refilled buckets
    #: (the same as absent ones) are pruned, then the fullest is evicted
    MAX_TENANT_BUCKETS = 4096

    def __init__(self, replicas: list[Replica], *, queue_size: int = 64,
                 stale_after: float = 60.0,
                 best_effort_frac: float = 0.5, registry=None,
                 tenant_rate: float | None = None,
                 tenant_burst: float = 5.0):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if len(replicas) > 1:
            raise ValueError(
                f"the port serves one replica; got {len(replicas)} "
                "(multi-replica routing is not ported)")
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        if not 0.0 < best_effort_frac <= 1.0:
            raise ValueError(
                f"best_effort_frac must be in (0, 1], got {best_effort_frac}")
        if tenant_rate is not None and tenant_rate <= 0:
            raise ValueError(
                f"tenant_rate must be > 0 req/s or None, got {tenant_rate}")
        if tenant_burst < 1:
            raise ValueError(
                f"tenant_burst must be >= 1, got {tenant_burst}")
        self.replicas = list(replicas)
        self.queue_size = queue_size
        self.tenant_rate = tenant_rate
        self.tenant_burst = float(tenant_burst)
        self._tenant_buckets: dict[str, list] = {}  # tenant -> [tokens, t]
        self.best_effort_frac = float(best_effort_frac)
        self._best_effort_bound = max(
            1, int(round(queue_size * best_effort_frac)))
        self.stale_after = stale_after
        self._lock = threading.Lock()
        # the death sweep starts disarmed: the server arms it once the
        # scheduler thread runs, and disarms it before a deliberate stop
        self._stopping = True
        self.rejected = 0            # class-bound 429s
        self.shed = {c: 0 for c in CLASSES}
        self.tenant_limited = {c: 0 for c in CLASSES}
        self.requeued = 0
        self.rerouted = 0
        self.failed_on_death = 0
        self.migrated_sessions = 0
        self.lost_sessions = 0
        self.routed: dict[int, int] = {r.index: 0 for r in self.replicas}
        reg = registry if registry is not None else replicas[0].engine.metrics
        self._m_rejected = reg.counter(
            "serve_router_rejected_total",
            "requests 429'd at the router's global admission bound")
        # also under the outcome family (replica="router"): a 429 here is
        # a rejected request, whichever layer refused it
        self._m_rejected_outcome = reg.counter(
            "serve_requests_total",
            labelnames=("outcome", "replica")).labels(
            outcome="rejected", replica="router")
        fam = reg.counter("serve_router_routed_total",
                          "requests routed, by target replica",
                          labelnames=("replica",))
        self._m_routed = {r.index: fam.labels(replica=str(r.index))
                          for r in self.replicas}
        # the JAX router's peer-failover families: registered so the
        # exposition carries them, and 0 with one replica
        reg.counter(
            "serve_router_requeued_total",
            "dead-replica queued requests requeued onto live replicas")
        self._m_failed_death = reg.counter(
            "serve_router_death_failures_total",
            "in-flight requests failed honestly on replica death")
        reg.counter(
            "serve_router_migrated_sessions_total",
            "idle kept sessions moved off dead replicas via detach/restore")
        reg.counter(
            "serve_router_rerouted_total",
            "provably-undelivered remote RPCs re-routed to another replica")
        (self._m_shed, self._m_tenant_shed,
         self._m_retry_after) = register_shed_instruments(reg)
        # the queue-wait family the batcher registered: its p99 is the
        # drain-time evidence Retry-After comes from
        self._qwait = reg.histogram(
            "serve_queue_wait_seconds", "submit → admission wait",
            labelnames=("replica",))

    # ---- client side ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Admit and dispatch one request, or raise
        :class:`QueueFullError` (a shed, with ``retry_after_s``) or
        ``RuntimeError`` when the replica is down. Called from client
        and HTTP threads."""
        self.sweep()
        with self._lock:
            live = [r for r in self.replicas if r.alive()]
            if not live:
                raise RuntimeError(
                    "no routable replica scheduler (the scheduler thread "
                    "died)")
            if self.tenant_rate is not None and req.tenant is not None:
                retry = self._tenant_take_locked(req.tenant)
                if retry is not None:
                    self.tenant_limited[req.klass] += 1
                    self._m_tenant_shed[req.klass].inc()
                    self._m_retry_after.observe(retry)
                    raise QueueFullError(
                        f"tenant {req.tenant!r} exceeded its "
                        f"{self.tenant_rate:g} req/s rate limit; retry "
                        f"after {retry:.2f}s", retry_after_s=retry)
            # a wedged replica's stranded queue does not count against
            # the bound (it would shrink the admission capacity)
            queued = sum(r.batcher.queued() for r in live
                         if not r.stale(self.stale_after))
            bound = (self._best_effort_bound
                     if req.klass == "best_effort" else self.queue_size)
            if queued >= bound:
                retry = self._retry_after_locked(queued)
                self.rejected += 1
                self.shed[req.klass] += 1
                self._m_rejected.inc()
                self._m_rejected_outcome.inc()
                self._m_shed[req.klass].inc()
                self._m_retry_after.observe(retry)
                for r in live:
                    r.batcher.note_shed()
                raise QueueFullError(
                    f"submit queue full for class {req.klass!r} "
                    f"({queued} pending >= bound {bound}); retry after "
                    f"{retry:.2f}s", retry_after_s=retry)
            target = live[0]
            req.replica = target.index
            # the replica's own queue is sized at the same bound, so this
            # raises only ValueError for a request the engine refuses
            target.batcher.submit(req)
            self.routed[target.index] += 1
            self._m_routed[target.index].inc()

    def _tenant_take_locked(self, tenant: str) -> float | None:
        """Take one token from ``tenant``'s bucket: None when one was
        there, else the Retry-After (the time until a token accrues,
        floored by the queue-drain policy)."""
        now = time.monotonic()
        bucket = self._tenant_buckets.get(tenant)
        if bucket is None:
            if len(self._tenant_buckets) >= self.MAX_TENANT_BUCKETS:
                full = [t for t, (tok, ts) in self._tenant_buckets.items()
                        if tok + (now - ts) * self.tenant_rate
                        >= self.tenant_burst]
                for t in full:
                    del self._tenant_buckets[t]
                while len(self._tenant_buckets) >= self.MAX_TENANT_BUCKETS:
                    victim = max(
                        self._tenant_buckets,
                        key=lambda t: self._tenant_buckets[t][0]
                        + (now - self._tenant_buckets[t][1])
                        * self.tenant_rate)
                    del self._tenant_buckets[victim]
            bucket = self._tenant_buckets[tenant] = [self.tenant_burst, now]
        tokens = min(self.tenant_burst,
                     bucket[0] + (now - bucket[1]) * self.tenant_rate)
        bucket[1] = now
        if tokens >= 1.0:
            bucket[0] = tokens - 1.0
            return None
        bucket[0] = tokens
        deficit = (1.0 - tokens) / self.tenant_rate
        s = self._qwait.aggregate_over("replica").get("") or {}
        return max(deficit, retry_after_from_p99(s.get("p99"), 0.0))

    def _retry_after_locked(self, queued: int) -> float:
        """Retry-After of a shed: the queue-wait p99 through the shared
        policy at the current fullness."""
        s = self._qwait.aggregate_over("replica").get("") or {}
        return retry_after_from_p99(
            s.get("p99"), queued / max(self.queue_size, 1))

    # ---- liveness -------------------------------------------------------

    def set_stopping(self, stopping: bool) -> None:
        """A deliberate ``stop()`` joins the scheduler thread: the sweep
        must not read that as a death."""
        with self._lock:
            self._stopping = bool(stopping)

    def sweep(self) -> None:
        """Retire a replica whose scheduler thread died (started, then
        exited outside ``stop()``): its queued and in-flight requests
        fail with a message naming the death, and the replica takes no
        more traffic."""
        claimed: list[Replica] = []
        with self._lock:
            if self._stopping:
                return
            for r in self.replicas:
                if (not r.retired and r.thread is not None
                        and not r.thread.is_alive()):
                    r.retired = True
                    claimed.append(r)
        for r in claimed:
            failed = r.batcher.fail_all(
                f"replica {r.index} scheduler died; its decode position "
                "is indeterminate (state lost — resend the request)")
            with self._lock:
                self.failed_on_death += failed
            if failed:
                self._m_failed_death.inc(failed)

    # ---- views ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "live": sum(1 for r in self.replicas if r.alive()),
                "retired": [r.index for r in self.replicas if r.retired],
                "draining": [],
                "queue_size": self.queue_size,
                "routed": {str(k): v
                           for k, v in sorted(self.routed.items())},
                "rejected": self.rejected,
                "shed_by_class": dict(self.shed),
                "tenant_limited": dict(self.tenant_limited),
                "tenant_rate": self.tenant_rate,
                "best_effort_bound": self._best_effort_bound,
                "best_effort_frac": self.best_effort_frac,
                "requeued": self.requeued,
                "rerouted": self.rerouted,
                "failed_on_death": self.failed_on_death,
                "migrated_sessions": self.migrated_sessions,
                "lost_sessions": self.lost_sessions,
            }
