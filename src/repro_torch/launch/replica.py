"""Replicated video search: heartbeat failover, hedging, warm restart
(port of ``repro.launch.replica``).

A :class:`~repro_torch.launch.serve.MicrobatchScheduler` guarantees that
every accepted future resolves; this module makes the same guarantee
survive the death of the replica holding the future.  A
:class:`ReplicaSet` runs N worker replicas — each a full serving stack
(its own :class:`~repro_torch.launch.serve.VideoSearchServer` engine pool
+ scheduler) — behind one submission front end:

* **Membership** — every replica posts heartbeats to a
  :class:`~repro_torch.distributed.fault.HeartbeatMonitor`; a poller
  thread applies the staleness thresholds, driving the healthy → suspect
  → dead lifecycle (``draining`` is entered deliberately via
  :meth:`ReplicaSet.drain_replica`).  Replicas are thread-backed here,
  but the set only ever sees an opaque member id, a ``submit() ->
  Future`` and a heartbeat stream, the surface a multi-process worker
  presents too.
* **Failover** — an attempt that dies with its replica (the replica's
  scheduler closed under it, or the monitor declared the replica dead
  while the attempt was in flight) is re-dispatched to a live replica,
  excluding every replica already tried.  Failover is a membership
  event, not a request fault: it does **not** consume the client retry
  budget (each replica's scheduler runs its own ``RetryPolicy``; the set
  never counts attempts against it) — the rule the degradation ladder
  applies to its rungs, lifted to replicas.  Client-attributable
  outcomes (``RequestRejected`` everywhere, ``DeadlineExceeded``,
  quarantine, validation errors) pass through unchanged.
* **Hedging** — a request outstanding longer than the hedge delay
  (derived from the completed-latency p99, so it self-tunes to the
  workload) is duplicated to a second replica; the first result
  resolves the client future and the loser is cancelled.  Safe because
  readout is idempotent and replicas built alike compute identical
  scores for the same request.  A hedge is never scheduled past the
  request's remaining deadline budget.
* **Durable recovery** — tenant state (kernel bytes + content hash,
  fidelity pipeline, device configs) is persisted through
  :mod:`repro_torch.checkpoint` as a *tenant manifest*, in the
  reference's format, so either package reads the other's; a replacement
  replica re-records its gratings from the manifest and is admitted to
  the membership only after a warm-up probe returns scores bitwise-equal
  to a healthy replica's (:meth:`ReplicaSet.replace_replica`).

On the card: tenant kernels are held on the host (``add_tenant`` copies a
tensor on any device to numpy before taking the set's lock), hashes are
computed on host bytes (the reference's digests), and no field lock is
held across device work — a CUDA synchronisation under ``_lock`` would
stall the poller, the heartbeats and every done-callback.  ``kill``
closes a replica's scheduler from the calling thread without touching
the device: a batch already launched finishes on the batcher thread.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

import numpy as np

import torch

from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.core import atomic, optics
from repro_torch.core import fidelity as fidelity_mod
from repro_torch.core.fidelity import FidelityPipeline
from repro_torch.distributed.fault import (
    DEAD,
    DRAINING,
    HEALTHY,
    HeartbeatMonitor,
)
from repro_torch.launch.resilience import (
    DeadlineExceeded,
    ReplicaUnavailable,
    SchedulerClosed,
    ServingError,
    is_validation_error,
    resolve_exception,
    resolve_result,
)
from repro_torch.launch.serve import MicrobatchScheduler, VideoSearchServer


# ---------------------------------------------------------------------------
# Hedge policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When to duplicate a straggling request to a second replica.

    The hedge delay is ``multiplier × p99`` of the set's completed
    request latencies (clamped to at least ``min_delay_s``) once
    ``min_samples`` latencies exist; before that the cold-start
    ``cold_delay_s`` applies.  ``enabled=False`` turns hedging off
    entirely (failover is unaffected).
    """

    enabled: bool = True
    multiplier: float = 2.0
    min_delay_s: float = 0.005
    cold_delay_s: float = 0.05
    min_samples: int = 20


# ---------------------------------------------------------------------------
# Tenant manifest (durable recovery)
# ---------------------------------------------------------------------------


def kernel_hash(kernels: np.ndarray) -> str:
    """Content hash of a kernel set: bytes + shape + dtype, so a
    truncated or re-typed array never passes as the original."""
    arr = np.ascontiguousarray(kernels)
    h = hashlib.sha1()
    h.update(str((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _fidelity_to_json(pipe: FidelityPipeline) -> dict:
    return {
        "name": pipe.name,
        "stages": [
            {"type": type(s).__name__, "params": dataclasses.asdict(s)}
            for s in pipe.stages
        ],
    }


def _fidelity_from_json(d: dict) -> FidelityPipeline:
    stages = tuple(
        getattr(fidelity_mod, s["type"])(**s["params"]) for s in d["stages"]
    )
    return FidelityPipeline(stages=stages, name=d.get("name", ""))


@dataclasses.dataclass
class _TenantSpec:
    """The replica-set-level record of one tenant — everything needed to
    re-record its gratings on a fresh replica.  ``fidelity``/``slm``/
    ``atoms`` of None mean "the server default" (and are persisted as
    such, so a restart under a different server default is visible)."""

    name: str
    kernels: np.ndarray
    fidelity: FidelityPipeline | None = None
    slm: optics.SLMConfig | None = None
    atoms: atomic.AtomicConfig | None = None

    def manifest_entry(self) -> dict:
        return {
            "hash": kernel_hash(self.kernels),
            "shape": list(self.kernels.shape),
            "dtype": str(self.kernels.dtype),
            "fidelity": (
                None if self.fidelity is None else _fidelity_to_json(self.fidelity)
            ),
            "slm": None if self.slm is None else dataclasses.asdict(self.slm),
            "atoms": None if self.atoms is None else dataclasses.asdict(self.atoms),
        }

    @classmethod
    def from_manifest(cls, name: str, entry: dict, kernels: np.ndarray) -> "_TenantSpec":
        got = kernel_hash(kernels)
        if got != entry["hash"]:
            raise ValueError(
                f"tenant manifest hash mismatch for {name!r}: stored "
                f"{entry['hash'][:12]}…, loaded kernels hash {got[:12]}… — "
                "refusing to warm-restart from corrupt state"
            )
        return cls(
            name=name,
            kernels=kernels,
            fidelity=(
                None
                if entry["fidelity"] is None
                else _fidelity_from_json(entry["fidelity"])
            ),
            slm=None if entry["slm"] is None else optics.SLMConfig(**entry["slm"]),
            atoms=(
                None if entry["atoms"] is None else atomic.AtomicConfig(**entry["atoms"])
            ),
        )


def load_tenant_manifest(ckpt_dir: str) -> dict[str, _TenantSpec]:
    """Load the latest persisted tenant manifest: name → spec, kernel
    hashes verified against the stored bytes (raises on mismatch)."""
    step = ckpt_mod.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no tenant manifest under {ckpt_dir!r}")
    manifest = ckpt_mod.read_manifest(ckpt_dir, step)
    entries = manifest.get("extra", {}).get("tenants", {})
    path = os.path.join(ckpt_dir, f"step_{step}", "kernels.npz")
    specs: dict[str, _TenantSpec] = {}
    with np.load(path) as z:
        for name, entry in entries.items():
            specs[name] = _TenantSpec.from_manifest(name, entry, z[name])
    return specs


# ---------------------------------------------------------------------------
# Worker replica
# ---------------------------------------------------------------------------


class WorkerReplica:
    """One serving replica: a private engine pool + scheduler plus a
    heartbeat thread.  Thread-backed, but the surface the set consumes
    (member id, ``submit() -> Future``, heartbeats) is process-agnostic.

    ``kill()`` simulates a crash: heartbeats stop and the scheduler is
    closed, so queued/in-flight attempts resolve with
    ``SchedulerClosed`` (→ failover at the set layer) and the monitor
    declares the member dead.  ``stall()`` simulates a wedged process:
    heartbeats stop but the scheduler keeps running — the only signal is
    the heartbeat staleness, which is exactly what the monitor-driven
    rescue path exists for.
    """

    def __init__(
        self,
        name: str,
        build_server: Callable[[], VideoSearchServer],
        monitor: HeartbeatMonitor,
        heartbeat_interval_s: float = 0.02,
        scheduler_kwargs: dict | None = None,
    ):
        self.name = name
        self.server = build_server()
        self._sched = MicrobatchScheduler(self.server, **(scheduler_kwargs or {}))
        self._monitor = monitor
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._lock = threading.Lock()
        self.outstanding = 0  # guarded-by: _lock
        self._killed = False  # guarded-by: _lock
        self._closed = threading.Event()
        self._stalled = threading.Event()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name=f"replica-{name}-heartbeat", daemon=True
        )
        self._beat_thread.start()

    # -- heartbeats --------------------------------------------------------

    def _beat_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_interval_s):
            if not self._stalled.is_set():
                self._monitor.beat(self.name)

    def stall(self) -> None:
        """Suppress heartbeats (wedged-process simulation); the
        scheduler keeps serving whatever it already holds."""
        self._stalled.set()

    def unstall(self) -> None:
        self._stalled.clear()

    # -- serving -----------------------------------------------------------

    def submit(
        self,
        tenant: str,
        clip,
        block: bool = False,
        deadline_s: float | None = None,
    ) -> Future:
        """One attempt on this replica; raises ``SchedulerClosed`` if the
        replica is already dead (the set treats that as try-next)."""
        with self._lock:
            if self._killed:
                raise SchedulerClosed(
                    f"replica {self.name!r} is killed", tenant=tenant
                )
            self.outstanding += 1
        try:
            fut = self._sched.submit(tenant, clip, block=block, deadline_s=deadline_s)
        except BaseException:
            with self._lock:
                self.outstanding -= 1
            raise
        fut.add_done_callback(self._attempt_finished)
        return fut

    def _attempt_finished(self, _fut: Future) -> None:
        with self._lock:
            self.outstanding -= 1

    @property
    def killed(self) -> bool:
        with self._lock:
            return self._killed

    @property
    def mesh(self):
        """This replica's device mesh (None = one device).  The server
        builds it from ``VideoSearchConfig.mesh_shape``, so a replacement
        replica, whose server is built anew, owns a mesh of its own and
        never shares a dead replica's."""
        return getattr(self.server, "mesh", None)

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Crash the replica: no more heartbeats, scheduler closed.
        Every in-flight/queued inner future resolves with
        ``SchedulerClosed`` — the set fails those attempts over."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self._closed.set()
        self._sched.close()

    def close(self) -> None:
        """Graceful shutdown (drain path); same mechanics as kill but
        semantically deliberate — callers drain first."""
        self.kill()

    def metrics(self) -> dict:
        out = self._sched.metrics()
        with self._lock:
            out["outstanding"] = self.outstanding
            out["killed"] = self._killed
        out["stalled"] = self._stalled.is_set()
        mesh = self.mesh
        out["mesh"] = mesh.shape if mesh is not None else None
        return out


# ---------------------------------------------------------------------------
# Replica set
# ---------------------------------------------------------------------------


class _Attempt:
    """In-flight bookkeeping for one client request.  All mutable fields
    are guarded by the owning :class:`ReplicaSet`'s ``_lock`` (this is a
    record, not an actor — it has no lock of its own)."""

    __slots__ = (
        "outer",
        "tenant",
        "clip",
        "deadline",
        "t_submit",
        "tried",
        "inner",
        "replica",
        "primary",
        "hedged",
        "failover_pending",
    )

    def __init__(self, outer: Future, tenant: str, clip, deadline: float | None):
        self.outer = outer
        self.tenant = tenant
        self.clip = clip
        self.deadline = deadline  # absolute, time.time() frame; None = none
        self.t_submit = time.time()
        self.tried: set[str] = set()  # replica names already attempted
        self.inner: dict[str, Future] = {}  # replica name -> inner future
        self.replica: str | None = None  # latest replica dispatched to
        self.primary: str | None = None  # first replica dispatched to
        self.hedged = False
        self.failover_pending = False


class ReplicaSet:
    """N worker replicas behind one submit front end: heartbeat-driven
    failover, tail-latency hedging, durable warm restart.

    ``build_server`` is the per-replica factory (each replica owns its
    engine pool; nothing device-side is shared between replicas — that
    is the point).  ``ckpt_dir`` enables the durable tenant manifest:
    every ``add_tenant`` persists it, and :meth:`replace_replica`
    rebuilds a fresh replica from it.

    See the module docstring for the failover/hedging rules and the
    lifecycle.
    """

    def __init__(
        self,
        build_server: Callable[[], VideoSearchServer],
        n_replicas: int = 3,
        suspect_after_s: float = 0.06,
        dead_after_s: float = 0.15,
        heartbeat_interval_s: float = 0.02,
        poll_interval_s: float = 0.01,
        hedge: HedgePolicy | None = None,
        default_deadline_s: float | None = None,
        ckpt_dir: str | None = None,
        scheduler_kwargs: dict | None = None,
        latency_window: int = 2048,
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._build_server = build_server
        self.hedge = hedge if hedge is not None else HedgePolicy()
        self.default_deadline_s = default_deadline_s
        self.ckpt_dir = ckpt_dir
        self._scheduler_kwargs = dict(scheduler_kwargs or {})
        self._heartbeat_interval_s = float(heartbeat_interval_s)
        self.poll_interval_s = float(poll_interval_s)
        self.monitor = HeartbeatMonitor(
            suspect_after_s=suspect_after_s,
            dead_after_s=dead_after_s,
            on_change=self._on_state_change,
        )
        self._lock = threading.Lock()
        self._replicas: dict[str, WorkerReplica] = {}  # guarded-by: _lock
        self._tenants: dict[str, _TenantSpec] = {}  # guarded-by: _lock
        self._inflight: dict[int, _Attempt] = {}  # guarded-by: _lock
        self._latencies: deque[float] = deque(maxlen=latency_window)  # guarded-by: _lock
        self._req_seq = 0  # guarded-by: _lock
        self._rr = 0  # round-robin cursor; guarded-by: _lock
        self._manifest_step = 0  # guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.completed = 0  # guarded-by: _lock
        self.failed = 0  # guarded-by: _lock
        self.failovers = 0  # guarded-by: _lock
        self.rescued = 0  # guarded-by: _lock
        self.hedges = 0  # guarded-by: _lock
        self.hedge_wins = 0  # guarded-by: _lock
        self.unroutable = 0  # guarded-by: _lock
        self._closed = threading.Event()
        replicas = {
            f"r{i}": WorkerReplica(
                f"r{i}",
                build_server,
                self.monitor,
                heartbeat_interval_s=self._heartbeat_interval_s,
                scheduler_kwargs=self._scheduler_kwargs,
            )
            for i in range(n_replicas)
        }
        with self._lock:
            self._replicas.update(replicas)
        for name in replicas:
            self.monitor.register(name)
        self._poller = threading.Thread(
            target=self._poll_loop, name="replica-set-poller", daemon=True
        )
        self._poller.start()

    # -- tenants -----------------------------------------------------------

    def add_tenant(
        self,
        name: str,
        kernels,
        fidelity: FidelityPipeline | None = None,
        slm: optics.SLMConfig | None = None,
        atoms: atomic.AtomicConfig | None = None,
    ) -> "ReplicaSet":
        """Register a tenant on every replica and persist the manifest
        (when ``ckpt_dir`` is set) so a replacement replica can
        re-record the same gratings after a crash.  ``kernels`` is a
        numpy array or a tensor on any device; the set keeps a host
        copy."""
        if isinstance(kernels, torch.Tensor):
            kernels = kernels.detach().cpu().numpy()
        spec = _TenantSpec(
            name=name,
            kernels=np.array(kernels),
            fidelity=fidelity,
            slm=slm,
            atoms=atoms,
        )
        with self._lock:
            self._tenants[name] = spec
            replicas = list(self._replicas.values())
        # fan-out outside the lock: add_tenant records gratings (device
        # work) and the servers have locks of their own
        for replica in replicas:
            replica.server.add_tenant(
                name, spec.kernels, fidelity=fidelity, slm=slm, atoms=atoms
            )
        if self.ckpt_dir is not None:
            self.save_manifest()
        return self

    def save_manifest(self) -> str:
        """Persist the tenant manifest through ``repro_torch.checkpoint``:
        kernel bytes as the payload tree, hashes + fidelity/device
        fingerprints in the manifest JSON.  Atomic + fsynced (the
        checkpoint layer's guarantee), so a crash mid-save can never
        corrupt the last good manifest."""
        if self.ckpt_dir is None:
            raise ValueError("ReplicaSet has no ckpt_dir configured")
        with self._lock:
            specs = dict(self._tenants)
            self._manifest_step += 1
            step = self._manifest_step
        trees = {"kernels": {name: s.kernels for name, s in specs.items()}}
        extra = {
            "schema": 1,
            "tenants": {name: s.manifest_entry() for name, s in specs.items()},
        }
        return ckpt_mod.save(self.ckpt_dir, step, trees, extra=extra)

    # -- submission --------------------------------------------------------

    def submit(
        self,
        tenant: str,
        clip,
        block: bool = False,
        deadline_s: float | None = None,
    ) -> Future:
        """Submit one search to the set; the returned future resolves
        with a result dict or a typed ``ServingError`` — never hangs,
        even if the replica holding it dies mid-flight."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = time.time() + deadline_s if deadline_s is not None else None
        outer: Future = Future()
        outer.set_running_or_notify_cancel()  # the set owns resolution
        rec = _Attempt(outer, tenant, clip, deadline)
        with self._lock:
            self._req_seq += 1
            seq = self._req_seq
            self.submitted += 1
            self._inflight[seq] = rec
        outer.add_done_callback(lambda _f, seq=seq: self._retire(seq))
        self._dispatch(rec, block=block)
        return outer

    def search(self, tenant: str, clip, block: bool = True) -> dict:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(tenant, clip, block=block).result()

    def _retire(self, seq: int) -> None:
        now = time.time()
        with self._lock:
            rec = self._inflight.pop(seq, None)
            if rec is None:
                return
            err = None
            if not rec.outer.cancelled():
                err = rec.outer.exception()
            if err is None:
                self.completed += 1
                self._latencies.append(now - rec.t_submit)
            else:
                self.failed += 1
            inners = list(rec.inner.values())
        for f in inners:  # best-effort loser cancellation
            if not f.done():
                f.cancel()

    def _pick_replica(self, exclude: set[str]) -> WorkerReplica | None:
        """Round-robin over healthy members not yet tried.  Healthy is
        the only dispatchable state: suspect replicas get no *new* work
        (they may still win in-flight races), draining replicas are
        being decommissioned."""
        healthy = self.monitor.members(HEALTHY)
        with self._lock:
            candidates = [
                self._replicas[n]
                for n in healthy
                if n not in exclude and n in self._replicas
            ]
            if not candidates:
                return None
            self._rr += 1
            return candidates[self._rr % len(candidates)]

    def _dispatch(self, rec: _Attempt, block: bool = False) -> None:
        """Place one attempt for ``rec`` on a healthy untried replica;
        resolves the outer future with a typed error when none can take
        it.  Never raises."""
        while True:
            if rec.outer.done():
                return
            now = time.time()
            if rec.deadline is not None and now >= rec.deadline:
                resolve_exception(
                    rec.outer,
                    DeadlineExceeded(
                        f"deadline passed before a replica could serve "
                        f"tenant {rec.tenant!r}",
                        tenant=rec.tenant,
                    ),
                )
                return
            with self._lock:
                tried = set(rec.tried)
            replica = self._pick_replica(tried)
            if replica is None:
                with self._lock:
                    live = any(not f.done() for f in rec.inner.values())
                    if not live:
                        self.unroutable += 1
                if live:
                    # a hedge found no spare replica while the original
                    # attempt is still in flight: drop the duplicate —
                    # the live attempt resolves the outer future
                    return
                resolve_exception(
                    rec.outer,
                    ReplicaUnavailable(
                        f"no healthy replica available for tenant "
                        f"{rec.tenant!r} (tried {sorted(tried) or 'none'})",
                        tenant=rec.tenant,
                        replica=rec.replica,
                    ),
                )
                return
            remaining = (
                rec.deadline - now if rec.deadline is not None else None
            )
            try:
                inner = replica.submit(
                    rec.tenant, rec.clip, block=block, deadline_s=remaining
                )
            except SchedulerClosed:
                # lost the race with a concurrent kill: this replica is
                # not a viable target — exclude it and try the next
                with self._lock:
                    rec.tried.add(replica.name)
                continue
            except ServingError as exc:
                # admission shed (RequestRejected) or another typed
                # rejection from this replica: try the others first,
                # surface it only when every replica rejects AND no
                # sibling attempt is still racing — a hedge bouncing
                # off a full queue must not fail a request whose
                # primary is about to deliver
                with self._lock:
                    rec.tried.add(replica.name)
                    tried = set(rec.tried)
                    live = any(not f.done() for f in rec.inner.values())
                if all(n in tried for n in self.monitor.members(HEALTHY)):
                    if live:
                        return
                    exc.tenant = exc.tenant or rec.tenant
                    resolve_exception(rec.outer, exc)
                    return
                continue
            with self._lock:
                rec.tried.add(replica.name)
                rec.inner[replica.name] = inner
                rec.replica = replica.name
                if rec.primary is None:
                    rec.primary = replica.name
                rec.failover_pending = False
            inner.add_done_callback(
                lambda f, rec=rec, rname=replica.name: self._attempt_done(
                    rec, rname, f
                )
            )
            return

    # -- attempt resolution ------------------------------------------------

    def _attempt_done(self, rec: _Attempt, rname: str, inner: Future) -> None:
        """Done-callback for one inner attempt.  First successful (or
        client-attributable) outcome resolves the outer future; an
        infra-death outcome fails over — unless another attempt for the
        same request is still in flight (a hedge or a rescue), in which
        case this loss is simply dropped."""
        if rec.outer.done():
            return
        if inner.cancelled():
            return
        exc = inner.exception()
        if exc is None:
            out = inner.result()
            if resolve_result(rec.outer, out):
                with self._lock:
                    if rec.hedged and rname != rec.primary:
                        self.hedge_wins += 1
            return
        if self._is_replica_death(exc):
            with self._lock:
                others_live = any(
                    n != rname and not f.done() for n, f in rec.inner.items()
                )
                if others_live or rec.failover_pending:
                    return  # a sibling attempt is still racing
                rec.failover_pending = True
                self.failovers += 1
            self._dispatch(rec)
            return
        # client-attributable: deadline, quarantine, validation,
        # execution failure after the replica's own retries — moving
        # replicas would not change the outcome
        if isinstance(exc, ServingError):
            exc.tenant = exc.tenant or rec.tenant
        resolve_exception(rec.outer, exc)

    @staticmethod
    def _is_replica_death(exc: BaseException) -> bool:
        """Infra-side failures that died *with the replica* rather than
        with the request: the attempt deserves a fresh replica."""
        if is_validation_error(exc):
            return False
        return isinstance(exc, (SchedulerClosed, ReplicaUnavailable))

    # -- membership events -------------------------------------------------

    def _on_state_change(self, member: str, old: str, new: str) -> None:
        """HeartbeatMonitor callback (fired outside the monitor lock).
        A death rescues every attempt currently riding the dead replica:
        re-dispatch now rather than waiting for an inner future that a
        wedged process may never resolve."""
        if new != DEAD or self._closed.is_set():
            return
        with self._lock:
            stale = [
                rec
                for rec in self._inflight.values()
                if rec.replica == member
                and not rec.outer.done()
                and not any(
                    n != member and not f.done() for n, f in rec.inner.items()
                )
                and not rec.failover_pending
            ]
            for rec in stale:
                rec.failover_pending = True
            self.rescued += len(stale)
            self.failovers += len(stale)
        for rec in stale:
            # the dead replica's inner future is deliberately NOT
            # cancelled: if the process was merely slow, its result may
            # still arrive first — first-wins resolution makes that a
            # free win (scores are bitwise path-independent)
            self._dispatch(rec)

    def kill_replica(self, name: str) -> None:
        """Crash one replica (chaos surface): scheduler closed,
        heartbeats stop, monitor marked dead immediately — in-flight
        work fails over via both the inner-future and the rescue path."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica {name!r}")
        replica.kill()
        self.monitor.mark(name, DEAD)

    def stall_replica(self, name: str) -> None:
        """Wedge one replica (chaos surface): heartbeats stop but its
        scheduler keeps running; the monitor's staleness thresholds
        drive suspect → dead, and the rescue path re-homes its work."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica {name!r}")
        replica.stall()

    def revive_replica(self, name: str) -> None:
        """Un-stall a wedged replica and re-admit it (a stalled replica
        never lost state, so no warm restart is needed — contrast
        :meth:`replace_replica`)."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica {name!r}")
        if replica.killed:
            raise ValueError(
                f"replica {name!r} was killed; use replace_replica"
            )
        replica.unstall()
        # a merely-suspect replica recovers through its next heartbeat
        # (counted as a flap); only a dead/unknown member needs explicit
        # re-admission — register() would silently erase the flap
        if self.monitor.state(name) in (DEAD, None):
            self.monitor.register(name)

    # -- draining + replacement --------------------------------------------

    def drain_replica(self, name: str, timeout_s: float = 5.0) -> None:
        """Decommission deliberately: mark draining (no new dispatch),
        wait for in-flight work to finish, then close and deregister.
        Raises ``TimeoutError`` if the replica cannot drain in time
        (its work is then failed over by the close)."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica {name!r}")
        self.monitor.mark(name, DRAINING)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if replica.metrics()["outstanding"] == 0:
                break
            time.sleep(0.005)
        else:
            replica.close()  # fail what is left over to the live set
            self.monitor.deregister(name)
            raise TimeoutError(f"replica {name!r} did not drain in {timeout_s}s")
        replica.close()
        self.monitor.deregister(name)
        with self._lock:
            self._replicas.pop(name, None)

    def replace_replica(self, name: str, probe_clip=None) -> WorkerReplica:
        """Warm-restart a replacement replica from the durable tenant
        manifest and admit it only after the bitwise warm-up probe.

        The replacement re-records every tenant's gratings from the
        manifest's kernel bytes (hash-verified), then serves
        ``probe_clip`` (or a deterministic synthetic clip) for every
        tenant; each score vector must be bitwise-equal to a healthy
        replica's answer before the monitor admits the member.  A
        replica that cannot reproduce the survivors' arithmetic exactly
        never takes traffic."""
        with self._lock:
            old = self._replicas.get(name)
        if old is not None and not old.killed:
            raise ValueError(
                f"replica {name!r} is still live; drain or kill it first"
            )
        if self.ckpt_dir is not None:
            specs = load_tenant_manifest(self.ckpt_dir)
        else:
            with self._lock:
                specs = dict(self._tenants)
        replica = WorkerReplica(
            name,
            self._build_server,
            self.monitor,
            heartbeat_interval_s=self._heartbeat_interval_s,
            scheduler_kwargs=self._scheduler_kwargs,
        )
        try:
            for spec in specs.values():
                replica.server.add_tenant(
                    spec.name,
                    spec.kernels,
                    fidelity=spec.fidelity,
                    slm=spec.slm,
                    atoms=spec.atoms,
                )
            self._admission_probe(replica, specs, probe_clip)
        except BaseException:
            replica.close()
            raise
        with self._lock:
            self._replicas[name] = replica
        # registration is last: the replica takes traffic only after the
        # bitwise probe passed
        self.monitor.register(name)
        return replica

    def _admission_probe(
        self,
        candidate: WorkerReplica,
        specs: dict[str, _TenantSpec],
        probe_clip=None,
    ) -> None:
        healthy_name = next(
            (n for n in self.monitor.members(HEALTHY) if n != candidate.name),
            None,
        )
        if healthy_name is None:
            raise ReplicaUnavailable(
                "no healthy replica to probe the replacement against",
                replica=candidate.name,
            )
        with self._lock:
            reference = self._replicas[healthy_name]
        for spec in specs.values():
            clip = probe_clip
            if clip is None:
                # deterministic synthetic probe, seeded from the tenant's
                # kernel hash so every admission for this tenant replays
                # the identical clip: (B, C, H, W, T) like live queries
                cfg = candidate.server.cfg
                t = 2 * cfg.window_frames
                rng = np.random.default_rng(
                    int(kernel_hash(spec.kernels)[:8], 16)
                )
                clip = rng.random(
                    (1, 1, *candidate.server.frame_hw, t)
                ).astype(np.float32)
            want = reference.submit(spec.name, clip, block=True).result()
            got = candidate.submit(spec.name, clip, block=True).result()
            if not np.array_equal(
                np.asarray(want["scores"]), np.asarray(got["scores"])
            ):
                raise ValueError(
                    f"admission probe failed for tenant {spec.name!r}: "
                    f"replacement replica {candidate.name!r} scores are not "
                    f"bitwise-equal to healthy replica {healthy_name!r}"
                )

    # -- hedging + polling -------------------------------------------------

    def _hedge_delay(self) -> float | None:
        if not self.hedge.enabled:
            return None
        with self._lock:
            lats = sorted(self._latencies)
        if len(lats) < self.hedge.min_samples:
            return self.hedge.cold_delay_s
        p99 = lats[min(int(0.99 * len(lats)), len(lats) - 1)]
        return max(self.hedge.min_delay_s, self.hedge.multiplier * p99)

    def _scan_for_hedges(self) -> None:
        delay = self._hedge_delay()
        if delay is None:
            return
        now = time.time()
        with self._lock:
            due = [
                rec
                for rec in self._inflight.values()
                if not rec.hedged
                and not rec.outer.done()
                and rec.replica is not None
                and now - rec.t_submit >= delay
                # the RetryPolicy truncation rule applied to hedges: a
                # duplicate past the remaining budget only burns work
                and (rec.deadline is None or now < rec.deadline)
            ]
            for rec in due:
                rec.hedged = True
            self.hedges += len(due)
        for rec in due:
            self._dispatch(rec)

    def _poll_loop(self) -> None:
        while not self._closed.wait(self.poll_interval_s):
            try:
                self.monitor.poll()
                self._scan_for_hedges()
            except Exception:  # noqa: BLE001 — the poller must survive
                pass

    # -- lifecycle / observability ----------------------------------------

    def close(self) -> None:
        """Shut the set down; every still-inflight outer future resolves
        with ``SchedulerClosed`` (futures are never abandoned)."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._poller.join()
        with self._lock:
            replicas = list(self._replicas.values())
            recs = list(self._inflight.values())
        for replica in replicas:
            replica.close()
        for rec in recs:
            resolve_exception(
                rec.outer,
                SchedulerClosed("replica set closed", tenant=rec.tenant),
            )

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def lost_futures(self) -> int:
        """Outer futures neither resolved nor tracked — the invariant
        the chaos storm gates at zero.  (Inflight-but-live requests are
        not lost; this counts records whose every inner attempt is done
        yet the outer future still pends and no failover is pending.)"""
        with self._lock:
            lost = 0
            for rec in self._inflight.values():
                if rec.outer.done() or rec.failover_pending:
                    continue
                if rec.inner and all(f.done() for f in rec.inner.values()):
                    lost += 1
            return lost

    def metrics(self) -> dict:
        with self._lock:
            lats = sorted(self._latencies)
            out = {
                "replicas": sorted(self._replicas),
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "inflight": len(self._inflight),
                "failovers": self.failovers,
                "rescued": self.rescued,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "unroutable": self.unroutable,
            }
        out["states"] = self.monitor.states()
        out["flaps"] = self.monitor.flaps
        out["deaths"] = self.monitor.deaths
        out["lost_futures"] = self.lost_futures()
        for name, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            out[f"latency_{name}_ms"] = (
                1e3 * lats[min(int(q * len(lats)), len(lats) - 1)] if lats else 0.0
            )
        return out
