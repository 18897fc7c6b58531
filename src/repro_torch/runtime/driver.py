"""Fault-tolerant training driver: restart loop + watchdog + checkpointing.

The driver owns everything a pod-scale job needs around the compiled step:

  * periodic async checkpoints (atomic, keep-k),
  * a restart loop: any step exception (device failure surfaces as one) or
    watchdog deadline restores the latest checkpoint and continues —
    `max_restarts` bounds flapping,
  * straggler monitoring (robust z-score on step times),
  * stateless data: batch(step) is a pure function, so restarts replay
    identical data (bit-identical loss curves across failures — tested),
  * failure injection hooks for testing (``fail_at`` raises mid-run),
  * transfer-engine lifecycle for the streamed-optimizer path: the driver
    owns the ``TransferEngine`` passed to it, logs its per-run stream stats
    (including per-tier disk counters), and closes it when the run
    completes (or finally fails) — followed by the ``DiskHost`` spill
    store, so no in-flight disk fetch outlives its chunk files.

The JAX package's ``runtime/driver.py``: a restart restores into the
structure of ``template()`` (the launcher passes the state on the meta
device, the counterpart of ``jax.eval_shape(init_state)``); the restored
leaves are host numpy, which the step places (under a mesh, at the plan's
layouts).  Every rank of a process group runs the same loop; rank 0 writes
the checkpoints.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.driver")

Pytree = Any


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep: int = 3
    max_restarts: int = 3
    step_deadline_s: Optional[float] = None
    log_every: int = 10


class TrainDriver:
    """Runs ``state = step_fn(state, batch(step))`` with fault tolerance.

    ``state`` is any pytree (params+opt); ``step_fn`` returns
    ``(state, metrics)``.
    """

    def __init__(
        self,
        cfg: DriverConfig,
        step_fn: Callable[[Pytree, Pytree], tuple[Pytree, dict]],
        make_batch: Callable[[int], Pytree],
        init_state: Callable[[], Pytree],
        *,
        fail_at: Optional[set[int]] = None,  # test hook: raise at these steps
        engine: Optional[Any] = None,  # repro_torch.core.engine.TransferEngine
        stream_stats: Optional[Any] = None,  # repro_torch.core.hoststream.StreamStats
        spill_store: Optional[Any] = None,  # repro_torch.core.spillstore.SpillStore
        run_meta: Optional[dict] = None,  # mesh fingerprint etc. → checkpoint
        on_restart: Optional[Callable[[int], None]] = None,  # restart hook
        template: Optional[Callable[[], Pytree]] = None,  # restore structure
    ) -> None:
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.init_state = init_state
        #: the state's structure for restore (default: ``init_state`` itself,
        #: which allocates; the launcher passes a meta-device template)
        self.template = template or init_state
        self.fail_at = set(fail_at or ())
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
        self.monitor = StragglerMonitor(
            deadline_s=cfg.step_deadline_s, on_event=self._on_straggler
        )
        self.history: list[dict] = []
        self.restarts = 0  # cumulative — never decays (observability)
        #: consecutive healthy steps since the last failure — at
        #: ``checkpoint_every`` of them the restart *budget* resets
        #: (``_forgiven`` catches up to ``restarts``), so a long-lived job
        #: survives more than ``max_restarts`` isolated faults while
        #: genuine crash loops still trip the budget
        self._healthy = 0
        self._forgiven = 0
        #: run identity saved into every checkpoint's ``extra`` metadata
        #: (mesh fingerprint, param kind, weight grouping) — the resume
        #: path reads it back to detect an elastic re-mesh
        self.run_meta = run_meta
        self.on_restart = on_restart
        #: transfer engine whose lifecycle this driver owns (closed when the
        #: run finishes or finally fails) — the streamed-optimizer path
        self.engine = engine
        self.stream_stats = stream_stats
        #: DiskHost-tier spill store this driver owns (closed after the
        #: engine so no in-flight disk fetch outlives its chunk files)
        self.spill_store = spill_store

    # ------------------------------------------------------------------ run
    def _on_straggler(self, ev) -> None:
        """A straggling step means the compute side stalled — widen the
        transfer engine's prefetch window so the stream keeps more groups
        in flight and the recovery step is not also transfer-bound."""
        if self.engine is not None and hasattr(self.engine, "widen"):
            widened = self.engine.widen()
            log.info(
                "straggler at step %d (%.3fs, z=%.1f): widened prefetch "
                "distances to %s",
                ev.step, ev.duration_s, ev.z, widened,
            )

    def _restore_or_init(self) -> tuple[int, Pytree]:
        # an async save may still be writing when a step fails: let it commit
        # (or surface its error) before looking for the latest step, so a
        # restart restores the newest checkpoint the run reached
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, self.init_state()
        if self.run_meta and self.run_meta.get("mesh"):
            saved = (self.ckpt.load_meta(latest).get("extra") or {}).get("mesh")
            if saved and saved != self.run_meta["mesh"]:
                log.warning(
                    "elastic re-mesh: checkpoint step %d written on mesh %s, "
                    "restoring onto %s",
                    latest, saved, self.run_meta["mesh"],
                )
        step, state = self.ckpt.restore(self.template())
        log.info("restored checkpoint at step %d", step)
        return step + 1, state

    def run(self) -> Pytree:
        try:
            while True:
                try:
                    return self._run_once()
                except Exception as e:  # noqa: BLE001 — the restart loop
                    self.restarts += 1
                    self._healthy = 0
                    log.warning(
                        "step failure (%s); restart %d/%d",
                        e,
                        self.restarts - self._forgiven,
                        self.cfg.max_restarts,
                    )
                    if self.restarts - self._forgiven > self.cfg.max_restarts:
                        raise
                    # a failed step may leave writebacks queued for state
                    # that restore is about to replace — drop them so the
                    # drain after restart only sees post-restore tickets
                    if self.engine is not None and hasattr(
                        self.engine, "discard_writebacks"
                    ):
                        self.engine.discard_writebacks()
                    if self.run_meta and self.run_meta.get("mesh"):
                        from repro_torch.runtime import elastic

                        # raises RemeshRequired when the device count moved
                        elastic.check_restart_mesh(self.run_meta["mesh"])
                    if self.on_restart is not None:
                        self.on_restart(self.restarts)
        finally:
            if self.stream_stats is not None and self.stream_stats.n_groups:
                s = self.stream_stats
                log.info(
                    "transfer engine: %d groups, %.2f req/group, "
                    "wait %.3fs, writeback drain %.3fs, final distance %s",
                    s.n_groups,
                    s.requests_per_group,
                    s.transfer_wait_s,
                    s.writeback_drain_s,
                    s.distance_trace[-1] if s.distance_trace else None,
                )
                if s.cache_hits or s.cache_misses:
                    log.info(
                        "weight residency: %d unique group fetches, "
                        "%d cache hits / %d misses",
                        s.unique_group_fetches,
                        s.cache_hits,
                        s.cache_misses,
                    )
                if s.disk_requests:
                    log.info(
                        "disk tier: %d requests (%.2f/group), %.1f MB, "
                        "h2d-on-disk wait %.3fs",
                        s.disk_requests,
                        s.disk_requests_per_group,
                        s.bytes_disk / 1e6,
                        s.disk_wait_s,
                    )
            if self.engine is not None:
                self.engine.close()
            if self.spill_store is not None:
                self.spill_store.close()

    def _run_once(self) -> Pytree:
        start, state = self._restore_or_init()
        for step in range(start, self.cfg.total_steps):
            self.monitor.start_step(step)
            if step in self.fail_at:
                self.fail_at.discard(step)  # fail once, then recover
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.make_batch(step)
            state, metrics = self.step_fn(state, batch)
            if self.monitor.check_deadline():
                raise TimeoutError(f"step {step} blew deadline (straggler/hang)")
            ev = self.monitor.end_step()
            if ev:
                log.warning("straggler: step %d took %.3fs (z=%.1f)", ev.step, ev.duration_s, ev.z)
            row = {"step": step, **{k: _to_float(v) for k, v in metrics.items()}}
            self.history.append(row)
            self._healthy += 1
            if (
                self.restarts > self._forgiven
                and self.cfg.checkpoint_every
                and self._healthy >= self.cfg.checkpoint_every
            ):
                log.info(
                    "%d healthy steps since last failure: restart budget "
                    "reset (was %d/%d)",
                    self._healthy,
                    self.restarts - self._forgiven,
                    self.cfg.max_restarts,
                )
                self._forgiven = self.restarts
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                log.info("step %d: %s", step, row)
            # the last step's checkpoint is the blocking one below: saving it
            # here too would write the same step twice
            if (self.cfg.checkpoint_every and (step + 1) % self.cfg.checkpoint_every == 0
                    and step + 1 < self.cfg.total_steps):
                self.ckpt.save(step, state, extra_meta=self.run_meta)
        self.ckpt.save(
            self.cfg.total_steps - 1, state, blocking=True, extra_meta=self.run_meta
        )
        return state


def _to_float(v: Any) -> float:
    try:
        return float(v)
    except Exception:  # noqa: BLE001
        return float("nan")
