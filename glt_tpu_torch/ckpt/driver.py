"""Checkpoint driver: ``save``/``resume`` + a resumable loop (cf.
``glt_tpu/ckpt/driver.py``).

Two layers:

* :class:`Checkpointer` — policy (cadence, retention) over the atomic
  store: ``save(step, components)`` snapshots any mix of objects
  implementing ``state_dict()`` and pre-captured dicts; ``resume()``
  loads the newest intact checkpoint (falling back past a corrupt one)
  and pushes state into objects implementing ``load_state_dict``.
* :class:`TrainLoop` — a preemption-safe multi-epoch driver over the
  scanned train step (:func:`~glt_tpu_torch.models.train.
  make_scanned_node_train_step`): the loop cursor is ``(epoch, block)``,
  the epoch's shuffle rng is captured *before* the permutation draw, and
  every save lands at a block boundary — so a process SIGKILLed at any
  point resumes from its last checkpoint with the **remaining batch
  stream identical** and, on the CPU, the losses and parameters
  bit-identical to an uninterrupted run.  On the card the sampled ids,
  keys and cursors are identical, and the losses agree to the node
  step's tolerance: ``index_add_`` sums floats by atomics, in an order
  that changes from run to run.

A restore overwrites the model's parameters in place and gives the
optimizer new state tensors, so a scanned step's captured CUDA graph
(which reads the old ones) is captured again: the first block after a
resume runs eagerly, the next captures, and ``compilewatch`` counts one
capture per block pattern.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional

import numpy as np

from .. import random as trandom
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from . import state as _state
from . import store as _store
from .store import CheckpointCorruptError, CheckpointError

_M_SAVES = _metrics.counter(
    "glt.ckpt.saves", "checkpoints published (atomic dir renames)")
_M_RESUMES = _metrics.counter(
    "glt.ckpt.resumes", "runs resumed from a checkpoint")
_M_SAVE_MS = _metrics.histogram(
    "glt.ckpt.save_ms", "wall per checkpoint save (capture + publish)")
_M_RESUME_MS = _metrics.histogram(
    "glt.ckpt.resume_ms", "wall per resume (read + verify + restore)")


class Snapshot(NamedTuple):
    """One loaded checkpoint: the step it was taken at, the raw captured
    component dicts, and the manifest extras (e.g. an exit reason)."""
    step: int
    components: Dict[str, Any]
    extras: Dict[str, Any]


def _capture(value: Any) -> Any:
    """Normalize one component for the store: ``state_dict()`` objects
    are snapshotted; captured dicts/arrays pass through."""
    sd = getattr(value, "state_dict", None)
    if callable(sd):
        return sd()
    return value


class Checkpointer:
    """Cadenced, retained checkpoints under one root directory.

    Args:
      root: checkpoint directory (created on first save).
      every_n_steps: ``due(step)`` cadence; 0 disables cadenced saves
        (explicit ``save`` calls still work — e.g. the supervisor's
        emergency save).
      keep: retained step count (older dirs pruned after each save).
    """

    def __init__(self, root: str, every_n_steps: int = 0, keep: int = 2):
        self.root = str(root)
        self.every_n_steps = int(every_n_steps)
        self.keep = max(1, int(keep))

    def due(self, step: int) -> bool:
        return self.every_n_steps > 0 and step > 0 \
            and step % self.every_n_steps == 0

    def latest_step(self) -> Optional[int]:
        return _store.latest_step(self.root)

    def save(self, step: int, components: Mapping[str, Any],
             extras: Optional[Dict[str, Any]] = None) -> str:
        """Capture + atomically publish one checkpoint; returns its dir."""
        t0 = time.perf_counter()
        with _span("ckpt.save", step=int(step)):
            captured = {name: _capture(v) for name, v in components.items()}
            path = _store.write_checkpoint(self.root, int(step), captured,
                                           extras=extras)
            _store.prune(self.root, self.keep)
        _M_SAVES.inc()
        _M_SAVE_MS.observe((time.perf_counter() - t0) * 1e3)
        _flight.record("ckpt.save", step=int(step), path=str(path))
        return path

    def resume(self, components: Mapping[str, Any] = (),
               step: Optional[int] = None) -> Optional[Snapshot]:
        """Load the newest intact checkpoint (or ``step``); None if none.

        Objects in ``components`` implementing ``load_state_dict``
        receive their captured dict; everything is also returned raw in
        the :class:`Snapshot` so functional states (pytrees, rng) can be
        restored by the caller.  A corrupt newest checkpoint (torn disk)
        is skipped with a fallback to the previous retained step.
        """
        t0 = time.perf_counter()
        with _span("ckpt.resume"):
            snap = self._read_newest_intact(step)
            if snap is None:
                return None
            for name, obj in dict(components).items():
                loader = getattr(obj, "load_state_dict", None)
                if callable(loader) and name in snap.components:
                    loader(snap.components[name])
        _M_RESUMES.inc()
        _M_RESUME_MS.observe((time.perf_counter() - t0) * 1e3)
        _flight.record("ckpt.resume", step=int(snap.step))
        return snap

    def _read_newest_intact(self, step: Optional[int]) -> Optional[Snapshot]:
        if step is not None:
            s, comps, extras = _store.read_checkpoint(self.root, step)
            return Snapshot(s, comps, extras)
        candidates = _store.list_steps(self.root)
        if not candidates:
            return None
        for s in reversed(candidates):
            try:
                got, comps, extras = _store.read_checkpoint(self.root, s)
                return Snapshot(got, comps, extras)
            except CheckpointCorruptError:
                continue    # torn on disk: fall back one retained step
        raise CheckpointError(
            f"every retained checkpoint under {self.root!r} is corrupt")


class TrainLoop:
    """Preemption-safe multi-epoch driver over a scanned train step (node
    or hetero).

    One *step* of the loop is one scanned block (``group`` batches).  The
    global step counter, losses, and checkpoint cadence all count blocks.

    Bit-identical resume rests on three invariants:

    1. the epoch's shuffle rng is captured **before** the permutation is
       drawn, so a resumed epoch regenerates the identical seed blocks;
    2. per-block threefry keys derive by ``fold_in(fold_in(base_key,
       epoch), block)`` — pure functions of the cursor;
    3. saves land **after** a block completes (the epoch driver waits
       for the card first), capturing the post-block ``TrainState``
       exactly (device -> host -> device round trips are bit-exact).

    Args:
      step: a ``step(state, seeds_blk, key)`` scanned train step.
      state: initial :class:`~glt_tpu_torch.models.train.TrainState`;
        a restore writes into its model and optimizer.
      rng: the seed-shuffle ``np.random.Generator`` (captured/restored).
      checkpointer: optional :class:`Checkpointer`; ``every_n_steps``
        gives the cadence.  ``extra_components`` (name -> object with
        ``state_dict``/``load_state_dict``, e.g. a loader) ride along
        in every save.
      supervisor: optional
        :class:`~glt_tpu_torch.distributed.supervisor.Supervisor`;
        checked at every block boundary: a dead peer triggers an
        emergency checkpoint, a trace flush and a structured
        :class:`~glt_tpu_torch.distributed.supervisor.SupervisedExit`.
      fault_plan: optional
        :class:`~glt_tpu_torch.testing.faults.FaultPlan`;
        its ``on_train_step`` hook fires after each block (and after any
        due save), giving the chaos suite counter-exact SIGKILL points.
    """

    def __init__(self, step: Callable, state: Any, train_idx, batch_size: int,
                 group: int, epochs: int, rng: np.random.Generator,
                 base_key, checkpointer: Optional[Checkpointer] = None,
                 extra_components: Optional[Mapping[str, Any]] = None,
                 supervisor=None, fault_plan=None):
        self.step = step
        self.state = state
        self.train_idx = np.asarray(train_idx)
        self.batch_size = int(batch_size)
        self.group = int(group)
        self.epochs = int(epochs)
        self.rng = rng
        self.base_key = base_key
        self.checkpointer = checkpointer
        self.extra = dict(extra_components or {})
        self.supervisor = supervisor
        self.fault_plan = fault_plan
        self.global_step = 0          # completed blocks across epochs
        self.epoch = 0
        self.next_block = 0
        self.losses: List[float] = []  # per-batch, from resume point on
        self.start_step = 0            # global step the losses start at

    # -- state-capture protocol ------------------------------------------
    def _loop_state(self, rng_at_epoch_start: Dict[str, Any],
                    epoch: int, next_block: int) -> Dict[str, Any]:
        return {
            "epoch": int(epoch),
            "next_block": int(next_block),
            "global_step": int(self.global_step),
            "rng_at_epoch_start": rng_at_epoch_start,
            "base_key": _state.capture_key(self.base_key),
        }

    def _components(self, rng_at_epoch_start, epoch, next_block
                    ) -> Dict[str, Any]:
        comps = {
            "train_state": _state.capture_train_state(self.state),
            "loop": self._loop_state(rng_at_epoch_start, epoch, next_block),
        }
        cache = self._live_cache()
        if cache is not None:
            # The cross-block device feature cache is semantics-preserving
            # (x stays bit-identical with or without it), but capturing
            # it keeps a resumed run's cache warm AND its hit-rate
            # stats/insert cursor deterministic vs the uninterrupted run.
            comps["feature_cache"] = _state.capture_pytree(cache)
        for name, obj in self.extra.items():
            comps[name] = _capture(obj)
        return comps

    def _live_cache(self):
        getter = getattr(self.step, "feature_cache", None)
        return getter() if callable(getter) else None

    def _restore(self, snap: Snapshot) -> None:
        loop = snap.components["loop"]
        self.state = _state.restore_train_state(
            snap.components["train_state"], like=self.state)
        self.base_key = _state.restore_key(loop["base_key"],
                                           device=self.base_key.device)
        # Rewind the stream to the interrupted epoch's start; the
        # permutation redraw below regenerates its exact seed blocks.
        _state.load_rng(self.rng, loop["rng_at_epoch_start"])
        self.epoch = int(loop["epoch"])
        self.next_block = int(loop["next_block"])
        self.global_step = int(loop["global_step"])
        self.start_step = self.global_step
        cache = self._live_cache()
        if cache is not None and "feature_cache" in snap.components:
            setter = getattr(self.step, "set_feature_cache", None)
            if callable(setter):
                setter(_state.restore_pytree(
                    snap.components["feature_cache"], like=cache))
        for name, obj in self.extra.items():
            loader = getattr(obj, "load_state_dict", None)
            if callable(loader) and name in snap.components:
                loader(snap.components[name])

    def resume(self) -> Optional[Snapshot]:
        """Restore from the newest intact checkpoint (None = fresh run)."""
        if self.checkpointer is None:
            return None
        snap = self.checkpointer.resume()
        if snap is not None:
            self._restore(snap)
        return snap

    # -- the loop ---------------------------------------------------------
    def run(self) -> Any:
        """Run (or continue) to completion; returns the final TrainState.

        Per-batch losses from the resume point on accumulate in
        ``self.losses`` (host floats, fetched once per epoch).
        """
        from ..models.train import run_scanned_epoch

        while self.epoch < self.epochs:
            e = self.epoch
            rng_at_epoch_start = _state.capture_rng(self.rng)
            key_e = trandom.fold_in(self.base_key, e)
            start_block = self.next_block

            def on_block(state_now, block_idx, _e=e,
                         _rng0=rng_at_epoch_start):
                self.state = state_now
                self.global_step += 1
                if self.checkpointer is not None \
                        and self.checkpointer.due(self.global_step):
                    self.checkpointer.save(
                        self.global_step,
                        self._components(_rng0, _e, block_idx + 1))
                if self.fault_plan is not None:
                    self.fault_plan.on_train_step()
                if self.supervisor is not None:
                    self._check_supervisor(_rng0, _e, block_idx + 1)

            self.state, losses, _accs, _ovf = run_scanned_epoch(
                self.step, self.state, self.train_idx, self.batch_size,
                self.group, self.rng, key_e, start_block=start_block,
                on_block=on_block)
            self.losses.extend(float(x) for x in np.asarray(losses))
            self.epoch += 1
            self.next_block = 0
        return self.state

    def _check_supervisor(self, rng0, epoch: int, next_block: int) -> None:
        """At a block boundary: on a dead peer, save the cursor of the
        NEXT block, flush the traces and the flight ring, and raise
        :class:`~glt_tpu_torch.distributed.supervisor.SupervisedExit`
        with the reason and the checkpoint's path."""
        from ..distributed.supervisor import SupervisedExit

        try:
            self.supervisor.raise_if_dead()
        except Exception as err:
            reason = getattr(err, "report", {"reason": "peer_dead",
                                             "detail": str(err)})
            path = None
            if self.checkpointer is not None:
                path = self.checkpointer.save(
                    self.global_step,
                    self._components(rng0, epoch, next_block),
                    extras={"exit_reason": reason})
            from ..obs import trace as _trace

            _trace.flush_exports(reason=reason.get("reason"))
            _flight.record("train.supervised_exit",
                           reason=reason.get("reason"),
                           step=self.global_step,
                           checkpoint_path=path)
            fpath = _flight.dump_now(
                "supervised_exit:%s" % reason.get("reason"))
            if fpath:
                reason = dict(reason)
                reason["flight_dump"] = fpath
            raise SupervisedExit(reason, step=self.global_step,
                                 checkpoint_path=path) from err
