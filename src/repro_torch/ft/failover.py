"""Checkpoint/restart supervisor, counterpart of ``repro.ft.failover``.

Runs the user's step function; on failure restores the latest checkpoint
(``repro_torch.checkpoint``) and resumes, optionally through an
``on_restore`` hook (resharding after an exclusion).  Step-indexed batches
make a resumed run reproduce the trajectory of one that never failed.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore

log = logging.getLogger("repro_torch.ft")


@dataclass
class TrainSupervisor:
    step_fn: Callable[[Any, dict], tuple[Any, dict]]
    make_batch: Callable[[int], dict]
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    on_restore: Callable[[Any, int], Any] | None = None  # resharding hook
    history: list[dict] = field(default_factory=list)

    def run(self, state: Any, n_steps: int, start_step: int = 0) -> tuple[Any, int]:
        ckpt = Checkpointer(self.ckpt_dir)
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                batch = self.make_batch(step)
                state, metrics = self.step_fn(state, batch)
                self.history.append({"step": step, **{
                    k: float(v) for k, v in metrics.items()
                    if hasattr(v, "ndim") and v.ndim == 0
                }})
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    ckpt.save_async(state, step)
            except Exception as e:  # noqa: BLE001 (injected device failures)
                restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e, restarts)
                if restarts > self.max_restarts:
                    raise
                # drain (not wait): a background save error here must not
                # mask the step failure we are recovering from — log it and
                # continue to the restore attempt
                bg = ckpt.drain()
                if bg is not None:
                    log.warning("background checkpoint save failed (%s); "
                                "restoring from the previous one", bg)
                last = latest_step(self.ckpt_dir)
                if last is None:
                    raise
                state, _ = restore(self.ckpt_dir, state)
                step = last
                # drop history rows past the restored step — the replayed
                # steps re-append them; keeping both double-counts
                self.history = [h for h in self.history if h["step"] < last]
                if self.on_restore is not None:
                    state = self.on_restore(state, step)
        ckpt.wait()
        return state, step
