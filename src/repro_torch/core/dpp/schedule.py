"""MegaDPP traversal orders over the (model_chunk x microbatch) task matrix,
copied from ``repro.core.dpp.schedule``.

The paper's two poles (§5.2, Fig. 3):

* DFC (depth-first): advance the *same* microbatch through chunks — backward
  starts earlier, activations release sooner, lower memory peak;
* BFC (breadth-first): advance *many* microbatches through the same chunk —
  chunk-level gradients complete earlier and send deadlines relax, at the
  price of a larger activation stash.

``sched_wave`` generalizes both: microbatches move in waves of ``w``
(w=1 -> DFC, w=n_micro -> BFC), which is the knob the best-effort planner
tunes under a memory cap.
"""

from __future__ import annotations

from repro_torch.core.simkit.workload import Step, sched_bfc, sched_dfc, sched_1f1b


def sched_wave(n_micro: int, n_chunks: int, wave: int) -> list[Step]:
    """Wave-parametrized traversal: forward waves of `wave` microbatches per
    chunk, backward in reverse — interpolates DFC (wave=1) .. BFC (wave=n)."""
    wave = max(1, min(wave, n_micro))
    steps: list[Step] = []
    for w0 in range(0, n_micro, wave):
        ms = range(w0, min(w0 + wave, n_micro))
        for c in range(n_chunks):
            for m in ms:
                steps.append(("F", m, c))
        for c in reversed(range(n_chunks)):
            for m in ms:
                steps.append(("B", m, c))
    return steps


def sched_zb_split(n_micro: int, n_chunks: int, pp: int, stage: int) -> list[Step]:
    """ZB-inspired schedule (Qi et al., cited by the paper §2.3.2): backward
    is split into activation-grad ("B") and weight-grad ("W") halves; W work
    has no downstream consumer and fills what would otherwise be bubbles at
    the pipeline tail.  Encoded as extra ("W", m, c) steps the workload
    lowering (``build_training_step``) turns into dependency-free compute."""
    base = sched_1f1b(n_micro, n_chunks, pp, stage)
    out: list[Step] = []
    pending_w: list[Step] = []
    for kind, m, c in base:
        if kind == "B":
            out.append(("B", m, c))
            pending_w.append(("W", m, c))
            # drain one deferred W only when at least `stage` W's are queued
            # (the tail stages defer more, mirroring ZB1P's wedge shape)
            if len(pending_w) > max(pp - stage - 1, 0):
                out.append(pending_w.pop(0))
        else:
            out.append((kind, m, c))
    out.extend(pending_w)
    return out


def legalize(steps: list[Step], *, n_chunks: int) -> list[Step]:
    """Reorder a desired per-stage visit order into a dependency-legal one
    *within the stage*: F(m, c) needs F(m, c-1) done on this stage only in the
    single-stage chunk chain sense; B(m, c) needs F(m, c) and B(m, c+1).
    Greedy stable pass: repeatedly emit the first runnable step."""
    done: set[Step] = set()
    pending = list(steps)
    out: list[Step] = []

    def runnable(s: Step) -> bool:
        kind, m, c = s
        if kind == "F":
            return True
        # backward: forward must have run; deeper chunk's backward first
        if ("F", m, c) not in done:
            return False
        if c < n_chunks - 1 and ("B", m, c + 1) in pending_set:
            return False
        return True

    pending_set = set(pending)
    while pending:
        for i, s in enumerate(pending):
            if runnable(s):
                out.append(s)
                done.add(s)
                pending_set.discard(s)
                pending.pop(i)
                break
        else:
            # no runnable step — emit remaining as-is (engine will flag)
            out.extend(pending)
            break
    return out


def schedule_table(
    steps_per_stage: dict[int, list[Step]], pp: int, n_chunks: int, n_micro: int
) -> list[list[Step | None]]:
    """Pad per-stage step lists into a rectangular [T][stage] table (None =
    bubble).  Used by the executor to build static dispatch indices."""
    T = max(len(v) for v in steps_per_stage.values())
    table: list[list[Step | None]] = []
    for t in range(T):
        row = []
        for s in range(pp):
            lst = steps_per_stage[s]
            row.append(lst[t] if t < len(lst) else None)
        table.append(row)
    return table


__all__ = [
    "Step",
    "sched_dfc",
    "sched_bfc",
    "sched_1f1b",
    "sched_wave",
    "sched_zb_split",
    "legalize",
    "schedule_table",
]
