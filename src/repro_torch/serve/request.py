"""MegaServe request model: lifecycle state + per-request latency metrics.

Copied from ``repro.serve.request`` (numpy-free, framework-free).

A request moves WAITING -> RUNNING -> FINISHED.  Preemption-by-recompute
(block pool exhausted) sends a RUNNING request back to WAITING with its
already-generated tokens folded into the prompt, so a later re-admission
re-prefills the full history and greedy decoding continues token-for-token
where it left off.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class RequestStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    rid: int
    prompt: list[int]                  # token ids
    max_new: int                       # generation budget
    arrival: float = 0.0               # seconds on the server clock
    eos_id: int | None = None

    # -- mutable lifecycle state (owned by the scheduler/server) ----------
    status: RequestStatus = RequestStatus.WAITING
    generated: list[int] = field(default_factory=list)
    n_preemptions: int = 0
    # timing (server clock; None until the transition happens)
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_finished: float | None = None
    # -- speculative decoding (owned by the server's spec loop) -----------
    draft_len: int = 0                 # current per-request draft budget
    spec_idle: int = 0                 # steps since speculation shut off
    spec_miss: int = 0                 # consecutive zero-acceptance verifies
    spec_backoff: int = 1              # re-probe interval multiplier
    spec_proposed: int = 0             # draft tokens sent to verification
    spec_accepted: int = 0             # draft tokens the target accepted

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def recompute_prompt(self) -> list[int]:
        """Prompt for re-prefill after preemption: original + generated."""
        return list(self.prompt) + list(self.generated)

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.generated)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new:
            return True
        return bool(
            self.eos_id is not None
            and self.generated
            and self.generated[-1] == self.eos_id
        )

    # ------------------------------------------------------------ metrics
    @property
    def queue_wait(self) -> float | None:
        """Arrival -> first admission: the queueing share of TTFT."""
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.arrival

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def latency(self) -> float | None:
        if self.t_finished is None:
            return None
        return self.t_finished - self.arrival


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


def aggregate_metrics(requests: list[Request], wall: float) -> dict:
    """Fleet-level serving metrics over finished requests."""
    fin = [r for r in requests if r.status is RequestStatus.FINISHED]
    ttfts = [r.ttft for r in fin if r.ttft is not None]
    lats = [r.latency for r in fin if r.latency is not None]
    waits = [r.queue_wait for r in fin if r.queue_wait is not None]
    total_tokens = sum(len(r.generated) for r in fin)
    return {
        "finished": len(fin),
        "total_requests": len(requests),
        "generated_tokens": total_tokens,
        "wall_s": wall,
        "tokens_per_s": total_tokens / wall if wall > 0 else 0.0,
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
        "queue_wait_p50_s": percentile(waits, 50),
        "queue_wait_p99_s": percentile(waits, 99),
        "latency_p50_s": percentile(lats, 50),
        "latency_p99_s": percentile(lats, 99),
        "preemptions": sum(r.n_preemptions for r in requests),
    }
