"""MegaFBD virtual/physical rank mapping + heterogeneous placement (§4.2).

Virtual ranks follow Megatron's allocation rules — forward and backward
instances have the *same* virtual world size, so model partitioning logic is
untouched.  Physical ranks are the devices; several virtual ranks (threads)
may share a device.  The planner maps forward-instance ranks onto weaker
devices (forward is the lighter phase: ~1/3 of the FLOPs) and backward ranks
onto the fastest, then the simkit engine scores the placement against
co-located execution.

A copy of ``repro.core.fbd.ranks`` on the port's own simkit engine.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.simkit.engine import Engine, FaultModel, Task


@dataclass(frozen=True)
class VirtualPhysicalMap:
    n_virtual: int                       # per instance (fwd == bwd)
    fwd_device: tuple[int, ...]          # virtual rank -> physical device
    bwd_device: tuple[int, ...]

    def control_thread(self, device: int) -> int:
        return device  # one control thread per physical device

    def threads_on(self, device: int) -> list[tuple[str, int]]:
        out = []
        for v, d in enumerate(self.fwd_device):
            if d == device:
                out.append(("F", v))
        for v, d in enumerate(self.bwd_device):
            if d == device:
                out.append(("B", v))
        return out


@dataclass
class FBDPlacement:
    mapping: VirtualPhysicalMap
    device_speed: dict[int, float]
    est_makespan: float = 0.0


def _assign_balanced(
    n_virtual: int, devs: list[int], speed: dict[int, float]
) -> tuple[int, ...]:
    """Greedy LPT: each virtual rank goes to the device with the least
    projected load (1/speed per thread)."""
    load = {d: 0.0 for d in devs}
    out = []
    for _ in range(n_virtual):
        d = min(devs, key=lambda dd: (load[dd] + 1.0 / speed[dd], dd))
        load[d] += 1.0 / speed[d]
        out.append(d)
    return tuple(out)


def plan_placement(
    n_virtual: int,
    device_speed: dict[int, float],
    *,
    fwd_cost: float = 1.0,
    bwd_cost: float = 2.0,
) -> FBDPlacement:
    """Split devices into a forward set (weakest first) and a backward set so
    the phase makespans balance by *capacity* (sum of speeds), then spread
    virtual ranks within each set greedily."""
    devs = sorted(device_speed, key=lambda d: (device_speed[d], d))
    best: tuple[float, int] | None = None
    for k in range(1, len(devs)):
        cap_f = sum(device_speed[d] for d in devs[:k])
        cap_b = sum(device_speed[d] for d in devs[k:])
        t = max(fwd_cost / cap_f, bwd_cost / cap_b)
        if best is None or t < best[0]:
            best = (t, k)
    k = best[1] if best is not None else max(1, len(devs) // 3)
    fwd_devs, bwd_devs = devs[:k], devs[k:] or devs
    return FBDPlacement(
        VirtualPhysicalMap(
            n_virtual,
            _assign_balanced(n_virtual, fwd_devs, device_speed),
            _assign_balanced(n_virtual, bwd_devs, device_speed),
        ),
        dict(device_speed),
    )


def colocated_placement(n_virtual: int, device_speed: dict[int, float]) -> FBDPlacement:
    devs = sorted(device_speed)
    m = tuple(devs[v % len(devs)] for v in range(n_virtual))
    return FBDPlacement(VirtualPhysicalMap(n_virtual, m, m), dict(device_speed))


def evaluate_placement(
    pl: FBDPlacement,
    *,
    n_micro: int = 8,
    fwd_time: float = 1e-3,
    bwd_time: float = 2e-3,
    act_bytes: int = 16 << 20,
    link_bandwidth: float = 50e9,
) -> float:
    """Makespan of one iteration under the placement: per microbatch, each
    virtual rank runs F (on its fwd device), ships the saved activations to
    its bwd device (free if co-located), then runs B."""
    order: dict[int, list[Task]] = {d: [] for d in pl.device_speed}
    for v in range(pl.mapping.n_virtual):
        fd = pl.mapping.fwd_device[v]
        bd = pl.mapping.bwd_device[v]
        for m in range(n_micro):
            f_id = f"F_v{v}_m{m}"
            order[fd].append(Task(
                tid=f_id, rank=fd, duration=fwd_time, kind="compute",
                meta={"mb": m, "op": "fwd", "vrank": v},
            ))
            b_dep: tuple[str, ...] = (f_id,)
            if fd != bd:
                x_id = f"X_v{v}_m{m}"
                order[fd].append(Task(
                    tid=x_id, rank=fd, bytes=act_bytes, kind="send",
                    deps=(f_id,), peer=bd, blocking=False,
                    meta={"mb": m, "vrank": v},
                ))
                b_dep = (x_id,)
            order[bd].append(Task(
                tid=f"B_v{v}_m{m}", rank=bd, duration=bwd_time, kind="compute",
                deps=b_dep, meta={"mb": m, "op": "bwd", "vrank": v},
            ))
    faults = FaultModel(compute_slowdown=dict(pl.device_speed))
    eng = Engine(faults=faults, link_bandwidth=link_bandwidth, link_concurrency=4)
    res = eng.run(order)
    pl.est_makespan = res.makespan
    return res.makespan
