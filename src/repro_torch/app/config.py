"""Typed run configuration with uniform layering, a copy of
``repro.app.config``.

A :class:`RunConfig` describes one run of one workload (``train`` / ``serve``
/ ``trace`` / ``dryrun``) plus which of the MegatronApp modules attach to
it.  Values layer, most specific last:

1. dataclass defaults (this file),
2. workload defaults (:data:`WORKLOAD_DEFAULTS`),
3. a JSON config file (``--config run.json`` — nested dicts mirror the
   section structure),
4. dotted overrides (``--set serve.spec_k=6 --set modules=scan,metrics``),
   values coerced to the target field's annotated type,
5. explicit CLI flags.

Every section and field of the JAX package's ``RunConfig`` is here with the
same defaults, so the same layering gives the same configuration.  One
field is the port's own: ``runtime.device`` (the CLI's ``--device``), the
device the workload runs on — ``cuda`` by default, ``cpu`` when asked for.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path

WORKLOADS = ("train", "serve", "trace", "dryrun")


@dataclass
class TrainSection:
    """Training-workload knobs (0 = derive from smoke/full at run time)."""

    steps: int = 100
    seq_len: int = 0               # 0 -> 128 smoke / 4096 full
    global_batch: int = 0          # 0 -> 8 smoke / 256 full
    lr: float = 3e-4
    schedule: str = "cosine"       # cosine | wsd | constant
    warmup_steps: int = 0          # 0 -> max(steps // 10, 5)
    grad_accum: int = 1
    ckpt_dir: str = ""             # "" = no checkpointing
    ckpt_every: int = 50
    log_every: int = 0             # 0 -> max(steps // 10, 1)


@dataclass
class ParallelSection:
    """Parallelization plan for the train workload (``parallel.*``).

    ``pp * dp * tp > 1`` trains in a world of that many ranks (spawned by
    ``Session``, or ``torchrun``'s): ``dp`` splits the batch, ``tp`` runs
    Megatron's split of dense GQA blocks, and ``pp > 1`` routes the block
    stack through the MegaDPP pipeline executor, each stage a process
    (on the card, or the CPU with ``--device cpu``); ``schedule`` picks the traversal
    (``1f1b``/``dfc``/``bfc``/``wave``), ``n_micro`` the microbatches a step
    (0 = 2*pp), ``n_chunks`` the virtual chunks a stage, and ``wave=0``
    with ``schedule=wave`` lets the MegaDPP planner choose the wave width
    under ``dpp.memory_cap_gib``.  ``fbd_backward`` attaches MegaFBD's
    decoupled backward to the pipelined step (at pp = 1 it changes nothing,
    as in the JAX package).  ``train.grad_accum > 1`` stacks macrobatch
    accumulation on top: each accumulation is one full pipeline pass.
    """

    dp: int = 1
    tp: int = 1
    pp: int = 1
    n_micro: int = 0               # 0 -> 2*pp*dp when pp>1
    n_chunks: int = 1
    schedule: str = "1f1b"         # 1f1b | dfc | bfc | wave
    wave: int = 0                  # 0 = planner chooses (schedule=wave)
    fbd_backward: bool = False


@dataclass
class ServeSection:
    """Serving-workload knobs (mirrors the legacy launcher flag set)."""

    continuous: bool = False       # MegaServe continuous batching vs lockstep
    batch: int = 4                 # static path: lockstep batch size
    prompt_len: int = 32           # static path: shared prompt length
    max_new: int = 16
    temperature: float = 0.0
    requests: int = 16             # continuous path: workload size
    rate: float = 100.0            # Poisson arrival rate, requests/s
    slots: int = 4
    block_size: int = 16
    num_blocks: int = 0            # 0 = size pool for zero preemption
    prompt_lens: tuple[int, ...] = (16, 32, 64, 128, 256)
    decode_path: str = "auto"      # auto | paged | gathered
    prefill_path: str = "auto"     # auto | flash | dense
    spec_decode: bool = False
    spec_k: int = 4
    drafter: str = "ngram"         # ngram | random
    chunked_prefill: bool = False  # stream long prompts chunk-by-chunk
    chunk_len: int = 0             # 0 = 2*block_size; else multiple of it
    traffic: str = "poisson"       # poisson | bursty | diurnal


@dataclass
class RouterSection:
    """MegaRoute front-end (``--replicas > 1`` or any ``--set router.*``).

    A router fronts ``replicas`` MegaServe engines, placing each arrival
    via ``policy`` (``round_robin`` / ``least_kv`` / ``jsq``) with optional
    SLO-aware admission: ``slo_ttft_s > 0`` sheds (or, with ``shed=False``,
    least-bad-admits) requests whose estimated TTFT busts the SLO.
    ``prefill_replicas = k > 0`` disaggregates: the first ``k`` replicas
    prefill only, their KV migrating to the decode tier after each first
    token.
    """

    replicas: int = 1
    policy: str = "round_robin"    # round_robin | least_kv | jsq
    prefill_replicas: int = 0      # > 0 -> disaggregated prefill/decode
    slo_ttft_s: float = 0.0        # 0 = no admission control
    shed: bool = True              # shed SLO-busting requests vs least-bad


@dataclass
class ScanSection:
    """MegaScan plugin: always-on tracing of every workload step."""

    rank: int = 0
    # sync=True wraps the step with block_until_ready so scope durations are
    # faithful (the CPU analogue of the paper's CUDA-event bracketing) at
    # the cost of serializing async dispatch; off by default so the default
    # CLI path keeps the launcher's original pipelined throughput
    sync: bool = False
    # --- online detection (OnlineDetector hook; --detect-online) ----------
    detect_online: bool = False
    detect_every: int = 8          # detection pass every N workload steps
    detect_window: int = 64        # sliding window, in steps of TraceEvents
    # re-align window clocks before each pass: required when events carry
    # real per-rank clocks (gathered multi-host traces), a pure cost on a
    # single-tracer session whose events already share one monotonic clock
    detect_align: bool = False
    # --- detect() thresholds, shared by the online hook and the offline
    # trace workload (--set scan.slow_ratio=... etc.)
    slow_ratio: float = 1.25       # stage 1: dur > ratio * DP-peer median
    candidate_frac: float = 0.25   # stage 1: slow-op fraction -> candidate
    skew_margin: float = 0.05      # stage 2: last-start gap vs span
    late_frac: float = 0.4         # stage 2: late-start fraction -> confirm
    degrade_ratio: float = 1.6     # stage 3: bw < global median / ratio


@dataclass
class ScopeSection:
    """MegaScope plugin: probe / perturbation specs as compact strings.

    ``probes``: ``"pattern[:compressor]"`` (default compressor ``stats``).
    ``perturbs``: ``"pattern:kind:amount[:layer]"``.
    """

    probes: tuple[str, ...] = ("mlp_hidden:stats",)
    perturbs: tuple[str, ...] = ()


@dataclass
class FbdSection:
    """MegaFBD plugin: heterogeneous-cluster placement model."""

    n_virtual: int = 8             # virtual ranks to place
    n_devices: int = 8             # physical devices in the speed model
    slow_frac: float = 0.5         # fraction of devices that are slow
    slow_speed: float = 0.4        # their relative speed


@dataclass
class DppSection:
    """MegaDPP plugin (``--modules dpp``): the topology its planner plans
    for and the activation budget; ``memory_cap_gib`` also caps the
    planner's wave choice for ``parallel.schedule=wave`` with ``wave=0``."""

    dp: int = 1
    pp: int = 4
    tp: int = 1
    n_micro: int = 8
    n_chunks: int = 2
    memory_cap_gib: float = 8.0


@dataclass
class ObsSection:
    """Live telemetry (the ``metrics`` plugin + per-rank event synthesis).

    ``metrics_out`` streams flat JSONL samples every ``every`` steps;
    ``prom_out`` writes a Prometheus text-format snapshot at finalize.
    ``peak_tflops`` > 0 turns the measured model-flops/s series into an MFU
    estimate.  ``rank_events`` synthesizes per-DP-rank fwd/bwd/all-reduce
    events (topology ``dp``/``pp``/``tp``) into the trace each step — what
    the online detector analyses on a single-host run — and ``slow_rank``
    >= 0 additionally *induces* a live straggler at ``slow_factor`` speed
    (simkit's ``compute_slowdown`` applied to the real loop).
    """

    metrics_out: str = ""          # JSONL time-series path ("" = off)
    prom_out: str = ""             # Prometheus text snapshot path ("" = off)
    every: int = 1                 # sample/export cadence, in steps
    peak_tflops: float = 0.0       # hardware peak for MFU (0 = no estimate)
    rank_events: bool = False      # synthesize per-rank events each step
    dp: int = 2                    # synthesized topology
    pp: int = 1
    tp: int = 1
    slow_rank: int = -1            # induce a straggler on this rank (< 0 off)
    slow_factor: float = 0.5       # its relative speed (0.5 = half)


@dataclass
class FtChaosSection:
    """Declarative chaos injection (``--set ft.chaos.*``; the JAX package's
    ``ChaosSpec``).  All defaults mean "nothing fails"."""

    crash_at_step: int = -1        # raise a real crash at this step (< 0 off)
    nan_at_step: int = -1          # poison this step's batch to a NaN loss
    slow_rank_from: int = -1       # downclock slow_rank from this step on
    slow_rank: int = 1
    slow_factor: float = 0.5       # its relative speed (0.5 = half)
    degrade_link: str = ""         # directed DP link "src-dst" ("" = healthy)
    degrade_factor: float = 0.25   # its relative bandwidth


@dataclass
class FtSection:
    """Fault-tolerance controller (the ``ft`` module plugin).

    Subscribes to the scan plugin's online ``DetectionUpdate``s, decides via
    ``MitigationPolicy`` (thresholds below), and executes: REPLAN switches
    on int8 gradient compression for a degraded DP link or re-resolves the
    MegaDPP schedule around a slow pipeline stage; EXCLUDE_RESTART rolls
    back through the Checkpointer.  The loop itself becomes supervised:
    crash -> restore-latest -> resume (bounded by ``max_restarts``), with
    in-band NaN/grad-spike guards.
    """

    max_restarts: int = 3
    backoff_s: float = 0.0         # restart backoff base (doubles per restart)
    guard_nan: bool = True         # nonfinite loss/grad -> guard_action
    guard_spike: float = 0.0       # >0: grad_norm > this x running median
    guard_action: str = "rollback"  # rollback | skip
    slow_frac_soft: float = 0.3    # policy: slow-op fraction -> REPLAN
    slow_frac_hard: float = 0.7    # policy: -> EXCLUDE_RESTART
    min_evidence: int = 8          # collective instances before acting
    chaos: FtChaosSection = field(default_factory=FtChaosSection)


@dataclass
class TraceSection:
    """Offline MegaScan workload: simulate (or load) -> align -> detect."""

    load: str = ""                 # JSONL trace to analyse ("" = simulate)
    detect: str = ""               # trace file (chrome JSON or JSONL) to
                                   # align + detect + summarize (--detect)
    dp: int = 2
    pp: int = 2
    tp: int = 2
    n_micro: int = 8
    n_iters: int = 3
    slow_rank: int = 5             # simulated ground truth
    slow_factor: float = 0.5
    out: str = ""                  # directory for trace.json + diagnosis.json


@dataclass
class RuntimeSection:
    """Cross-workload runtime plumbing (``runtime.*``).

    ``compile_cache`` names a directory for the persistent compile cache
    (``repro_torch.core.compile_cache``: the kernels' builds and the
    warm-up records of the train step and of every serving bucket).  Empty
    = no persistence.  ``device`` is the port's own.
    """

    compile_cache: str = ""        # "" = no on-disk compile cache
    # the port's own field (the JAX package has no --device): where the
    # workload runs; "cuda" raises where there is no card
    device: str = "cuda"           # cuda | cpu


@dataclass
class DryrunSection:
    """Dryrun workload: FLOP and memory estimates per (arch, shape) cell on
    the meta device (``repro_torch.launch.dryrun``).  ``multi_pod`` on or
    both and ``save_hlo`` are refused: the TPU pod meshes and the HLO text
    have no counterpart on the card."""

    shape: str = ""
    all: bool = False
    multi_pod: str = "off"         # off | on | both
    profile: str = ""
    grad_accum: int = 1
    out: str = "artifacts/dryrun"
    save_hlo: bool = False
    host_mesh: bool = False        # small host mesh instead of 16x16 (smoke)


@dataclass
class RunConfig:
    """One workload run: arch + mesh + module toggles + per-section knobs."""

    workload: str = "train"
    arch: str = ""
    smoke: bool = False
    seed: int = 0
    modules: tuple[str, ...] = ("scan",)
    mesh: str = "auto"             # auto | auto-mp | host | pod1 | pod2
    trace_out: str = ""            # chrome-trace export path (any workload)
    parallel: ParallelSection = field(default_factory=ParallelSection)
    train: TrainSection = field(default_factory=TrainSection)
    serve: ServeSection = field(default_factory=ServeSection)
    router: RouterSection = field(default_factory=RouterSection)
    scan: ScanSection = field(default_factory=ScanSection)
    obs: ObsSection = field(default_factory=ObsSection)
    ft: FtSection = field(default_factory=FtSection)
    scope: ScopeSection = field(default_factory=ScopeSection)
    fbd: FbdSection = field(default_factory=FbdSection)
    dpp: DppSection = field(default_factory=DppSection)
    trace: TraceSection = field(default_factory=TraceSection)
    dryrun: DryrunSection = field(default_factory=DryrunSection)
    runtime: RuntimeSection = field(default_factory=RuntimeSection)

    @classmethod
    def for_workload(cls, workload: str, **top) -> "RunConfig":
        """Defaults + workload defaults + keyword top-level fields."""
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; one of {WORKLOADS}")
        cfg = cls(workload=workload)
        for path, value in WORKLOAD_DEFAULTS.get(workload, {}).items():
            set_by_path(cfg, path, value)
        for k, v in top.items():
            set_by_path(cfg, k, v)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Layer 2: per-workload defaults applied over the dataclass defaults.
#: Tracing *and* live metrics are on by default for every live workload —
#: the repo's documented unification of the old split (train silently off,
#: serve on), extended by the observability PR: the ``metrics`` plugin owns
#: the session MetricsRegistry the instrumented loops publish into.
WORKLOAD_DEFAULTS: dict[str, dict[str, object]] = {
    "train": {"modules": ("scan", "metrics")},
    "serve": {"modules": ("scan", "metrics")},
    "trace": {"modules": ()},      # the workload *is* MegaScan, offline
    "dryrun": {"modules": ()},     # compile analysis: nothing to attach to
}


# ---------------------------------------------------------------------------
# layering machinery
# ---------------------------------------------------------------------------


def _resolve_types(obj) -> dict[str, type]:
    # annotations are strings under `from __future__ import annotations`
    return typing.get_type_hints(type(obj))


def coerce(value, target: type):
    """Coerce a string (or JSON scalar/list) to an annotated field type."""
    origin = typing.get_origin(target)
    if origin is tuple:
        items = value.split(",") if isinstance(value, str) else list(value)
        items = [x for x in items if x != ""] if isinstance(value, str) else items
        elem = (typing.get_args(target) or (str,))[0]
        return tuple(coerce(x, elem) for x in items)
    if target is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse {value!r} as bool")
    if target in (int, float, str):
        return target(value)
    return value


def set_by_path(cfg: RunConfig, path: str, value) -> None:
    """Set ``a.b`` on a RunConfig, coercing ``value`` to the field's type.

    Unknown sections/fields raise ``KeyError`` — a typo in ``--set`` fails
    loudly instead of silently configuring nothing.
    """
    obj = cfg
    parts = path.split(".")
    for p in parts[:-1]:
        types = _resolve_types(obj)
        if p not in types or not dataclasses.is_dataclass(types[p]):
            raise KeyError(f"unknown config section {p!r} in {path!r}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    types = _resolve_types(obj)
    if leaf not in types:
        raise KeyError(
            f"unknown config field {path!r}; "
            f"{type(obj).__name__} has {sorted(types)}"
        )
    if dataclasses.is_dataclass(types[leaf]):
        raise KeyError(f"{path!r} is a section, not a field")
    setattr(obj, leaf, coerce(value, types[leaf]))


def apply_dict(cfg: RunConfig, data: dict, prefix: str = "") -> None:
    """Apply a nested dict (e.g. a parsed JSON config file) as overrides."""
    for k, v in data.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            apply_dict(cfg, v, prefix=f"{path}.")
        else:
            set_by_path(cfg, path, v)


def apply_sets(cfg: RunConfig, sets: list[str] | tuple[str, ...]) -> None:
    """Apply ``key=value`` dotted overrides (the ``--set`` flag)."""
    for s in sets:
        if "=" not in s:
            raise ValueError(f"--set expects key=value, got {s!r}")
        key, _, val = s.partition("=")
        set_by_path(cfg, key.strip(), val.strip())


def parse_modules(spec: str | tuple[str, ...]) -> tuple[str, ...]:
    """Parse a ``--modules`` list; ``none``/empty disables everything."""
    if isinstance(spec, str):
        spec = tuple(x.strip() for x in spec.split(",") if x.strip())
    mods = tuple(spec)
    if mods in (("none",), ("off",)):
        return ()
    from repro_torch.app.plugins import PLUGIN_REGISTRY  # local: plugins import this module

    for m in mods:
        if m not in PLUGIN_REGISTRY:
            raise ValueError(
                f"unknown module {m!r}; registered: {sorted(PLUGIN_REGISTRY)}"
            )
    return mods


def build_run_config(
    workload: str,
    *,
    config_json: str | None = None,
    sets: list[str] | tuple[str, ...] = (),
    **top,
) -> RunConfig:
    """Full layering pipeline: defaults -> workload -> JSON -> ``--set`` ->
    explicit keyword (CLI flag) overrides."""
    cfg = RunConfig.for_workload(workload)
    if config_json:
        apply_dict(cfg, json.loads(Path(config_json).read_text()))
    apply_sets(cfg, sets)
    for k, v in top.items():
        if k == "modules":
            v = parse_modules(v)
        set_by_path(cfg, k.replace("__", "."), v)
    cfg.modules = parse_modules(cfg.modules)
    return cfg
