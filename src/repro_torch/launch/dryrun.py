"""Dryrun: FLOP and memory estimates for every (architecture x input-shape)
cell on the meta device, counterpart of ``repro.launch.dryrun``.

    python -m repro_torch dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch dryrun --all --host-mesh --out artifacts/dryrun

The JAX dryrun lowers and compiles each cell on the TPU pod meshes and reads
XLA's cost and memory analyses.  The port's step is eager, so each cell runs
its step once on the meta device (``launch.specs``), where tensors carry
shapes and dtypes and nothing is computed or allocated, and reports:

* ``flops``: the products of the run (``core.flops.count_flops``; the
  kernels' by their formulas);
* ``model_flops``: (6 train | 2 otherwise) x ``active_param_count`` x tokens;
* ``memory`` for one card: the live storage bytes tracked over the run
  (a dispatch mode that adds each new storage's bytes, rounded up as the
  CUDA caching allocator rounds them, and takes them off when a finalizer
  sees the storage die).  The kernel wrappers allocate on the meta device
  what they allocate around a launch on the card (outputs, scratch,
  workspaces) and nothing a plain version would, so the run holds what the
  card holds: the backward, the remat recompute and AdamW's leaf loop
  included.  ``argument_bytes`` are the step's inputs, ``output_bytes`` what
  its result holds (``alias_bytes`` of it are inputs), ``temp_bytes`` the
  rest of the peak, and ``peak_est_bytes`` the peak;
* ``argument_bytes_per_device``: the inputs' bytes on one device of the
  cell's mesh under the profile's sharding rules (``--host-mesh``: data 4 x
  model 2; else the 16 x 16 production mesh);
* ``estimate_s``: the seconds the meta run took.

A cell whose step cannot run on the meta device is recorded as ``FAIL``
with its reason, never with a guessed number.  ``--multi-pod on|both`` and
``--save-hlo`` are refused: the TPU pod meshes and the HLO text have no
counterpart on the card.  For the same reason ``repro.launch.hlo_analysis``
(collective bytes parsed from the partitioned HLO) is not ported: the port
has no HLO, and a single card's step moves no collective.
"""

from __future__ import annotations

import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

HOST_MESH = {"data": 4, "model": 2}
PRODUCTION_MESH = {"data": 16, "model": 16}
_POD_REFUSAL = ("the dryrun's pod meshes (--multi-pod on|both) are TPU pods; "
                "the port estimates one card and the host mesh")
_HLO_REFUSAL = ("--save-hlo saves XLA's HLO text, which the port's eager step "
                "does not have")


def _allocated(nbytes: int) -> int:
    """What the CUDA caching allocator counts for a request: at least 512
    bytes, rounded up to a multiple of 512."""
    return 0 if nbytes == 0 else max(512, -(-nbytes // 512) * 512)


class LiveBytes(TorchDispatchMode):
    """Live storage bytes, and their peak, over a run on the meta device."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage if it is new."""
        st = t.untyped_storage()
        if st not in self._seen:
            n = self._seen[st] = _allocated(st.nbytes())
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def _tensors(tree) -> list[torch.Tensor]:
    from repro_torch.launch.specs import leaves

    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _storages(ts: list[torch.Tensor]) -> dict[int, int]:
    """Allocated bytes of each distinct storage of ``ts``, by id."""
    out: dict[int, int] = {}
    for t in ts:
        st = t.untyped_storage()
        out.setdefault(id(st), _allocated(st.nbytes()))
    return out


def estimate(cell) -> dict:
    """Run ``cell``'s step once on the meta device: its flops and its
    memory on one card (see the module docstring)."""
    from repro_torch.core.flops import count_flops
    from repro_torch.launch.specs import bytes_per_device

    args = _tensors(cell.args)
    arg = _storages(args)
    result: dict = {}
    t0 = time.perf_counter()
    with LiveBytes() as mem:
        for t in args:
            mem.track(t)
        flops = count_flops(lambda: result.setdefault("out", cell.step(*cell.args)))
    seconds = time.perf_counter() - t0
    out = _storages(_tensors(result.pop("out")))
    arg_bytes, out_bytes = sum(arg.values()), sum(out.values())
    alias = sum(n for i, n in out.items() if i in arg)
    return {
        "flops": int(flops),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": mem.peak - arg_bytes - (out_bytes - alias),
            "alias_bytes": alias,
            "peak_est_bytes": mem.peak,
        },
        "argument_bytes_per_device": bytes_per_device(cell),
        "estimate_s": seconds,
    }


def run_cell(
    arch: str,
    shape_name: str,
    *,
    profile: str | None = None,
    grad_accum: int = 1,
    smoke: bool = False,
    host_mesh: bool = False,
) -> dict:
    """One cell's estimate, in the JAX dryrun's result layout where its
    fields have a counterpart."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import active_param_count

    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    mesh = HOST_MESH if host_mesh else PRODUCTION_MESH
    cell = input_specs(cfg, shape, mesh, profile=profile, grad_accum=grad_accum)
    est = estimate(cell)
    n_active = active_param_count(cfg)
    tok = cell.meta["tokens"]
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": False,
        "profile": profile or ("decode" if shape.kind == "decode" else "fsdp_cp"),
        "grad_accum": grad_accum,
        "devices": mesh["data"] * mesh["model"],
        "tokens": tok,
        **est,
        "n_active_params": n_active,
        "model_flops": float((6 if shape.kind == "train" else 2) * n_active * tok),
    }


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import applicable_shapes, get_config, list_archs

    return [(arch, s.name) for arch in list_archs()
            for s in applicable_shapes(get_config(arch))]


def run_cells(
    *,
    arch: str | None = None,
    shape: str | None = None,
    run_all: bool = False,
    multi_pod: str = "off",
    profile: str | None = None,
    grad_accum: int = 1,
    out: str = "artifacts/dryrun",
    save_hlo: bool = False,
    smoke: bool = False,
    host_mesh: bool = False,
) -> dict:
    """Run a sweep of (arch x shape) cells; the ``python -m repro_torch
    dryrun`` workload body.  Finishes the sweep and returns {tag: result or
    {"error": ...}}, writing ``<tag>.json`` (or ``<tag>.err``) under
    ``out``; the exit policy is the CLI's."""
    if multi_pod != "off":
        raise ValueError(_POD_REFUSAL)
    if save_hlo:
        raise ValueError(_HLO_REFUSAL)
    cells = all_cells() if run_all else [(arch, shape)]
    outdir = Path(out)
    outdir.mkdir(parents=True, exist_ok=True)

    results: dict[str, dict] = {}
    for arch_i, shape_i in cells:
        tag = f"{arch_i}__{shape_i}__pod1"
        if profile:
            tag += f"__{profile}"
        if host_mesh:
            tag += "__host"
        dest = outdir / f"{tag}.json"
        t0 = time.perf_counter()
        try:
            res = run_cell(arch_i, shape_i, profile=profile, grad_accum=grad_accum,
                           smoke=smoke, host_mesh=host_mesh)
            results[tag] = res
            dest.write_text(json.dumps(res, indent=1))
            mem = res["memory"]
            print(
                f"OK   {tag}: flops={res['flops']:.3e} "
                f"model_flops={res['model_flops']:.3e} "
                f"peak={mem['peak_est_bytes'] / 2**30:.2f}GiB "
                f"args/dev={res['argument_bytes_per_device'] / 2**30:.3f}GiB "
                f"estimate={res['estimate_s']:.1f}s",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 - record and continue
            results[tag] = {"error": f"{type(e).__name__}: {e}"}
            dest.with_suffix(".err").write_text(traceback.format_exc())
            print(f"FAIL {tag}: {type(e).__name__}: {e} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return results
