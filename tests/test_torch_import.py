"""The port stands alone: importing every ``repro_torch`` module loads neither
JAX nor anything of the JAX package, and no source of the port (nor
``chip_smoke.py``) imports them."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$)", re.M)
_DYNAMIC = re.compile(r"""import_module\(\s*["'](?:jax|repro)["'.]""")


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        if parts[-1] == "__main__":
            continue
        out.append(".".join(parts))
    return out


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_no_source_of_the_port_imports_jax_or_repro():
    assert len(SOURCES) > 20
    offenders = [
        str(p.relative_to(ROOT)) for p in SOURCES
        if _IMPORT.search(p.read_text()) or _DYNAMIC.search(p.read_text())
    ]
    assert offenders == []


def test_the_scan_would_catch_an_import():
    for line in ("import jax", "from jax import numpy", "import repro.serve",
                 "  from repro.models import lm", "from repro import configs"):
        assert _IMPORT.search(line)
    for line in ("import repro_torch", "from repro_torch.models import lm",
                 "import jaxtyping"):
        assert not _IMPORT.search(line)


def test_the_pipeline_modules_are_guarded():
    """MegaDPP's modules (schedules, planner, executor, plan, the
    stage-stacked model) are among those imported and scanned above."""
    mods = set(_modules())
    for m in ("repro_torch.core.dpp", "repro_torch.core.dpp.schedule",
              "repro_torch.core.dpp.planner", "repro_torch.core.dpp.executor",
              "repro_torch.parallel", "repro_torch.parallel.plan",
              "repro_torch.models.pipeline"):
        assert m in mods, m
        path = PORT.parent.joinpath(*m.split("."))
        assert (path.with_suffix(".py") if path.with_suffix(".py").exists()
                else path / "__init__.py") in SOURCES


def test_the_recurrent_serving_modules_are_guarded():
    """The modules the recurrent serving slice touched (the carried-state
    recurrences, the families' blocks, the cache and pool, the engine, the
    server, the session and CLI, generation, the paged kernels' wrapper)
    are among those imported and scanned above."""
    mods = set(_modules())
    for m in ("repro_torch.models.scan_utils", "repro_torch.models.rwkv",
              "repro_torch.models.griffin", "repro_torch.models.layers",
              "repro_torch.models.lm", "repro_torch.models.model",
              "repro_torch.serve.paged_cache", "repro_torch.serve.engine",
              "repro_torch.serve.server", "repro_torch.app.session",
              "repro_torch.app.cli", "repro_torch.core.scope.generation",
              "repro_torch.kernels.paged_attention.ops",
              "repro_torch.kernels.rglru.ops", "repro_torch.kernels.wkv6.ops"):
        assert m in mods, m
        assert PORT.parent.joinpath(*m.split(".")).with_suffix(".py") in SOURCES


def test_the_router_modules_are_guarded():
    """MegaRoute's modules (the router package, the serving half of the
    simkit workload it shares with the offline evaluator) are among those
    imported and scanned above."""
    mods = set(_modules())
    for m in ("repro_torch.serve.router", "repro_torch.serve.router.router",
              "repro_torch.core.simkit.workload", "repro_torch.serve.scheduler"):
        assert m in mods, m
        path = PORT.parent.joinpath(*m.split("."))
        assert (path.with_suffix(".py") if path.with_suffix(".py").exists()
                else path / "__init__.py") in SOURCES


def test_the_dense_config_and_moe_modules_are_guarded():
    """The configs this slice registered (minitron-4b, minicpm-2b,
    qwen2-vl-7b, phi3.5-moe) and the modules it touched (the blocks with
    relu2, M-RoPE and MoE, the LM and its batches, the train step, loop and
    session) are among those imported and scanned above."""
    mods = set(_modules())
    for m in ("repro_torch.configs.minitron_4b", "repro_torch.configs.minicpm_2b",
              "repro_torch.configs.qwen2_vl_7b", "repro_torch.configs.phi35_moe_42b",
              "repro_torch.models.layers", "repro_torch.models.lm",
              "repro_torch.models.model", "repro_torch.train.train_step",
              "repro_torch.train.loop", "repro_torch.app.session"):
        assert m in mods, m
        assert PORT.parent.joinpath(*m.split(".")).with_suffix(".py") in SOURCES


def test_the_mla_modules_are_guarded():
    """The config this slice registered (deepseek-v2-lite-16b) and the
    modules it touched (MLA's blocks and cache, K2's wrapper and flop count,
    the engine and the server) are among those imported and scanned above."""
    mods = set(_modules())
    for m in ("repro_torch.configs.deepseek_v2_lite_16b", "repro_torch.models.layers",
              "repro_torch.models.lm", "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref", "repro_torch.core.flops",
              "repro_torch.serve.engine", "repro_torch.serve.server"):
        assert m in mods, m
        assert PORT.parent.joinpath(*m.split(".")).with_suffix(".py") in SOURCES
