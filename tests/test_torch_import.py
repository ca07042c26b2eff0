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
