"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library that ``ctypes`` loads; no PyTorch
header is included, so a build takes seconds.  Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the source,
every header it includes with quotes (directly or through another header,
wherever it lies) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.
The build runs at the first CUDA call of a kernel, never at import; each
``nvcc`` run starts before any is waited on, so sources compile in parallel.
``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (:func:`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SOURCES = {
    "paged_decode": _KERNELS / "paged_attention" / "csrc" / "paged_decode.cu",
    "paged_prefill": _KERNELS / "paged_attention" / "csrc" / "paged_prefill.cu",
    "flash_fwd": _KERNELS / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_bwd": _KERNELS / "flash_attention" / "csrc" / "flash_bwd.cu",
    "wkv6_fwd": _KERNELS / "wkv6" / "csrc" / "wkv6_fwd.cu",
    "wkv6_bwd": _KERNELS / "wkv6" / "csrc" / "wkv6_bwd.cu",
    "rglru_fwd": _KERNELS / "rglru" / "csrc" / "rglru_fwd.cu",
    "rglru_bwd": _KERNELS / "rglru" / "csrc" / "rglru_bwd.cu",
}
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or under {home}: the CUDA kernels "
            "cannot be built"
        )
    return str(path)


def included_headers(src: Path) -> list[Path]:
    """The headers ``src`` includes with quotes, directly or through another
    header, each resolved beside the file that names it; a name not found
    there is left to the compiler's search path (the toolkit's)."""
    found: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        for inc in _INCLUDE.findall(path.read_text()):
            header = (path.parent / inc).resolve()
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return sorted(found)


def library_path(name: str) -> Path:
    """Keyed by the source, the headers it includes and the flags."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    for header in included_headers(src):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> None:
    """Compile every named library that is not built yet (all by default)."""
    todo = [n for n in (names or list(SOURCES)) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> list[str]:
    """What ptxas said about kernel ``name``: each entry function (its
    mangled name names the template instantiation), then its registers,
    stack and spills."""
    log = library_path(name).with_suffix(".log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
