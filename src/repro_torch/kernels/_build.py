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

With a :class:`repro_torch.core.compile_cache.CompileCache` attached
(:func:`use_cache`, or the ``cache`` argument) the libraries live under the
cache's versioned directory instead, keyed by the same hash and the cache's
key parts, and every load is counted in its stats: a library found is a
hit, one compiled a miss and a put.  With or without a cache a library
that ``ctypes`` refuses (truncated, another architecture) is unlinked and
built again (with a cache, counted in ``stats.errors``); a failed ``nvcc``
still raises, and no wrapper gives way to its plain version.
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

_loaded: dict[tuple, ctypes.CDLL] = {}   # (name, cache) -> library
_built: set[Path] = set()   # compiled by this process
_cache = None               # the attached CompileCache
#: ``nvcc`` processes this process has started
nvcc_runs = 0
#: libraries whose kernels a call on the meta device stood in for: which
#: libraries a step needs, read from a meta pass of it
meta_calls: set[str] = set()
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


def use_cache(cache) -> None:
    """Attach a ``CompileCache`` (None detaches): later builds and loads go
    through it."""
    global _cache
    _cache = cache


def attached():
    """The attached ``CompileCache``, or None."""
    return _cache


def library_path(name: str, cache=None) -> Path:
    """Keyed by the source, the headers it includes and the flags; under
    the attached (or given) cache, by that hash and the cache's key."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    for header in included_headers(src):
        digest.update(header.read_bytes())
    cache = cache or _cache
    if cache is None:
        return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    key = cache.key(library=name, source=digest.hexdigest())
    return cache.path(f"{name}-{key}", ".so")


def build(names: list[str] | None = None, cache=None) -> None:
    """Compile every named library that is not built yet (all by default)."""
    global nvcc_runs
    cache = cache or _cache
    todo = [n for n in (list(SOURCES) if names is None else names)
            if not library_path(n, cache).exists()]
    if not todo:
        return
    library_path(todo[0], cache).parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in todo:
        out = library_path(name, cache)
        if cache is not None:
            cache.miss()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        nvcc_runs += 1
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
        _built.add(out)
        if cache is not None:
            cache.stored()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str, cache=None) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed.  A
    library on disk that ``ctypes`` refuses is unlinked and built again;
    one this process has just built and ``ctypes`` refuses raises.  A
    loaded library is found by name, without hashing its sources again:
    wrappers ask for it at every call."""
    cache = cache or _cache
    lib = _loaded.get((name, cache))
    if lib is not None:
        return lib
    path = library_path(name, cache)
    build([name], cache)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        if path in _built:
            raise
        # fail open: a truncated or alien library costs one rebuild
        if cache is not None:
            cache.drop(path)
        else:
            path.unlink(missing_ok=True)
        build([name], cache)
        lib = ctypes.CDLL(str(path))
    else:
        if cache is not None and path not in _built:
            cache.hit()
    _loaded[(name, cache)] = lib
    return lib


def ptxas_report(name: str) -> list[str]:
    """What ptxas said about kernel ``name``: each entry function (its
    mangled name names the template instantiation), then its registers,
    stack and spills."""
    log = library_path(name).with_suffix(".log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
