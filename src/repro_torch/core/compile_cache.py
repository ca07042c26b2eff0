"""Persistent build cache for the port's kernels and warm-up records,
counterpart of ``repro.core.compile_cache``.

The JAX package persists the XLA executable of every bucketed step, so a
restarted process skips the compile.  The port runs eagerly and compiles
no program per step; what a new process pays before its first request or
step is the kernels' own builds:

* ``nvcc`` of the ``csrc/*.cu`` libraries (``kernels/_build.py``): each
  library is an entry, ``<key>.so``, keyed by its source, headers and flags
  and by this cache's key parts;
* Triton's compile of K1 at its first launch: with a cache attached, Triton's
  own cache directory lies under this one (``triton/``), so a warm process
  loads K1's binaries from it.

Beside those, each warmed step variant (a serving bucket, the train step)
has an entry of its own: a small record of the libraries that variant
launched, so a warm process loads them up front, and a hit says the variant
was warmed before.

Two defenses, as in the JAX package:

* a **versioned on-disk layout**: entries live under
  ``root/v<VERSION>/<backend>-torch<version>[-cu<cuda>-sm<cc>]/``, so a
  layout bump, a torch or CUDA upgrade or another card simply misses;
* **keys over everything that shapes the entry**: the model config, the
  mesh, the bucket and the donation signature hash into its name.

Writes are atomic (a temporary file, then ``os.replace``), so processes can
share one directory.  Every read fails *open*: a missing, truncated, corrupt
or version-skewed entry is counted (``stats.errors`` for a bad one), unlinked
and answered with ``None``, and the caller builds again: the cache can make
a start faster, never wrong or fatal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

_MAGIC = b"RPCC"  # repro compile cache


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    errors: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _jsonable(x: Any) -> Any:
    """Best-effort canonical form for key parts: dataclasses flatten to
    sorted dicts, tuples to lists, everything else through ``str`` if json
    refuses it."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _jsonable(v) for k, v in sorted(
            dataclasses.asdict(x).items()
        )}
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


def _backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def mesh_descriptor(mesh: Any | None) -> str:
    """Stable string for the mesh a step runs on: ``nomesh/<backend>x<n>``
    without one (the devices this process sees), else a ``DeviceMesh``'s
    axis sizes and device type (a 2x4 gloo world on the CPU and one on
    the cards are different worlds)."""
    if mesh is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return f"nomesh/{_backend()}x{n}"
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return f"{shape}/{mesh.device_type}"


class CompileCache:
    """Directory-backed artifact store (see module docstring).

    ``key(...)`` hashes jsonable parts into an entry name; ``load``/``put``
    move byte entries (``path(key, ".so")`` places a file entry such as a
    library, which its owner loads and counts through :meth:`hit`,
    :meth:`miss`, :meth:`stored` and :meth:`drop`); ``compile(key,
    build)`` is the one-liner of the warm-up paths: hit -> the stored
    bytes, miss -> ``build()`` + persist.
    """

    VERSION = 1

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.stats = CacheStats()

    # ------------------------------------------------------------- layout
    def _dir(self) -> Path:
        tag = f"{_backend()}-torch{torch.__version__}"
        if torch.cuda.is_available():
            cc = "".join(map(str, torch.cuda.get_device_capability(0)))
            tag += f"-cu{torch.version.cuda}-sm{cc}"
        return self.root / f"v{self.VERSION}" / tag

    def _path(self, key: str) -> Path:
        return self.path(key, ".bin")

    def path(self, key: str, suffix: str) -> Path:
        """Where the entry ``key`` lives as a file of its own kind."""
        return self._dir() / f"{key}{suffix}"

    def triton_dir(self) -> Path:
        """Triton's cache directory while this cache is attached."""
        return self._dir() / "triton"

    # --------------------------------------------------------------- keys
    def key(self, **parts: Any) -> str:
        """Hash the parts that shape the entry into its name.

        Conventional parts: ``config`` (model config dataclass), ``mesh``
        (:func:`mesh_descriptor`), ``bucket`` (step kind + every static
        width), ``donate`` (donated arguments).  The layout version and the
        torch version and backend ride the directory, but are hashed in too
        so a relocated entry can never alias."""
        body = json.dumps(
            {
                "v": self.VERSION,
                "torch": torch.__version__,
                "backend": _backend(),
                **{k: _jsonable(v) for k, v in sorted(parts.items())},
            },
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha256(body.encode()).hexdigest()[:32]

    # ------------------------------------------------------------ counting
    def hit(self) -> None:
        self.stats.hits += 1

    def miss(self) -> None:
        self.stats.misses += 1

    def stored(self) -> None:
        self.stats.puts += 1

    def drop(self, path: Path) -> None:
        """A bad entry: counted in ``stats.errors`` and unlinked."""
        self.stats.errors += 1
        try:
            path.unlink()
        except OSError:
            pass

    # ----------------------------------------------------------------- io
    def load(self, key: str) -> bytes | None:
        """The bytes stored under ``key``; ``None`` on a miss *or any
        failure* (a corrupt, truncated or alien entry is dropped)."""
        path = self._path(key)
        try:
            blob = path.read_bytes()
        except OSError:
            self.miss()
            return None
        n = len(_MAGIC)
        if (blob[:n] != _MAGIC or len(blob) < n + 8
                or int.from_bytes(blob[n:n + 8], "little") != len(blob) - n - 8):
            # fail open: a bad entry must cost one rebuild, not a crash
            self.drop(path)
            return None
        self.hit()
        return blob[n + 8:]

    def put(self, key: str, payload: bytes) -> bool:
        """Store ``payload`` under ``key`` behind the magic header and its
        length; atomic rename, so concurrent writers race benignly."""
        try:
            blob = _MAGIC + len(payload).to_bytes(8, "little") + payload
            d = self._dir()
            d.mkdir(parents=True, exist_ok=True)
            tmp = d / f".{key}.{os.getpid()}.tmp"
            tmp.write_bytes(blob)
            os.replace(tmp, self._path(key))
        except OSError:
            self.stats.errors += 1
            return False
        self.stored()
        return True

    # ---------------------------------------------------------- composite
    def compile(self, key: str, build: Callable[[], bytes]) -> tuple[bytes, bool]:
        """Load-or-build: returns ``(payload, was_hit)``.  On a miss the
        freshly built payload is persisted before returning."""
        blob = self.load(key)
        if blob is not None:
            return blob, True
        blob = build()
        self.put(key, blob)
        return blob, False


def aot_compile(
    build: Callable[[], bytes],
    *,
    cache: CompileCache | None,
    key_parts: dict[str, Any],
) -> tuple[bytes, bool]:
    """Run ``build()`` for its entry, consulting ``cache`` when given.
    Returns ``(payload, was_hit)``; on a hit ``build`` is not called."""
    if cache is None:
        return build(), False
    return cache.compile(cache.key(**key_parts), build)
