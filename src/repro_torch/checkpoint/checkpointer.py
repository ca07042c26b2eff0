"""Atomic, async checkpointing of torch train state, counterpart of
``repro.checkpoint.checkpointer`` with the same on-disk layout.

Layout per step:  <dir>/step_<n>/
    manifest.json          leaf shapes, logical dtypes, user metadata
    <flat.key.path>.npy    one file per leaf

A flat key is what the JAX package's ``_flatten`` prints for the same tree:
a dataclass field is ``.<name>`` (jax's ``GetAttrKey`` prints its leading
dot), a dict key its string, a list index its number, joined with dots, so
the port's ``TrainState`` gives ``.params.seg0.b0.attn.wq`` and
``.opt.step`` as JAX's does.  bfloat16 leaves are stored as a ``uint16``
view with logical dtype ``bfloat16`` and a Python int (``opt["step"]``) as
an int32 scalar, as JAX stores its step.  So JAX's ``restore`` reads a port
checkpoint and :func:`restore` reads a JAX one.

Atomicity: written to ``step_<n>.tmp`` then renamed — a crash never leaves a
half-readable checkpoint.  Async: ``Checkpointer.save_async`` copies every
leaf to host memory before it returns (the train step updates master
weights and moments in place, so the copy must be complete before the next
step starts) and writes the files on a background thread.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch


def _items(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    """``(flat key, leaf)`` in ``jax.tree_util``'s order: dataclass fields in
    declaration order, dict keys sorted, sequences by index."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), (*prefix, f".{f.name}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, (*prefix, str(i)))
    else:
        yield ".".join(prefix), tree


def _rebuild(tree: Any, leaf: Callable[[str, Any], Any],
             prefix: tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``leaf(flat key, old leaf)``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaf, (*prefix, f".{f.name}"))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf, (*prefix, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf, (*prefix, str(i)))
                          for i, v in enumerate(tree))
    return leaf(".".join(prefix), tree)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a host array to store and its logical dtype.  A CUDA tensor
    is copied synchronously into pageable memory (never ``non_blocking``:
    the next step would overwrite the source before the copy lands)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def snapshot(state: Any) -> dict[str, tuple[np.ndarray, str]]:
    """Every leaf of ``state`` on the host, by flat key."""
    return {key: _host(leaf) for key, leaf in _items(state)}


def _write(leaves: dict[str, tuple[np.ndarray, str]], step: int,
           directory: str | Path, metadata: dict | None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}, "metadata": metadata or {}}
    for key, (arr, dtype) in leaves.items():
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save(state: Any, step: int, directory: str | Path,
         metadata: dict | None = None) -> Path:
    return _write(snapshot(state), step, directory, metadata)


def _step_dirs(directory: Path) -> list[Path]:
    return sorted(p for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in _step_dirs(directory)
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(directory: str | Path, target: Any,
            step: int | None = None) -> tuple[Any, dict]:
    """``(state, manifest)``: ``target``'s tree with every leaf read from the
    checkpoint, a tensor on the target leaf's device and dtype (and its
    ``requires_grad``), a Python int as an int.  ``step`` defaults to the
    latest."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    def load(key: str, like: Any) -> Any:
        arr = np.load(d / f"{key}.npy")
        if manifest["leaves"].get(key, {}).get("dtype") == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: checkpoint {tuple(t.shape)} vs target {want}")
        if not isinstance(like, torch.Tensor):
            return type(like)(t.item())
        return t.to(device=like.device, dtype=like.dtype).requires_grad_(
            like.requires_grad)

    return _rebuild(target, load), manifest


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        err = self.drain()
        if err is not None:
            raise err

    def drain(self) -> Exception | None:
        """Join the background save and *return* its error instead of
        raising — for failure paths that must not let a background-save
        error mask the original exception being handled."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        return err

    def save_async(self, state: Any, step: int, metadata: dict | None = None) -> None:
        """Copy ``state`` to the host now; write it on a background thread."""
        self.wait()
        leaves = snapshot(state)

        def _work():
            try:
                _write(leaves, step, self.directory, metadata)
                self._prune()
            except Exception as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def _prune(self) -> None:
        for p in _step_dirs(self.directory)[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
