"""K6 at other block geometries, on the card:

    PYTHONPATH=src python -m repro_torch.kernels.rglru.sweep

For each (warps, piece) below, copies ``csrc/`` under
``build/rglru_sweep/`` with ``rglru_common.cuh``'s WARPS and PIECE
replaced and builds the copy with ``_build``'s flags (all copies in
parallel).  Each copy is held to the float64 plain versions at a ragged
shape (row limit 1e-6, as ``chip_smoke.py`` holds K6), then the built
kernels (``rglru_fwd_kernel``, ``rglru_bwd_kernel``) and every copy are
timed through CUDA graphs at the Griffin training shape [2, 4096, 4096], in
turns: the list, then the list reversed.  Prints ptxas' registers and
spills and, per geometry and turn, ms and TB/s of each direction.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ops import _SIGNATURES, rglru_bwd_kernel, rglru_fwd_kernel
from repro_torch.kernels.rglru.ref import rglru_bwd_plain, rglru_plain

GEOMETRIES = [(8, 4), (8, 6), (8, 8), (8, 12), (8, 16), (8, 32), (4, 16), (16, 4)]
SHAPE = (2, 4096, 4096)
ROW_RTOL = 1e-6
OUT = _build.BUILD_DIR.parent / "rglru_sweep"


def _copies() -> dict[tuple[int, int], dict]:
    """Build every geometry's copy: -> {(warps, piece): {name: fn, "ptxas": lines}}."""
    shutil.rmtree(OUT, ignore_errors=True)
    csrc = _build.SOURCES["rglru_fwd"].parent
    running = []
    for warps, piece in GEOMETRIES:
        d = OUT / f"w{warps}p{piece}"
        shutil.copytree(csrc, d)
        header = d / "rglru_common.cuh"
        text = header.read_text()
        for const, value in (("WARPS", warps), ("PIECE", piece)):
            old = next(ln for ln in text.splitlines() if ln.startswith(f"constexpr int {const} ="))
            text = text.replace(old, f"constexpr int {const} = {value};")
        header.write_text(text)
        for name in _SIGNATURES:
            so = d / f"{name}.so"
            proc = subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                                     str(d / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append(((warps, piece), name, so, proc))
    libs: dict[tuple[int, int], dict] = {g: {"ptxas": []} for g in GEOMETRIES}
    for geom, name, so, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} at {geom}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        libs[geom][name] = fn
        libs[geom]["ptxas"] += [f"{name}: {ln.strip()}" for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln]
    return libs


def _fwd(fn, a, b):
    B, T, W = a.shape
    y, h = torch.empty_like(a), torch.empty((B, W), device=a.device)
    err = fn(a.data_ptr(), b.data_ptr(), y.data_ptr(), h.data_ptr(), B, T, W,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_fwd launch failed: CUDA error {err}")
    return y, h


def _bwd(fn, a, y, dy, dh=None):
    B, T, W = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    err = fn(a.data_ptr(), y.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
             da.data_ptr(), db.data_ptr(), B, T, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_bwd launch failed: CUDA error {err}")
    return da, db


def _inputs(gen, dev, B, T, W):
    """Griffin's decays: log a = -8 softplus(lam) sigmoid(N(0, 1)), b =
    sqrt(1 - a^2) N(0, 1); dy ~ N(0, 1)."""
    lam = 2 * torch.rand((W,), generator=gen, device=dev) - 1
    log_a = -8 * torch.nn.functional.softplus(lam) * torch.sigmoid(
        torch.randn((B, T, W), generator=gen, device=dev))
    b = torch.sqrt(-torch.expm1(2 * log_a)) * torch.randn((B, T, W), generator=gen, device=dev)
    return torch.exp(log_a), b, torch.randn((B, T, W), generator=gen, device=dev)


def _row_err(x, ref) -> float:
    d = (x.double() - ref).abs().amax(-1)
    m = ref.abs().amax(-1)
    return (d / m.clamp_min(1e-2 * m.median()).clamp_min(1e-30)).max().item()


def _graph_ms(fn, iters: int = 50) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph,
    one replay timed by CUDA events after a warm replay."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    libs = _copies()
    gen = torch.Generator(device=dev).manual_seed(9)
    a, b, dy = _inputs(gen, dev, 2, 1003, 130)
    dh = torch.randn((2, 130), generator=gen, device=dev)
    ry, rh = rglru_plain(a.double(), b.double())
    rda, rdb = rglru_bwd_plain(a.double(), ry, dy.double(), dh.double())
    for geom, lib in libs.items():
        y, h = _fwd(lib["rglru_fwd"], a, b)
        da, db = _bwd(lib["rglru_bwd"], a, y, dy, dh)
        err = max(_row_err(x, r) for x, r in ((y, ry), (h, rh), (da, rda), (db, rdb)))
        print(f"warps={geom[0]} piece={geom[1]}: row error {err:.3e} at [2, 1003, 130] "
              f"{'ok' if err <= ROW_RTOL else 'FAIL'}; " + "; ".join(lib["ptxas"]), flush=True)
        if err > ROW_RTOL:
            raise AssertionError(f"K6 at warps={geom[0]} piece={geom[1]} disagrees")

    a, b, dy = _inputs(gen, dev, *SHAPE)
    y, _ = rglru_fwd_kernel(a, b)
    n = a.numel()
    calls = {"built": (lambda: rglru_fwd_kernel(a, b), lambda: rglru_bwd_kernel(a, y, dy))}
    for geom, lib in libs.items():
        calls[f"warps={geom[0]} piece={geom[1]}"] = (
            lambda f=lib["rglru_fwd"]: _fwd(f, a, b),
            lambda f=lib["rglru_bwd"]: _bwd(f, a, y, dy))
    order = list(calls)
    for turn in (order, order[::-1]):
        for tag in turn:
            fwd, bwd = calls[tag]
            tf, tb = _graph_ms(fwd), _graph_ms(bwd)
            print(f"{tag:18s} {list(SHAPE)}: fwd {tf:.4f} ms ({12 * n / tf / 1e9:.3f} TB/s), "
                  f"bwd {tb:.4f} ms ({20 * n / tb / 1e9:.3f} TB/s)", flush=True)


if __name__ == "__main__":
    main()
