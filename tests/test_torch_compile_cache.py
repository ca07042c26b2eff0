"""The port's ``CompileCache`` against ``repro.core.compile_cache``: the same
key discipline (stable, sensitive, dataclasses canonicalised as JAX
canonicalises them), the mesh descriptor, hit/miss/put accounting, a corrupt
entry failing open and unlinked, a layout-version bump missing, and a second
process reusing the first one's entries.  The CPU has no ``nvcc``, so the
entries here are byte blobs; the kernel build's own use of the cache runs
with a stand-in ``nvcc`` (a truncated library is rebuilt once, a failed
compile still raises)."""

import os
import stat
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import pytest
import torch

from repro.core import compile_cache as jcc
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch.configs import get_config
from repro_torch.core.compile_cache import (
    _MAGIC,
    CompileCache,
    _jsonable,
    aot_compile,
    mesh_descriptor,
)
from repro_torch.kernels import _build
from repro_torch.serve.scheduler import ServeConfig
from repro_torch.train.optim import OptimizerConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, where
    the small ops here spin-wait on torch's thread pool against each other
    (30x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_key_stable_and_sensitive(tmp_path):
    cc = CompileCache(tmp_path)
    k1 = cc.key(bucket=("decode", 8), donate=[1], mesh="nomesh/cpux1")
    k2 = cc.key(mesh="nomesh/cpux1", donate=[1], bucket=("decode", 8))
    assert k1 == k2, "key must not depend on kwarg order"
    assert len(k1) == 32 and int(k1, 16) >= 0
    assert cc.key(bucket=("decode", 16), donate=[1], mesh="nomesh/cpux1") != k1
    assert cc.key(bucket=("decode", 8), donate=[], mesh="nomesh/cpux1") != k1


def test_key_canonicalizes_dataclasses(tmp_path):
    @dataclass
    class Cfg:
        n: int = 4
        name: str = "x"

    cc = CompileCache(tmp_path)
    assert cc.key(model=Cfg()) == cc.key(model={"n": 4, "name": "x"})
    assert cc.key(model=Cfg(n=5)) != cc.key(model=Cfg(n=4))


@pytest.mark.parametrize("part", ["model", "opt", "tuple"])
def test_jsonable_is_jaxs_canonical_form(part):
    """The port's configs canonicalise to what JAX's ``_jsonable`` gives
    its own namesakes, so a key part means the same on both sides."""
    from repro.configs import get_config as jax_get_config

    ours, theirs = {
        "model": (get_config("qwen2-0.5b", smoke=True),
                  jax_get_config("qwen2-0.5b", smoke=True)),
        "opt": (OptimizerConfig(lr=1e-3), JOptimizerConfig(lr=1e-3)),
        "tuple": (("decode", 8, None, 1.5, {"b": (1,), "a": True}),) * 2,
    }[part]
    assert _jsonable(ours) == jcc._jsonable(theirs)


def test_mesh_descriptor():
    """JAX's form, ``nomesh/<backend>x<devices>``: the CPU is one device
    to the port (JAX's count follows the host devices a process forced)."""
    import jax

    assert mesh_descriptor(None) == "nomesh/cpux1"
    assert jcc.mesh_descriptor(None).startswith(f"nomesh/{jax.default_backend()}x")

    class Mesh:  # a DeviceMesh's named shape and device type
        mesh_dim_names = ("data", "model")
        mesh = type("M", (), {"shape": (4, 2)})()
        device_type = "cpu"

    assert mesh_descriptor(Mesh()) == "{'data': 4, 'model': 2}/cpu"


def test_compile_miss_then_hit_roundtrip(tmp_path):
    cc = CompileCache(tmp_path)
    key = cc.key(bucket="t1")
    built = []
    blob, hit = cc.compile(key, lambda: built.append(1) or b"payload-1")
    assert (blob, hit) == (b"payload-1", False)
    assert cc.stats.as_dict() == {"hits": 0, "misses": 1, "puts": 1, "errors": 0}

    cc2 = CompileCache(tmp_path)  # fresh instance, same directory
    blob2, hit2 = cc2.compile(key, lambda: built.append(2) or b"other")
    assert (blob2, hit2) == (b"payload-1", True) and built == [1]
    assert cc2.stats.hits == 1 and cc2.stats.puts == 0
    assert not [p for p in cc._dir().iterdir() if p.name.endswith(".tmp")]


def test_corrupt_entry_fails_open_and_unlinks(tmp_path):
    cc = CompileCache(tmp_path)
    key = cc.key(bucket="t2")
    cc.compile(key, lambda: b"x" * 64)
    path = cc._path(key)
    assert path.exists()

    # truncated mid-payload: the magic is intact, the length is not
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 2])
    assert cc.load(key) is None
    assert cc.stats.errors == 1
    assert not path.exists(), "corrupt entry must be dropped"

    # bad magic: an alien file in the cache dir
    path.write_bytes(b"XXXX" + blob[len(_MAGIC):])
    assert cc.load(key) is None and cc.stats.errors == 2

    # after both failures a plain rebuild repopulates the slot
    payload, hit = cc.compile(key, lambda: b"y" * 64)
    assert not hit and payload == b"y" * 64 and path.exists()


def test_version_bump_misses_old_entries(tmp_path):
    cc = CompileCache(tmp_path)
    key = cc.key(bucket="t3")
    cc.compile(key, lambda: b"v1")

    class V2(CompileCache):
        VERSION = 2

    cc2 = V2(tmp_path)
    # same parts hash differently *and* live in a different directory
    assert cc2.key(bucket="t3") != key
    assert cc2.load(cc2.key(bucket="t3")) is None
    assert "v1" in str(cc._path(key)) and "v2" in str(cc2._path(key))


def test_aot_compile_without_cache_and_hit_skips_build(tmp_path):
    assert aot_compile(lambda: b"a", cache=None, key_parts={}) == (b"a", False)
    cc = CompileCache(tmp_path)
    parts = {"bucket": ("decode", 4), "donate": []}
    assert aot_compile(lambda: b"a", cache=cc, key_parts=parts) == (b"a", False)

    def boom():  # a hit must never build
        raise AssertionError("built on a hit")

    assert aot_compile(boom, cache=cc, key_parts=parts) == (b"a", True)


_CHILD = """
import sys
from repro_torch.core.compile_cache import CompileCache, aot_compile

cc = CompileCache(sys.argv[1])
blob, hit = aot_compile(lambda: b"built in process 1", cache=cc,
                        key_parts={"bucket": "xproc"})
print("HIT" if hit else "MISS", blob.decode())
"""


def test_cross_process_reuse(tmp_path):
    """The restart scenario: process 2 hits the entry process 1 wrote."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run():
        r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                           capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        return r.stdout.strip()

    first, second = run(), run()
    assert first == "MISS built in process 1"
    assert second == "HIT built in process 1"


# ------------------------------------------------ the kernel build through it


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Sources and a stand-in ``nvcc`` that builds them into real shared
    libraries with the C compiler, so ``ctypes`` loads them; the build's
    process state is fresh, and no cache is attached afterwards.  Each test
    truncates a library before any ``dlopen`` of its path, as a new process
    would find it."""
    if not any((Path(p) / "cc").exists() for p in os.environ["PATH"].split(os.pathsep)):
        pytest.skip("no C compiler on PATH to stand in for nvcc")
    sources = {}
    for i, name in enumerate(("k_a", "k_b", "k_c", "k_d")):
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"int {name}(void) {{ return {7 + i}; }}\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  case "$1" in -o) out="$2";; *.cu) src="$1";; esac; shift\n'
        "done\n"
        'cc -shared -fPIC -x c -o "$out" "$src"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "SOURCES", sources)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_built", set())
    monkeypatch.setattr(_build, "nvcc_runs", 0)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    yield tmp_path
    _build.use_cache(None)


def test_libraries_live_under_the_cache_and_hit_warm(fake_nvcc):
    """A cold process builds the library into the cache's versioned
    directory (a miss and a put); a warm one loads it, running no nvcc."""
    cold = CompileCache(fake_nvcc / "cc")
    _build.build(["k_a"], cold)
    path = _build.library_path("k_a", cold)
    assert path.parent == cold._dir() and path.exists()
    assert _build.nvcc_runs == 1
    assert cold.stats.as_dict() == {"hits": 0, "misses": 1, "puts": 1, "errors": 0}
    _build._built.clear()  # the next process
    warm = CompileCache(fake_nvcc / "cc")
    _build.use_cache(warm)
    assert _build.load("k_a").k_a() == 7 and _build.nvcc_runs == 1
    assert warm.stats.as_dict() == {"hits": 1, "misses": 0, "puts": 0, "errors": 0}


@pytest.mark.parametrize("mode", ["cache", "build-dir"])
def test_a_truncated_library_is_rebuilt_once(fake_nvcc, mode):
    """A library ``ctypes`` refuses costs one rebuild, never a crash, with
    or without a cache (with one, counted in ``stats.errors``); a compile
    that fails still raises."""
    cache = CompileCache(fake_nvcc / "cc") if mode == "cache" else None
    name = "k_b" if cache else "k_d"
    _build.build([name], cache)
    path = _build.library_path(name, cache)
    path.write_bytes(path.read_bytes()[:100])
    _build._built.clear()  # the next process finds it truncated
    assert getattr(_build.load(name, cache), name)() == (8 if cache else 10)
    assert _build.nvcc_runs == 2
    if cache:
        assert cache.stats.as_dict() == {"hits": 0, "misses": 2, "puts": 2, "errors": 1}
    (fake_nvcc / "bin" / "nvcc").write_text("#!/bin/sh\necho 'error: broken'\nexit 2\n")
    with pytest.raises(RuntimeError, match="broken"):
        _build.load("k_c", cache)


def test_the_dryrun_and_precompile_key_parts_are_jsonable(tmp_path):
    """What the serving and training warm-ups hash: configs, the mesh
    string, bucket widths and leaf signatures, canonical and stable."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    parts = dict(model=cfg, serve=ServeConfig(), mesh=mesh_descriptor(None),
                 step="decode", width=8, params=["(4, 8)/torch.bfloat16"])
    cc = CompileCache(tmp_path)
    assert cc.key(**parts) == CompileCache(tmp_path).key(**dict(reversed(parts.items())))
