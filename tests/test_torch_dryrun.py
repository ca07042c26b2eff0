"""The port's dryrun against ``repro.launch.specs`` / ``repro.launch.dryrun``
on the CPU.  JAX's compiled figures (cost and memory analyses) cannot be
reached on this tree (ROADMAP R3: its lowering under jax 0.9 fails), so the
cell is held to the reference where the reference runs:

* ``input_specs`` of every registered arch at smoke and each applicable
  shape gives the leaves JAX's ``input_specs`` gives, leaf by leaf by path
  (shapes; dtypes too, except that the port's serving weights keep their
  norm scales float32 where JAX's cell casts every leaf to bfloat16);
* the arguments' bytes on one device of the 4 x 2 host mesh equal the sum
  of JAX's ``NamedSharding.shard_shape`` bytes (over an abstract mesh) in
  the port's dtypes, but for AdamW's step counter and the decode position,
  device scalars in JAX and Python ints here;
* ``active_param_count`` and ``model_flops`` equal JAX's;
* ``count_flops`` on the meta device equals its count on the CPU for a
  config of each family;
* the kernel wrappers' meta branches return what the kernels return;
* the live-bytes tracker counts what the allocator would;
* ``python -m repro_torch dryrun`` writes the reference CLI test's JSON,
  and refuses the pod meshes and ``--save-hlo``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.specs import input_specs as jax_input_specs  # noqa: E402
from repro.models.model import active_param_count as jax_active  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import bytes_per_device, input_specs  # noqa: E402
from repro_torch.models.lm import _NORM_LEAVES  # noqa: E402
from repro_torch.models.model import active_param_count, make_batch  # noqa: E402
from repro_torch.train.loop import step_flops  # noqa: E402
from repro_torch.train.train_step import init_train_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOST = {"data": 4, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, where
    the small ops here spin-wait on torch's thread pool against each other
    (30x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(path) -> tuple[str, ...]:
    return tuple(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                 for p in path)


def _jax_leaves(tree) -> dict:
    return {_key(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=()) -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif hasattr(tree, "__dataclass_fields__"):
        items = ((f, getattr(tree, f)) for f in tree.__dataclass_fields__)
    else:
        return {}  # AdamW's step counter, the decode position: Python ints
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, prefix + (str(k),)))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_shard_bytes_equal_jaxs(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    mesh = AbstractMesh((4, 2), ("data", "model"))
    shapes = [s.name for s in applicable_shapes(cfg)]
    assert shapes == [s.name for s in JSHAPES.values()
                      if s.name != "long_500k" or jcfg.supports_long_context]
    for name in shapes:
        jcell = jax_input_specs(jcfg, JSHAPES[name], mesh)
        cell = input_specs(cfg, SHAPES[name], HOST)
        assert (cell.kind, cell.meta["tokens"], cell.donate_argnums) == (
            jcell.kind, jcell.meta["tokens"], jcell.donate_argnums)
        theirs, ours = _jax_leaves(jcell.in_specs), _port_leaves(cell.args)
        # AdamW's step counter and the decode position are device scalars
        # in JAX, Python ints here
        scalars = {k for k in theirs if k[1:] == ("opt", "step")
                   or (cell.kind == "decode" and k == ("3",))}
        assert set(theirs) - scalars == set(ours), name
        for k, (shape, dtype) in ours.items():
            assert shape == theirs[k][0], (name, k)
            if cell.kind != "train" and k[-1] in _NORM_LEAVES:
                assert dtype == "float32", (name, k)
            else:
                assert dtype == theirs[k][1], (name, k)
        # JAX's shard shapes, in the port's dtypes
        paths = jax.tree_util.tree_flatten_with_path(jcell.in_specs)[0]
        shards = jax.tree.leaves(jcell.in_shardings)
        want = 0
        for (path, leaf), sh in zip(paths, shards):
            key = _key(path)
            if key in ours:
                itemsize = torch.empty((), dtype=getattr(torch, ours[key][1])).element_size()
                want += int(np.prod(sh.shard_shape(leaf.shape))) * itemsize
        assert bytes_per_device(cell) == want, name


def test_active_params_and_model_flops_equal_jaxs():
    for arch in list_archs():
        n = active_param_count(get_config(arch))
        assert n == jax_active(jax_get_config(arch)), arch
    res = dryrun.run_cell("qwen2-0.5b", "decode_32k", smoke=True, host_mesh=True)
    jcfg = jax_get_config("qwen2-0.5b", smoke=True)
    assert res["n_active_params"] == jax_active(jcfg)
    assert res["model_flops"] == 2 * jax_active(jcfg) * 128
    assert res["devices"] == 8 and res["tokens"] == 128


def test_an_embeds_arch_decode_cell_takes_embedding_rows():
    """qwen2-vl-7b's decode cell is built from ``[B, 1, d_model]`` bfloat16
    embeddings, as JAX's is, and its step runs on the meta device."""
    cfg = get_config("qwen2-vl-7b", smoke=True)
    cell = input_specs(cfg, SHAPES["decode_32k"], HOST)
    emb = cell.args[2]
    assert emb.is_meta and emb.dtype == torch.bfloat16
    assert tuple(emb.shape) == (SHAPES["decode_32k"].global_batch, 1, cfg.d_model)
    assert cell.axes[2] == ("batch", None, None)
    res = dryrun.run_cell("qwen2-vl-7b", "decode_32k", smoke=True, host_mesh=True)
    assert res["flops"] > 0 and res["memory"]["peak_est_bytes"] > 0
    assert res["tokens"] == SHAPES["decode_32k"].global_batch


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b", "rwkv6-3b",
                                  "recurrentgemma-9b", "seamless-m4t-large-v2"])
def test_count_flops_on_meta_equals_the_cpu_count(arch):
    """Dense, MoE, MLA, RWKV-6, Griffin and the encoder-decoder: the meta
    pass (what the train loop's MFU numerator now runs) counts the same
    integer as a pass on the CPU, where K2's and K5's plain versions run
    and are counted by the kernels' formulas."""
    cfg = get_config(arch, smoke=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, 2, 32, np.random.default_rng(0))
    meta = step_flops(cfg, state, batch, meta=True)
    assert meta > 0 and meta == step_flops(cfg, state, batch)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device="meta")


def test_the_kernel_wrappers_return_on_meta_what_the_kernels_return():
    """Each wrapper's meta branch gives the kernel's outputs (shapes and
    dtypes of the plain versions' results on the CPU), launches nothing,
    and notes the library it stood in for."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention import ops as paged
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.wkv6.ops import wkv6

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).requires_grad_(dtype.is_floating_point)

    cases = {
        "rmsnorm": (lambda *a: rmsnorm(*a), (rand(6, 32, dtype=bf), rand(32))),
        "flash": (lambda q, k, v: flash_attention(q, k, v, scale=0.25),
                  (rand(2, 8, 4, 16, dtype=bf), rand(2, 8, 2, 16, dtype=bf),
                   rand(2, 8, 2, 16, dtype=bf))),
        "wkv6": (lambda *a: wkv6(*a)[0],
                 (rand(1, 8, 2, 16, dtype=bf), rand(1, 8, 2, 16, dtype=bf),
                  rand(1, 8, 2, 16, dtype=bf), torch.rand(1, 8, 2, 16).requires_grad_(),
                  rand(2, 16))),
        "rglru": (lambda a, b: rglru_scan(a, b)[0],
                  (torch.rand(2, 8, 32).requires_grad_(), rand(2, 8, 32))),
    }
    _build.meta_calls.clear()
    for name, (fn, args) in cases.items():
        want = fn(*args)
        gw = torch.autograd.grad(want.float().sum(), args)
        margs = [_meta(a).requires_grad_(a.requires_grad) for a in args]
        got = fn(*margs)
        gg = torch.autograd.grad(got.float().sum(), margs)
        assert got.is_meta and (got.shape, got.dtype) == (want.shape, want.dtype), name
        for a, b in zip(gg, gw):
            assert a.is_meta and (a.shape, a.dtype) == (b.shape, b.dtype), name
    k_pool = torch.zeros(2, 5, 4, 2, 16, dtype=bf)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    kv_len = torch.tensor([6, 3], dtype=torch.int32)
    q = torch.randn(2, 1, 4, 16, generator=g).to(bf)
    want = paged.paged_attention(q, k_pool, k_pool, tables=tables, kv_len=kv_len,
                                 scale=0.25, layer=1)
    got = paged.paged_attention(*map(_meta, (q, k_pool, k_pool)),
                                tables=_meta(tables), kv_len=_meta(kv_len),
                                scale=0.25, layer=1)
    assert got.is_meta and (got.shape, got.dtype) == (want.shape, want.dtype)
    assert _build.meta_calls == {"flash_fwd", "flash_bwd", "wkv6_fwd", "wkv6_bwd",
                                 "rglru_fwd", "rglru_bwd", "paged_decode", "rmsnorm_bwd"}
    assert paged.meta_scratch_bytes(2, 1, 4, 2, 16, 4, 2) == 4 * 2 * 2 * 1 * 1 * 2 * 18


def test_live_bytes_count_what_the_allocator_would():
    """Storages rounded up to 512 bytes, views free, the peak kept after a
    free."""
    with dryrun.LiveBytes() as mem:
        a = torch.empty(1000, device="meta")      # 4000 -> 4096
        b = a[10:]                                # a view: no new storage
        c = torch.empty(3, device="meta")         # 12 -> 512
        del c
        d = torch.empty(2, 64, device="meta", dtype=torch.bfloat16)  # 256 -> 512
    assert (mem.peak, mem.live) == (4096 + 512, 4096 + 512)
    del a, b, d
    assert mem.live == 0


def test_dryrun_subcommand_subprocess(tmp_path):
    """The reference's CLI test on the port: one cell of the smoke config
    on the host mesh, its JSON with flops and a peak."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "dryrun", "--arch", "qwen2-0.5b",
         "--shape", "train_4k", "--smoke", "--host-mesh", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (cell,) = tmp_path.glob("*.json")
    assert cell.name == "qwen2-0.5b__train_4k__pod1__host.json"
    res = json.loads(cell.read_text())
    assert res["flops"] > 0 and res["memory"]["peak_est_bytes"] > 0
    assert proc.stdout.startswith("OK   qwen2-0.5b__train_4k__pod1__host:")


@pytest.mark.parametrize("argv,msg", [
    (["--multi-pod", "on"], "TPU pods"),
    (["--multi-pod", "both"], "TPU pods"),
    (["--save-hlo"], "HLO text"),
])
def test_pod_meshes_and_hlo_are_refused(argv, msg, tmp_path):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["dryrun", "--arch", "qwen2-0.5b", "--smoke", "--shape", "decode_32k",
                  "--out", str(tmp_path), *argv])
    assert not list(tmp_path.iterdir())
