"""Data, tensor and pipeline parallelism of the port, on the CPU with gloo,
against the JAX package's fused single-device step (``make_train_step``
without a plan, ``jax.grad(lm.loss_fn)``), never a JAX mesh: the
logical-axis rules leaf for leaf, the (dp, tp, pp) matrix's losses (rtol
2e-5 over 2 steps) and the composed pp = 2 cells' gradients (rtol 5e-4 /
atol 1e-5), dp on the rwkv6 smoke config, a masked batch whose dp shards
count differently, MegaFBD's ``bwd`` in another process bit for bit, and
the refusals with JAX's messages.  The ranks are a ``Pool`` a world
size, spawned once for the module; their tasks live in
``tests/_torch_parallel_tasks.py``."""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import pipeline as jpl  # noqa: E402
from repro.models.model import get_model as jget_model  # noqa: E402
from repro.parallel import plan as jplan  # noqa: E402
from repro.parallel import profiles as jprofiles  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import init_train_state as jinit_train_state  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import pipeline as pl  # noqa: E402
from repro_torch.models.model import get_model  # noqa: E402
from repro_torch.models.weights import shard_params, unshard_params  # noqa: E402
from repro_torch.parallel import dist as pdist  # noqa: E402
from repro_torch.parallel import profiles, sharding  # noqa: E402
from repro_torch.parallel.plan import ParallelPlan, resolve_plan  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_tasks as tasks  # noqa: E402

# tests/test_parallel_matrix.py's TINY, on both sides
_TINY = dict(
    name="pp-tiny", family="dense", num_layers=4, d_model=32, num_heads=4,
    num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128, attn_kv_chunk=16,
    logits_chunk=16, vocab_pad_to=64,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
TINY, JTINY = ModelConfig(**_TINY), JModelConfig(**_TINY)
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, N_STEPS = 8, 32, 2   # seq > attn_kv_chunk: the chunked path


@pytest.fixture(scope="module")
def pools():
    """One world a size, spawned on first use and kept for the module."""
    made: dict[int, tasks.Pool] = {}

    def get(n: int) -> tasks.Pool:
        if n not in made:
            made[n] = tasks.Pool(n, device="cpu", timeout=300)
        return made[n]

    yield get
    for p in made.values():
        p.close()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg=JTINY, batch=BATCH, seq=SEQ, n=N_STEPS):
    ds = JSyntheticTokens(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    return [ds.batch_at(i) for i in range(n)]


def _state_np(jcfg=JTINY):
    st = jinit_train_state(jcfg, jax.random.PRNGKey(0))
    return {"params": _np(st.params), "master": _np(st.master),
            "opt": {"m": _np(st.opt["m"]), "v": _np(st.opt["v"]),
                    "step": np.asarray(st.opt["step"])}}


_REF: dict = {}


def _reference(ga: int, jcfg=JTINY, batches=None, key="tiny", master=False):
    """The fused single-device trajectory at grad_accum=ga (once a key): its
    losses, and with ``master`` its final float32 master ``{path: array}``."""
    if (key, ga) not in _REF:
        step = jax.jit(jmake_train_step(jcfg, joptim.OptimizerConfig(**OCFG),
                                        grad_accum=ga))
        state = jinit_train_state(jcfg, jax.random.PRNGKey(0))
        losses = []
        for b in batches or _batches(jcfg):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        final = {tuple(k.key for k in path): np.asarray(leaf) for path, leaf
                 in jax.tree_util.tree_flatten_with_path(state.master)[0]}
        _REF[(key, ga)] = (losses, final)
    return _REF[(key, ga)] if master else _REF[(key, ga)][0]


# ------------------------------------------------------------------ rules --

_MESHES = [((16, 16), ("data", "model")), ((4, 2), ("data", "model")),
           ((2, 2), ("data", "model"))]


def _is_axes(t):
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def _flat(tree, path=()):
    if _is_axes(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _flat(tree[k], (*path, k))


@pytest.mark.parametrize("arch", list_archs())
def test_rules_resolve_every_leaf_as_jax(arch):
    """``lm.param_axes`` equals JAX's, and ``logical_to_spec`` under
    ``rules_for`` of all three profiles resolves every leaf on (16, 16),
    (4, 2) and (2, 2) to JAX's spec (JAX through ``AbstractMesh``)."""
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        axes = get_model(cfg).param_axes(cfg)
        jaxes = jget_model(jcfg).param_axes(jcfg)
        assert axes == jaxes
        shapes = _jax_shapes(jcfg)
        for profile in ("fsdp_cp", "tp_sp", "decode"):
            rules = profiles.rules_for(cfg, "train", profile)
            jrules = jprofiles.rules_for(jcfg, "train", profile)
            assert rules == dict(jrules)
            for sizes, names in _MESHES:
                amesh = AbstractMesh(sizes, names)
                mesh = dict(zip(names, sizes))
                for path, ax in _flat(axes):
                    ours = sharding.logical_to_spec(ax, shapes[path], mesh, rules)
                    ref = jsharding.logical_to_spec(ax, shapes[path], amesh, jrules)
                    assert ours == tuple(ref), (arch, smoke, profile, sizes, path)
    assert sharding.logical_to_spec(("batch", "embed")) == ()  # no mesh: replicated


def _jax_shapes(jcfg) -> dict:
    tree = jax.eval_shape(lambda: jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_param_placements_on_a_device_mesh(pools):
    """On a (stage 1, data 2, model 2) ``DeviceMesh`` of four ranks each
    leaf's spec is JAX's and its placements shard the mesh dims it names."""
    got = pools(4).run(tasks.placements, TINY, (1, 2, 2), ("stage", "data", "model"))
    amesh = AbstractMesh((1, 2, 2), ("stage", "data", "model"))
    jrules = jprofiles.rules_for(JTINY, "train")
    shapes = _jax_shapes(JTINY)
    for path, ax in _flat(jlm.param_axes(JTINY)):
        spec, places = got[0][path]
        assert spec == tuple(jsharding.logical_to_spec(ax, shapes[path], amesh, jrules))
        want = ["Replicate()"] * 3
        for d, part in enumerate(spec):
            for a in ((part,) if isinstance(part, str) else (part or ())):
                want[("stage", "data", "model").index(a)] = f"Shard(dim={d})"
        assert places == want, path
        assert all(g[path] == got[0][path] for g in got[1:])


# ---------------------------------------------------------- shard_params --


def test_shard_params_round_trip_and_slices():
    from repro_torch.models import lm


    tree = lm.init(TINY, seed=0, device="cpu")
    layout = pl.pipeline_layout(TINY, 2, 1, tp=2)
    axes = lm.param_axes(TINY)
    shards = [shard_params(tree, layout, r, axes=axes) for r in range(2)]
    assert shards[0]["seg0"]["b0"]["attn"]["wq"].shape == (4, 32, 2, 8)
    assert shards[1]["seg0"]["b0"]["attn"]["wo"].shape == (4, 2, 8, 32)
    assert shards[0]["seg0"]["b0"]["mlp"]["w_down"].shape == (4, 32, 32)
    assert shards[0]["embedding"] is tree["embedding"]
    back = unshard_params(shards, layout, axes=axes)
    for (pa, a), (pb, b) in zip(optim.leaves(back), optim.leaves(tree)):
        assert pa == pb and torch.equal(a, b)
    assert set(pl.tp_slices(axes, layout)) == {
        ("seg0", "b0", "attn", k) for k in ("wq", "wk", "wv", "wo")} | {
        ("seg0", "b0", "mlp", k) for k in ("w_gate", "w_up", "w_down")}


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_stage_parts_own_their_cells_layers(n_chunks):
    """A stage's part holds the layers of its cells in chunk order (cell (s,
    c) the groups ``(c * S + s) * gpc + j``), stage 0 also the embedding and
    the head; the parts put back together are the whole tree."""
    from repro_torch.models import lm

    tree = lm.init(TINY, seed=0, device="cpu")
    layout = pl.pipeline_layout(TINY, 2, n_chunks)
    parts = [pl.stage_part(tree, layout, s) for s in range(2)]
    assert set(parts[0]) == set(tree) and set(parts[1]) == {"seg0"}
    wq = tree["seg0"]["b0"]["attn"]["wq"]
    g = layout.groups_per_cell
    for s, part in enumerate(parts):
        rows = [(c * 2 + s) * g + j for c in range(n_chunks) for j in range(g)]
        assert torch.equal(part["seg0"]["b0"]["attn"]["wq"], wq[rows])
        assert part["seg0"]["b0"]["attn"]["wq"].untyped_storage().data_ptr() != \
            wq.untyped_storage().data_ptr()
    back = pl.merge_stages(parts, layout)
    for (pa, a), (pb, b) in zip(optim.leaves(back), optim.leaves(tree)):
        assert pa == pb and torch.equal(a, b)


@pytest.mark.parametrize("tp", [1, 2])
def test_pipeline_param_specs_equal_jax(tp):
    ours = pl.pipeline_param_specs(TINY, pl.pipeline_layout(TINY, 2, 1, tp=tp))
    ref = jpl.pipeline_param_specs(JTINY, jpl.pipeline_layout(JTINY, 2, 1, tp=tp))
    flat = dict(_flat(ours))
    for path, spec in jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        assert flat[tuple(k.key for k in path)] == tuple(spec)
    assert len(flat) == len(jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


# ------------------------------------------------------------- the matrix --


def _cell_params():
    out = []
    for dp, tp, pp in [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, 2), (2, 1, 2),
                       (1, 2, 2), (2, 2, 2)]:
        out.append(pytest.param(dp, tp, pp, 1, "1f1b", id=f"dp{dp}-tp{tp}-pp{pp}-ga1-1f1b"))
    out.append(pytest.param(2, 2, 2, 2, "1f1b", id="dp2-tp2-pp2-ga2-1f1b"))
    out.append(pytest.param(2, 2, 2, 1, "wave", id="dp2-tp2-pp2-ga1-wave"))
    return out


def _unshard_grads(results, layout):
    """The whole gradient tree from the parts of the ranks of data 0: each
    stage's part (``stage_part``) of each tensor slice."""
    from repro_torch.models import lm

    parts = {(r["coords"]["stage"], r["coords"]["model"]):
             optim.tree_map(torch.from_numpy, r["grads"])
             for r in results if r["coords"]["data"] == 0}
    shards = [pl.merge_stages([parts[(s, t)] for s in range(layout.pp)], layout)
              for t in range(layout.tp)]
    if layout.tp == 1:
        return shards[0]
    return unshard_params(shards, layout, axes=lm.param_axes(TINY))


@pytest.mark.parametrize("dp,tp,pp,ga,sched", _cell_params())
def test_matrix_cell_loss_parity(pools, dp, tp, pp, ga, sched):
    """Each cell's 2-step losses equal the fused single-device step's at the
    same grad_accum (rtol 2e-5), and the whole master gathered on rank 0
    from the ranks' parts equals the fused step's (rtol 1e-4, atol 1e-5);
    the composed pp = 2 cells at ga 1 also hold their first step's
    gradient to ``jax.grad`` of the fused loss, leaf by leaf (rtol 5e-4,
    atol 1e-5)."""
    plan_kw = dict(dp=dp, tp=tp, pp=pp, schedule=sched,
                   n_micro=2 * dp if pp > 1 else 0)
    res = pools(dp * tp * pp).run(tasks.train_cell, TINY, plan_kw, _state_np(),
                                  _batches(), OCFG, ga)
    losses, master = _reference(ga, master=True)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=2e-5)
    whole = dict(optim.leaves(res[0]["whole"]))
    assert set(whole) == set(master) and all(r["whole"] is None for r in res[1:])
    for path, leaf in whole.items():
        np.testing.assert_allclose(leaf, master[path], rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    # every rank reports the same global loss
    for r in res[1:]:
        np.testing.assert_allclose(r["losses"], res[0]["losses"], rtol=1e-6)
    if pp > 1 and ga == 1 and sched == "1f1b" and (dp > 1 or tp > 1):
        layout = pl.pipeline_layout(TINY, pp, 1, tp=tp)
        got = _unshard_grads(res, layout)
        params = jlm.init(JTINY, jax.random.PRNGKey(0))
        b0 = _batches()[0]
        g_ref = jax.grad(lambda p: jlm.loss_fn(JTINY, p, b0)[0])(params)
        ref = {tuple(k.key for k in path): np.asarray(leaf) for path, leaf
               in jax.tree_util.tree_flatten_with_path(g_ref)[0]}
        flat = dict(optim.leaves(got))
        assert set(flat) == set(ref)
        for path, leaf in flat.items():
            np.testing.assert_allclose(leaf.numpy(), ref[path], rtol=5e-4, atol=1e-5,
                                       err_msg=str(path))


def _rwkv(mod_get):
    return mod_get("rwkv6-3b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none")


def test_dp2_on_the_rwkv6_smoke_config(pools):
    cfg, jcfg = _rwkv(get_config), _rwkv(jax_get_config)
    batches = _batches(jcfg, batch=4, seq=32)
    res = pools(2).run(tasks.train_cell, cfg, dict(dp=2), _state_np(jcfg), batches,
                       OCFG, 1)
    ref = _reference(1, jcfg, batches, key="rwkv")
    np.testing.assert_allclose(res[0]["losses"], ref, rtol=2e-5)


def test_dp2_weighs_unequal_mask_counts_by_their_share(pools):
    """A loss mask that leaves shard 0 (rows 0-3) a quarter of shard 1's
    tokens: dp = 2, and dp = 2 x pp = 2, still give the fused step's
    masked mean, not the mean of the two shards' means."""
    batches = _batches()
    for i, b in enumerate(batches):
        mask = np.ones_like(b["loss_mask"])
        mask[:BATCH // 2, SEQ // 4:] = 0.0
        mask[BATCH // 2:, :i + 1] = 0.0
        b["loss_mask"] = mask
    ref = _reference(1, batches=batches, key="masked")
    for plan_kw in (dict(dp=2), dict(dp=2, pp=2, n_micro=4)):
        res = pools(2 * plan_kw.get("pp", 1)).run(
            tasks.train_cell, TINY, plan_kw, _state_np(), batches, OCFG, 1)
        np.testing.assert_allclose(res[0]["losses"], ref, rtol=2e-5)
    # the mean of the shards' means is not the answer
    assert abs(ref[0] - _mean_of_means(batches[0])) > 1e-3


def _mean_of_means(b) -> float:
    params = jlm.init(JTINY, jax.random.PRNGKey(0))
    halves = [{k: v[s] for k, v in b.items()} for s in (slice(0, 4), slice(4, 8))]
    return float(np.mean([jlm.loss_fn(JTINY, params, h)[0] for h in halves]))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_fbd_bwd_in_another_process_is_bit_identical(pools, remat):
    """Rank 0's ``fwd`` sends parameters, batch, residuals and cotangent to
    rank 1, whose ``bwd`` rebuilds the graph: the gradients equal rank 0's
    in-process ``bwd`` bit for bit."""
    cfg = TINY.replace(remat=remat)
    params = _np(jlm.init(JTINY, jax.random.PRNGKey(1)))
    b = _batches(n=1)[0]
    a, c = pools(2).run(tasks.bwd_elsewhere, cfg, params, b)
    assert a["residuals"] == c["residuals"] > 0
    for (pa, x), (pc, y) in zip(optim.leaves(a["grads"]), optim.leaves(c["grads"])):
        assert pa == pc and np.array_equal(x, y), pa


# -------------------------------------------------------- must-refuse cells --


def _message(fn) -> str:
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


def test_refusals_carry_jax_messages():
    """The matrix's must-refuse cells raise JAX's messages (the mesh's names
    the port's module)."""
    assert _message(lambda: resolve_plan(ParallelPlan(pp=2, dp=2, n_micro=3))) == \
        _message(lambda: jplan.resolve_plan(jplan.ParallelPlan(pp=2, dp=2, n_micro=3)))
    rwkv, jrwkv = get_config("rwkv6-3b", smoke=True), jax_get_config("rwkv6-3b", smoke=True)
    ours = _message(lambda: pl.pipeline_layout(rwkv, pp=2, tp=2))
    assert "dense GQA" in ours
    assert ours == _message(lambda: jpl.pipeline_layout(jrwkv, pp=2, tp=2))
    for edit in (dict(num_kv_heads=1), dict(num_layers=6)):
        kw = dict(pp=2, tp=2) if "num_kv_heads" in edit else dict(pp=2, n_chunks=2)
        assert _message(lambda: pl.pipeline_layout(TINY.replace(**edit), **kw)) == \
            _message(lambda: jpl.pipeline_layout(JTINY.replace(**edit), **kw))
    plan = resolve_plan(ParallelPlan(pp=2, n_micro=3))
    layout = pl.pipeline_layout(TINY, 2, 1)
    from repro_torch.core.dpp.executor import build_time_table, make_pipeline_stages
    from repro_torch.models import lm
    from repro_torch.parallel.plan import forward_order

    table = build_time_table(forward_order(plan), 2, 1, plan.n_micro_local)
    b = {k: torch.from_numpy(v) for k, v in _batches(n=1)[0].items()}
    assert "not divisible by n_micro" in _message(lambda: pl.pipeline_loss(
        TINY, lm.init(TINY, seed=0, device="cpu"), b, layout=layout, table=table,
        stages=make_pipeline_stages(2, "cpu"), n_micro=3))
    # a dp/tp plan without its mesh: JAX's message, with the port's module
    ocfg = optim.OptimizerConfig(**OCFG)
    ours = _message(lambda: make_train_step(TINY, ocfg, plan=resolve_plan(
        ParallelPlan(pp=2, dp=2, n_micro=4))))
    assert "needs a mesh shaped {'stage': 2, 'data': 2, 'model': 1}; got None" in ours
    assert "repro_torch.launch.mesh.make_pipeline_mesh" in ours


def test_refusals_of_the_port():
    """What the port does not run yet names its ROADMAP item: tp at pp = 1
    over other families and dp over MoE (item 8c); int8 compression over a
    pp > 1 plan with dp = 1 raises JAX's ``ValueError`` (no data axis); a
    mesh larger than the world names both counts."""
    from repro_torch.launch.mesh import make_pipeline_mesh, make_production_mesh

    with pytest.raises(SystemExit, match="item 8c"):
        cli.main(["train", "--smoke", "--device", "cpu", "--steps", "1",
                  "--arch", "rwkv6-3b", "--set", "parallel.tp=2"])
    from repro.ft import GradCompressor as JGradCompressor
    from repro_torch.ft import GradCompressor

    ours = _message(lambda: make_train_step(TINY, optim.OptimizerConfig(), plan=resolve_plan(
        ParallelPlan(pp=2)), compressor=GradCompressor()))
    theirs = _message(lambda: jmake_train_step(JTINY, joptim.OptimizerConfig(),
                                               plan=jplan.resolve_plan(jplan.ParallelPlan(pp=2)),
                                               compressor=JGradCompressor()))
    assert ours == theirs and "dp=1 has no data axis to compress" in ours
    with pytest.raises(ValueError, match="needs 512 ranks, the world has 1"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 8 ranks, the world has 1"):
        make_pipeline_mesh(2, 2, 2)
    assert pdist.pick_backend(torch.device("cpu"), 4) == "gloo"


@pytest.mark.parametrize("par,world", [(["--set", "parallel.dp=2"], 2),
                                       (["--pp", "2", "--set", "parallel.tp=2"], 4)],
                         ids=["dp2", "pp2-tp2"])
def test_dp_checkpoint_resumes_in_one_process(tmp_path, par, world):
    """A dp = 2 run's checkpoint, and a pp = 2 x tp = 2 run's gathered from
    the ranks' parts, is the whole tree in the single-process format: one
    process resumes from it."""
    base = ["train", "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--set", "train.seq_len=32", "--set", "train.global_batch=4",
            "--modules", "none", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    two = cli.run([*base, "--steps", "2", *par])
    assert two["session"].results["parallel"]["world"] == world
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step"))
    three = cli.run([*base, "--steps", "3"])
    assert [h["step"] for h in three["history"]] == [3]
    assert np.isfinite(three["history"][0]["loss"])
