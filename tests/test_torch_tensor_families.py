"""Tensor parallelism over RWKV-6, Griffin, MoE, M-RoPE, MLA (with shared
experts and a dense first layer) and encoder-decoder blocks, with the
vocabulary of the embedding and the cross entropy sliced over the tensor
ranks, and data parallelism over MoE layers, on the CPU with gloo: the
smoke configs of rwkv6-3b, recurrentgemma-9b (rec, rec, attn, rec),
phi3.5-moe, qwen2-vl-7b (embeddings and M-RoPE ids on a patch grid),
deepseek-v2-lite (dense, MoE, MoE) and seamless-m4t (frames and target
tokens) at tp 2, phi3.5-moe at dp 2 and dp 2 x tp 2, each held to the JAX package's
fused single-device step (``make_train_step`` without a plan; losses
within rtol 2e-5 over 2 steps), each rank's synced gradients (its slices
of the embedding and the head included) to the port's fused step (rtol
5e-4, atol 1e-5), MoE's aux loss and drop fraction at dp 2 to the whole
batch's from JAX's ``lm.loss_fn``, the slice table against JAX's
``logical_to_spec`` under ``fsdp_cp`` (the leaves kept whole named in
``models.split.KEPT_WHOLE``: ROADMAP P19; the vocabulary whole inside a
pipeline), the one-process split against the fused loss (a padded
vocabulary, tied embeddings, minicpm's scales, a masked row), every
registered config's widths at tp 2, the refusals (ROADMAP item 8c, R8)
and a tp 2 run's checkpoint resumed in one process bit for bit.  The
ranks are ``tasks.Pool`` worlds, spawned once for the module; their tasks
live in ``tests/_torch_parallel_tasks.py``."""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.parallel import profiles as jprofiles  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import get_model as jget_model  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import init_train_state as jinit_train_state  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import split as sp  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    from_jax_params,
    shard_params,
    unshard_params,
)
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.models.model import get_model, make_batch  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import grad_tree, unused_leaves  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_tasks as tasks  # noqa: E402

ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b")
MOE = "phi3.5-moe-42b-a6.6b"
VL = "qwen2-vl-7b"
MLA = "deepseek-v2-lite-16b"
ED = "seamless-m4t-large-v2"
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, N_STEPS = 4, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _cfgs(arch: str):
    kw = dict(param_dtype="float32", compute_dtype="float32", remat="none")
    return get_config(arch, smoke=True).replace(**kw), \
        jax_get_config(arch, smoke=True).replace(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _patch_grid(B: int, S: int, side: int = 4) -> np.ndarray:
    """M-RoPE ids ``[3, B, S]`` of a ``side x side`` image at time 0 (rows
    and columns in the h and w streams), then text continuing from ``side``
    in all three streams."""
    i = np.arange(S)
    n = side * side
    text = i - n + side
    ids = np.stack([np.where(i < n, 0, text), np.where(i < n, i // side, text),
                    np.where(i < n, i % side, text)])
    return np.ascontiguousarray(np.broadcast_to(ids[:, None], (3, B, S)), dtype=np.int32)


def _batches(jcfg, n: int = N_STEPS):
    """``n`` steps' numpy batches: ``SyntheticTokens``' for a token arch;
    for an embeds arch ``make_batch``'s embeddings (the encoder-decoder's
    frames and target tokens) and targets, with M-RoPE ids on a patch grid
    where the arch takes them."""
    if jcfg.input_kind != "tokens":
        out = []
        for i in range(n):
            b = {k: v.numpy() for k, v in make_batch(
                jcfg, BATCH, SEQ, np.random.default_rng(i)).items()}
            if jcfg.input_kind == "embeds_mrope":
                b["mrope_position_ids"] = _patch_grid(BATCH, SEQ)
            out.append(b)
        return out
    ds = JSyntheticTokens(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH))
    return [ds.batch_at(i) for i in range(n)]


_STATE: dict = {}


def _jstate(jcfg):
    """The JAX package's seed-0 ``TrainState`` (its init jitted: eager, it
    draws leaf by leaf for seconds a config), and the same state as numpy
    trees for the port (``models.weights``)."""
    if jcfg.name not in _STATE:
        st = jax.jit(lambda k: jinit_train_state(jcfg, k))(jax.random.PRNGKey(0))
        _STATE[jcfg.name] = (st, {
            "params": _np(st.params), "master": _np(st.master),
            "opt": {"m": _np(st.opt["m"]), "v": _np(st.opt["v"]),
                    "step": np.asarray(st.opt["step"])}})
    return _STATE[jcfg.name]


def _state_np(jcfg):
    return _jstate(jcfg)[1]


_REF: dict = {}


def _jax_losses(jcfg):
    """The JAX package's fused single-device trajectory (once an arch)."""
    if jcfg.name not in _REF:
        step = jax.jit(jmake_train_step(jcfg, joptim.OptimizerConfig(**OCFG)))
        state = _jstate(jcfg)[0]
        losses = []
        for b in _batches(jcfg):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        _REF[jcfg.name] = losses
    return _REF[jcfg.name]


def _fused_grads(cfg, jcfg) -> dict:
    """The port's fused gradient of the first batch at the JAX init's
    parameters (once an arch)."""
    if ("grads", cfg.name) not in _STATE:
        params = from_jax_params(_state_np(jcfg)["params"], device="cpu")
        for _, leaf in optim.leaves(params):
            leaf.requires_grad_(True)
        b = {k: torch.from_numpy(v) for k, v in _batches(jcfg)[0].items()}
        _STATE[("grads", cfg.name)] = grad_tree(
            params, get_model(cfg).loss_fn(cfg, params, b)[0], unused_leaves(cfg))
    return _STATE[("grads", cfg.name)]


_CELLS = [pytest.param(a, dict(tp=2), id=f"tp2-{a}") for a in (*ARCHS, VL, MLA, ED)] + [
    pytest.param(MOE, dict(dp=2), id=f"dp2-{MOE}"),
    pytest.param(MOE, dict(dp=2, tp=2), id=f"dp2-tp2-{MOE}")]


@pytest.mark.parametrize("arch,plan_kw", _CELLS)
def test_world_cell_matches_the_fused_steps(pools, arch, plan_kw):
    """(a) Each cell's 2-step losses within rtol 2e-5 of the JAX package's
    fused step; (b) each rank's synced first-step gradient (its slice)
    within rtol 5e-4 / atol 1e-5 of the port's fused one, the embedding's
    rows and the head's columns of its vocabulary slice among them (and
    MLA's heads, the routed and shared experts, the cross attention's kv
    heads; the leaves kept whole, such as MLA's ``wdkv``, ``kv_norm`` and
    ``wkr`` and the router, whole); the whole master gathered on rank 0
    only; every rank reports the same loss, and the clip's global norm of
    the step-1 gradient (the sliced leaves' squares summed over the tensor
    ranks) is the fused gradient's."""
    cfg, jcfg = _cfgs(arch)
    world = plan_kw.get("dp", 1) * plan_kw.get("tp", 1)
    res = pools(world).run(tasks.train_cell, cfg, plan_kw, _state_np(jcfg),
                           _batches(jcfg), OCFG, 1)
    np.testing.assert_allclose(res[0]["losses"], _jax_losses(jcfg), rtol=2e-5)
    for r in res[1:]:
        np.testing.assert_allclose(r["losses"], res[0]["losses"], rtol=1e-6)
    assert res[0]["whole"] is not None and all(r["whole"] is None for r in res[1:])
    tp = plan_kw.get("tp", 1)
    dims = sp.tp_slices(cfg, tp)
    assert tp == 1 or ("embedding",) in dims
    fused = _fused_grads(cfg, jcfg)
    for r in res:
        np.testing.assert_allclose(r["metrics"][0]["grad_norm"],
                                   optim.global_norm(fused).item(), rtol=1e-5)
        want = dict(optim.leaves(shard_params(fused, dims, tp, r["coords"]["model"])))
        got = dict(optim.leaves(r["grads"]))
        assert set(got) == set(want)
        for path, g in got.items():
            np.testing.assert_allclose(g, want[path].numpy(), rtol=5e-4, atol=1e-5,
                                       err_msg=f"{r['coords']} {path}")


def test_moe_dp2_aux_terms_are_the_whole_batchs(pools):
    """(c) At dp 2 phi3.5-moe's aux loss and drop fraction are the whole
    batch's, from JAX's ``lm.loss_fn`` at the init parameters, on every
    rank; the data ranks' cross entropy shares sum to the whole one."""
    cfg, jcfg = _cfgs(MOE)
    res = pools(2).run(tasks.train_cell, cfg, dict(dp=2), _state_np(jcfg),
                       _batches(jcfg)[:1], OCFG, 1)
    _, m = jlm.loss_fn(jcfg, _jstate(jcfg)[0].params, _batches(jcfg)[0])
    for r in res:
        got = r["metrics"][0]
        np.testing.assert_allclose(got["aux_loss"], float(m["aux_loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["seg0_moe_drop_frac"],
                                   float(m["seg0_moe_drop_frac"]), rtol=1e-6)
        np.testing.assert_allclose(got["ce"], float(m["ce"]), rtol=2e-5)
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=2e-5)


def _token_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _masked_row_batch(cfg) -> dict:
    """Targets at both ends of each vocabulary slice, and a loss mask that
    zeros row 0 and scattered tokens of the others."""
    b = _token_batch(cfg, 1)
    half = cfg.padded_vocab // 2
    b["targets"][1, :4] = torch.tensor([0, half - 1, half, cfg.vocab_size - 1])
    mask = torch.from_numpy((np.random.default_rng(2).random((BATCH, SEQ)) > 0.2)
                            .astype(np.float32))
    mask[0] = 0.0
    return {**b, "loss_mask": mask}


# (arch, config changes, batch): the JAX init's parameters and the cells'
# first batch, or the port's seed-0 parameters on a batch of its own
_SPLIT_CASES = [pytest.param(a, {}, None, id=a) for a in (*ARCHS, VL, MLA, ED)] + [
    pytest.param(MOE, dict(vocab_size=250), _token_batch, id="padded-vocab-250"),
    pytest.param("minicpm-2b", {}, _token_batch, id="minicpm-2b"),
    pytest.param("qwen2-0.5b", {}, _token_batch, id="qwen2-0.5b-tied"),
    pytest.param("qwen2-0.5b", dict(vocab_size=250), _masked_row_batch, id="masked-row"),
]


@pytest.mark.parametrize("arch,change,batch", _SPLIT_CASES)
def test_one_process_split_equals_the_fused_loss(arch, change, batch):
    """The split run in one process (every slice here, from the whole tree:
    the reference the card's world cells are held to) gives the fused loss
    (rtol 5e-6) and gradients (rtol 5e-5 / atol 1e-6): over the vocabulary
    slices of the embedding and the cross entropy too, where the padded
    columns land in the last slice (phi3.5-moe's smoke config at vocab 250,
    padded to 256), the embedding is tied (qwen2-0.5b), minicpm scales the
    embeddings and the head's input, and the mask zeros a row; over MLA's
    heads, the shared experts and the dense first layer (deepseek-v2-lite)
    and the encoder-decoder's layers (seamless-m4t)."""
    if batch is None:
        cfg, jcfg = _cfgs(arch)
        params = from_jax_params(_state_np(jcfg)["params"], device="cpu")
        b = {k: torch.from_numpy(v) for k, v in _batches(jcfg)[0].items()}
        want = dict(optim.leaves(_fused_grads(cfg, jcfg)))
    else:
        cfg = _cfgs(arch)[0].replace(**change)
        params, b, want = lm.init(cfg, seed=0, device="cpu"), batch(cfg), None
    assert cfg.padded_vocab % 2 == 0 and ("embedding",) in sp.tp_slices(cfg, 2)
    for _, leaf in optim.leaves(params):
        leaf.requires_grad_(True)
    model = get_model(cfg)
    loss, _ = model.loss_fn(cfg, params, b, split=sp.make_split(cfg, 2))
    got = grad_tree(params, loss, unused_leaves(cfg))
    fused = model.loss_fn(cfg, params, b)[0]
    np.testing.assert_allclose(loss.item(), fused.item(), rtol=5e-6)
    if want is None:
        want = dict(optim.leaves(grad_tree(params, fused, unused_leaves(cfg))))
    for path, g in optim.leaves(got):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=5e-5, atol=1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", (*ARCHS, MLA, ED))
def test_shard_unshard_round_trips_bit_for_bit(arch):
    """(d) ``shard_params`` then ``unshard_params`` give back the whole
    tree, every leaf bit for bit; each slice is its share of the leaf
    (the encoder-decoder's layer-stacked ``encoder``/``decoder`` leaves
    along their own dim)."""
    cfg, _ = _cfgs(arch)
    tree = get_model(cfg).init(cfg, seed=0, device="cpu")
    dims = sp.tp_slices(cfg, 2)
    shards = [shard_params(tree, dims, 2, r) for r in range(2)]
    for path, d in dims.items():
        whole = dict(optim.leaves(tree))[path]
        for r, s in enumerate(shards):
            part = dict(optim.leaves(s))[path]
            assert part.shape[d] * 2 == whole.shape[d]
            assert torch.equal(part, whole.chunk(2, d)[r])
    back = unshard_params(shards, dims)
    for (pa, a), (pb, b) in zip(optim.leaves(back), optim.leaves(tree)):
        assert pa == pb and torch.equal(a, b)


def _jax_shapes(jcfg) -> dict:
    tree = jax.eval_shape(lambda: jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", (*ARCHS, "qwen2-0.5b", VL, MLA, ED))
def test_slices_follow_jax_model_axis_or_are_named(arch, smoke):
    """(e) For every leaf the dim the port slices is the one JAX's
    ``logical_to_spec`` puts on ``model`` under ``fsdp_cp`` on a
    ``{data: 1, model: 2}`` mesh (the axes of the family's model: the
    encoder-decoder's are ``encdec.param_axes``), or the leaf is kept whole
    and named in ``KEPT_WHOLE`` (P19: of MLA's leaves only ``wkr``; none of
    the encoder-decoder's); the table names no leaf JAX keeps whole, and
    slices the embedding and an untied head on their vocabulary dim."""
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    dims = sp.tp_slices(cfg, 2)
    shapes = _jax_shapes(jcfg)
    amesh = AbstractMesh((1, 2), ("data", "model"))
    named = set()
    for path, ax in sp._flat(jget_model(jcfg).param_axes(jcfg)):
        spec = tuple(jsharding.logical_to_spec(ax, shapes[path], amesh, jprofiles.FSDP_CP))
        theirs = [d for d, part in enumerate(spec)
                  if part == "model" or (isinstance(part, tuple) and "model" in part)]
        ours = [dims[path]] if path in dims else []
        if ours == theirs:
            continue
        assert not ours, (path, ours, theirs)
        keys = [k for k in sp.KEPT_WHOLE if path[-len(k):] == k]
        assert keys, f"{path}: JAX slices dim {theirs}, the port keeps it whole unnamed"
        named.update(keys)
    assert not named & {("embedding",), ("unembed",)}
    if cfg.use_mla:
        assert named == {("attn", "wkr")}
    if cfg.family == "encdec":
        assert not named
    assert dims[("embedding",)] == 0
    assert dims.get(("unembed",)) == (None if cfg.tie_embeddings else 1)
    assert set(dims) <= set(shapes)


@pytest.mark.parametrize("arch", (*ARCHS, "qwen2-0.5b", VL))
def test_pipeline_keeps_the_vocabulary_whole(arch):
    """At pp > 1 the table keeps the embedding and the head whole (stage 0
    runs them, as JAX's pipeline runs them outside its stages) and slices
    every other leaf as at pp = 1; a vocabulary that does not divide tp
    is then no reason to refuse."""
    cfg = get_config(arch, smoke=True)
    whole = {("embedding",), ("unembed",)}
    flat = sp.tp_slices(cfg, 2)
    assert sp.tp_slices(cfg, 2, pp=2) == {k: v for k, v in flat.items() if k not in whole}
    assert set(sp.PIPELINE_WHOLE) == whole and ("embedding",) in flat
    odd = cfg.replace(vocab_size=251, vocab_pad_to=1)
    sp.validate(odd, 2, pp=2)
    with pytest.raises(ValueError, match="padded_vocab=251 must divide by tp=2"):
        sp.validate(odd, 2)


@pytest.mark.parametrize("arch", [ED, MLA])
def test_later_families_refuse_tp_naming_item_8c(pools, arch):
    """The encoder-decoder and MLA, the last families the split took (item
    8c.1), build their split at tp 2 (``unsupported`` is None, the widths
    divide); what tp 2 still refuses over them names ROADMAP item 8c: int8
    gradient compression (item 8c.3), in a world of two ranks."""
    cfg = get_config(arch, smoke=True)
    assert sp.unsupported(cfg, 2) is None and sp.unsupported(cfg, 1) is None
    assert sp.make_split(cfg, 2).local.num_heads == cfg.num_heads // 2
    msgs = pools(2).run(tasks.refusal, cfg, dict(tp=2), True)
    assert all("int8" in m and "item 8c" in m for m in msgs), (arch, msgs)


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_config_splits_at_tp2(arch):
    """Every registered full config runs the tensor split at tp 2 (item
    8c.1 closed): nothing is unsupported, and every width divides."""
    cfg = get_config(arch)
    assert sp.unsupported(cfg, 2) is None
    sp.validate(cfg, 2)


def test_world_refusals_name_item_8c(pools):
    """In a world of two ranks int8 compression at tp 2 raises naming item
    8c; a width that does not divide raises a ``ValueError`` naming it:
    the experts, and the shared experts' width."""
    msgs = pools(2).run(tasks.refusal, get_config("qwen2-0.5b", smoke=True), dict(tp=2),
                        True)
    assert all("item 8c" in m for m in msgs), msgs
    with pytest.raises(ValueError, match="experts=3 must divide by tp=2"):
        cfg = get_config(MOE, smoke=True)
        sp.validate(cfg.replace(moe=cfg.moe.__class__(**{
            **cfg.moe.__dict__, "num_experts": 3})), 2)
    cfg = get_config(MLA, smoke=True)
    odd = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "expert_d_ff": 63}))
    with pytest.raises(ValueError, match="shared_d_ff=63 must divide by tp=2"):
        sp.make_split(odd, 2)
    msgs = pools(2).run(tasks.refusal, odd, dict(tp=2))
    assert all("shared_d_ff=63 must divide by tp=2" in m for m in msgs), msgs


def test_a_vocabulary_that_does_not_divide_is_refused(pools):
    """A padded vocabulary that does not divide tp raises a ``ValueError``
    naming it, in a world's step and in the split; nothing pads it."""
    cfg = get_config("qwen2-0.5b", smoke=True).replace(vocab_size=251, vocab_pad_to=1)
    msgs = pools(2).run(tasks.refusal, cfg, dict(tp=2))
    assert all("padded_vocab=251 must divide by tp=2" in m for m in msgs), msgs
    with pytest.raises(ValueError, match="padded_vocab=251 must divide by tp=2"):
        sp.make_split(cfg, 2)


def test_qwen2_vl_at_tp2_is_refused_by_the_loop_naming_r8():
    """``python -m repro_torch train --arch qwen2-vl-7b --set parallel.tp=2``
    still refuses: the loop feeds token batches (ROADMAP R8); the split
    itself takes qwen2-vl (``make_train_step``)."""
    with pytest.raises(SystemExit, match="R8"):
        cli.main(["train", "--smoke", "--device", "cpu", "--steps", "1",
                  "--arch", VL, "--set", "parallel.tp=2"])
    assert sp.unsupported(get_config(VL, smoke=True), 2) is None


def test_seamless_at_tp2_is_refused_by_the_loop_naming_r8():
    """``python -m repro_torch train --arch seamless-m4t-large-v2 --set
    parallel.tp=2`` still refuses, naming ROADMAP R8 (the loop feeds token
    batches, the encoder takes frames); the split itself takes the
    encoder-decoder (``make_train_step``)."""
    with pytest.raises(SystemExit, match="R8"):
        cli.main(["train", "--smoke", "--device", "cpu", "--steps", "1",
                  "--arch", ED, "--set", "parallel.tp=2"])
    assert sp.unsupported(get_config(ED, smoke=True), 2) is None


def test_tp2_encoder_decoder_checkpoint_resumes_in_one_process(pools, tmp_path):
    """seamless-m4t at tp 2 through ``make_train_step`` (its tree is the
    encoder's and the decoder's layer stacks): after step 2 the ranks'
    parts gathered on rank 0 are saved in the single-process format, as
    the loop saves them; that checkpoint cut again is each rank's part of
    the master and the moments bit for bit, and one process resumed from
    it takes step 3 to the world's loss."""
    from repro_torch.checkpoint.checkpointer import restore
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg, jcfg = _cfgs(ED)
    batches = _batches(jcfg, 3)
    res = pools(2).run(tasks.train_cell, cfg, dict(tp=2), _state_np(jcfg), batches,
                       OCFG, 1, (str(tmp_path), 2))
    saved, _ = restore(tmp_path, init_train_state(cfg, seed=0, device="cpu"))
    dims = sp.tp_slices(cfg, 2)
    assert ("decoder", "cross", "wk") in dims
    for r, rank in enumerate(res):
        for key, tree in (("master", saved.master), ("m", saved.opt["m"]),
                          ("v", saved.opt["v"])):
            want = dict(optim.leaves(shard_params(tree, dims, 2, r)))
            got = dict(optim.leaves(rank["saved"][key]))
            assert set(got) == set(want)
            for path, leaf in got.items():
                np.testing.assert_array_equal(leaf, want[path].numpy(),
                                              err_msg=f"rank {r} {key} {path}")
    assert saved.opt["step"] == 2
    _, m = make_train_step(cfg, optim.OptimizerConfig(**OCFG))(saved, batches[2])
    np.testing.assert_allclose(float(m["loss"]), res[0]["losses"][2], rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_checkpoint_resumes_in_one_process(pools, tmp_path, arch):
    """``python -m repro_torch train --smoke --device cpu --set
    parallel.tp=2`` runs (here on the pool's ranks, as under ``torchrun``);
    its checkpoint is the whole tree in the single-process format (the
    ranks' vocabulary slices regathered: cut again, each rank's part of the
    final master and moments bit for bit), and one process resumes from
    it."""
    from repro_torch.checkpoint.checkpointer import restore
    from repro_torch.train.train_step import init_train_state

    base = ["train", "--arch", arch, "--smoke", "--device", "cpu",
            "--set", "train.seq_len=32", "--set", "train.global_batch=2",
            "--modules", "none", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    two = pools(2).run(tasks.run_cli, [*base, "--steps", "2", "--set", "parallel.tp=2"])
    assert [r["world"] for r in two] == [2, 2]
    assert all(np.isfinite(h["loss"]) for h in two[0]["history"])
    cfg = get_config(arch, smoke=True)
    saved, _ = restore(tmp_path, init_train_state(cfg, seed=0, device="cpu"))
    dims = sp.tp_slices(cfg, 2)
    assert ("embedding",) in dims
    for r, rank in enumerate(two):
        for key, tree in (("master", saved.master), ("m", saved.opt["m"]),
                          ("v", saved.opt["v"])):
            want = dict(optim.leaves(shard_params(tree, dims, 2, r)))
            got = dict(optim.leaves(rank["state"][key]))
            assert set(got) == set(want)
            for path, leaf in got.items():
                np.testing.assert_array_equal(leaf, want[path].numpy(),
                                              err_msg=f"rank {r} {key} {path}")
    three = cli.run([*base, "--steps", "3"])
    assert [h["step"] for h in three["history"]] == [3]
    assert np.isfinite(three["history"][0]["loss"])
