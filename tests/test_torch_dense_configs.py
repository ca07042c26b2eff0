"""The remaining dense configs in the port against the JAX package on the CPU,
in float32: minitron-4b (squared-ReLU MLP, no ``w_gate``), minicpm-2b (MHA,
``scale_emb``, logits over ``d_model / dim_model_base``, depth-scaled
residuals, tied embeddings) and qwen2-vl-7b (QKV bias, M-RoPE, input
embeddings in place of token ids).

Both sides get the same weights (JAX ``lm.init`` with the norm scales and
QKV biases redrawn from numpy, through ``from_jax_params``) and the same
numpy batch.  ``make_batch`` gives qwen2-vl three equal M-RoPE streams,
under which M-RoPE equals 1-D rope, so every M-RoPE case here also runs a
patch grid (:func:`patch_grid_ids`): text, then an image whose patches share
one temporal id and take their rows and columns as height and width ids,
then text again from past the grid's largest id.  Tolerances as in
``tests/test_torch_train.py``: float32 sums in another order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import make_batch as jmake_batch  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    from_jax_params,
    from_jax_train_state,
)
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.serve.engine import make_prefill_step  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    grad_tree,
    make_train_step,
    unused_leaves,
)

DENSE = ["minitron-4b", "minicpm-2b", "qwen2-vl-7b"]
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
ROPE_TOL = 1e-6
# the dense cache is bfloat16 on both sides (P1 in ROADMAP.md: a float32
# ulp may flip one cached rounding); relative to the largest logit
CACHED_LOGIT_RTOL = 1e-4
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-3


def patch_grid_ids(B: int, before: int, grid: tuple[int, int], after: int
                   ) -> np.ndarray:
    """M-RoPE ids ``[3, B, S]`` of ``before`` text tokens, an image of
    ``grid`` = (rows, columns) patches (t fixed at the image's start, h and
    w its row and column from there) and ``after`` text tokens from one
    past the largest id so far; each batch row shifted by its index, so the
    rows differ too."""
    rows, cols = grid
    ids = [(p, p, p) for p in range(before)]
    ids += [(before, before + r, before + c) for r in range(rows) for c in range(cols)]
    nxt = before + max(rows, cols)
    ids += [(nxt + p, nxt + p, nxt + p) for p in range(after)]
    one = np.asarray(ids, dtype=np.int32).T            # [3, S]
    return np.stack([one + b for b in range(B)], axis=1)


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for i in range(len(jlm.segment_layout(cfg))):
        blk = params[f"seg{i}"]["b0"]
        for tree, names in ((blk["attn"], ("bq", "bk", "bv")),
                            (blk["ln1"], ("scale",)), (blk["ln2"], ("scale",))):
            for n in names:
                if n in tree:
                    base = 0.0 if n.startswith("b") else 1.0
                    tree[n] = (base + 0.3 * rng.standard_normal(tree[n].shape)
                               ).astype(np.float32)
    params["final_norm"]["scale"] = (
        1.0 + 0.3 * rng.standard_normal(params["final_norm"]["scale"].shape)
    ).astype(np.float32)
    return params


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _batch(cfg, B, S, seed, grid=False):
    """One numpy batch: token ids, or embeddings with ``make_batch``'s equal
    M-RoPE streams or (``grid``) a patch grid."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.input_kind == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return out
    out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if grid:
        out["mrope_position_ids"] = patch_grid_ids(B, 3, (4, 5), S - 23)
    else:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out["mrope_position_ids"] = np.stack([pos, pos, pos])
    return out


def _flat(tree):
    return [(p, v) for p, v in optim.leaves(tree)]


def _shapes(tree):
    return {p: tuple(v.shape) for p, v in _flat(tree)}


# ---------------------------------------------------------------- layers ---


@pytest.mark.parametrize("grid", [True, False], ids=["patch_grid", "equal_streams"])
def test_apply_mrope_matches_jax(grid):
    """M-RoPE at qwen2-vl's full head dim and sections, bfloat16 and float32
    inputs; with three equal streams it equals 1-D rope."""
    cfg = get_config("qwen2-vl-7b")
    rng = np.random.default_rng(0)
    B, S = 2, 40
    ids = (patch_grid_ids(B, 5, (6, 4), S - 29) if grid else
           np.stack([np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))] * 3))
    x = rng.standard_normal((B, S, 4, cfg.head_dim)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JL.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(ids),
                                         cfg.mrope_sections, cfg.rope_theta)
                          ).astype(np.float32)
        got = L.apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(ids),
                            cfg.mrope_sections, cfg.rope_theta).float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_TOL)
        else:  # one bfloat16 rounding of the same float32 value, or its neighbour
            assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    if not grid:
        rope = L.apply_rope(torch.from_numpy(x), torch.arange(S), cfg.rope_theta)
        np.testing.assert_array_equal(
            L.apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                          cfg.mrope_sections, cfg.rope_theta).numpy(), rope.numpy())


def test_relu2_mlp_matches_jax_and_has_no_gate():
    jcfg, cfg = _cfgs("minitron-4b")
    params = _jax_params(jcfg)
    mlp = jax.tree.map(lambda a: a[0], params["seg0"]["b0"]["mlp"])
    assert set(mlp) == {"w_up", "w_down"}
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = np.asarray(JL.mlp_apply(jax.tree.map(jnp.asarray, mlp), jcfg, jnp.asarray(x)))
    got = L.mlp_apply({k: torch.tensor(np.asarray(v)) for k, v in mlp.items()},
                      cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_equals_jax(arch):
    """The port's ``lm.init`` tree has JAX's leaves and shapes: no
    ``w_gate`` under relu2, no ``unembed`` where the embeddings are tied."""
    jcfg, cfg = _cfgs(arch)
    ours = _shapes(lm.init(cfg, seed=0, device="cpu"))
    ref = _shapes(jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0))))
    assert ours == ref
    assert (("unembed",) in ours) == (not cfg.tie_embeddings)
    assert (("seg0", "b0", "mlp", "w_gate") in ours) == (cfg.mlp_kind != "relu2")


# ------------------------------------------------------- loss and grads ---


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch,grid", [("minitron-4b", False), ("minicpm-2b", False),
                                       ("qwen2-vl-7b", False), ("qwen2-vl-7b", True)],
                         ids=["minitron", "minicpm", "qwen2vl", "qwen2vl_grid"])
def test_loss_and_grads_match_jax(arch, grid, remat):
    """Loss and every gradient leaf against ``jax.value_and_grad(lm.loss_fn)``
    at seq 48 (the flash branch: K2's plain version against ``_make_flash``);
    minicpm's scales and tied embeddings, qwen2-vl's embeddings and M-RoPE."""
    jcfg, cfg = _cfgs(arch, remat=remat)
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, 48, seed=5, grid=grid)

    def jloss(p):
        return jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tp = from_jax_params(params, device="cpu")
    for _, leaf in _flat(tp):
        leaf.requires_grad_(True)
    loss, metrics = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    # qwen2-vl's embedding table is unused: jax.grad gives it zeros
    grads = dict(_flat(grad_tree(tp, loss, unused_leaves(cfg))))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert metrics["aux_loss"].item() == 0.0
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        ref = jflat[path]
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-6), (path, err)


def test_grad_tree_allows_only_the_unused_embedding():
    """Only an untied embeds arch's ``embedding`` table may miss the loss
    (zeros, as ``jax.grad`` gives it); any other such leaf raises, as it
    does for every leaf of a token arch."""
    assert unused_leaves(get_config("qwen2-vl-7b", smoke=True)) == (("embedding",),)
    for arch in ("minitron-4b", "minicpm-2b", "phi3.5-moe-42b-a6.6b"):
        assert unused_leaves(get_config(arch, smoke=True)) == ()
    params = {"embedding": torch.ones(3, requires_grad=True),
              "w": torch.ones(3, requires_grad=True),
              "cut": torch.ones(3, requires_grad=True)}
    def loss():
        return (params["w"] * 2).sum()

    with pytest.raises(RuntimeError, match="not have been used"):
        grad_tree(params, loss())
    with pytest.raises(RuntimeError, match="cut does not reach the loss"):
        grad_tree(params, loss(), (("embedding",),))
    grads = grad_tree(params, loss(), (("embedding",), ("cut",)))
    assert torch.equal(grads["embedding"], torch.zeros(3))
    assert torch.equal(grads["w"], torch.full((3,), 2.0))


def test_mrope_grid_moves_the_loss():
    """The patch grid is not a no-op: its loss differs from the equal
    streams' on the same embeddings (as JAX's does)."""
    jcfg, cfg = _cfgs("qwen2-vl-7b")
    tp = from_jax_params(_jax_params(jcfg), device="cpu")
    grid, flat = _batch(cfg, 2, 48, 5, grid=True), _batch(cfg, 2, 48, 5)
    losses = [lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in b.items()})[0].item()
              for b in (grid, flat)]
    assert abs(losses[0] - losses[1]) > 1e-4


def test_make_batch_matches_jax_layout():
    """``make_batch`` gives JAX's keys, shapes and dtypes for an embeds arch,
    float32 N(0, 1) embeddings and three equal ``arange`` streams, drawn
    from the numpy generator; token archs keep ``tokens``/``targets``."""
    jcfg, cfg = _cfgs("qwen2-vl-7b")
    ref = jmake_batch(jcfg, 3, 10, jax.random.PRNGKey(0))
    a = make_batch(cfg, 3, 10, np.random.default_rng(0))
    b = make_batch(cfg, 3, 10, np.random.default_rng(0))
    assert set(a) == set(ref) == {"embeds", "mrope_position_ids", "targets"}
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape, k
        assert str(a[k].dtype).split(".")[-1] == str(ref[k].dtype), k
        assert torch.equal(a[k], b[k])
    np.testing.assert_array_equal(a["mrope_position_ids"].numpy(),
                                  np.asarray(ref["mrope_position_ids"]))
    assert abs(float(a["embeds"].std()) - 1.0) < 0.1
    assert set(make_batch(get_config("minicpm-2b", smoke=True), 2, 4,
                          np.random.default_rng(0))) == {"tokens", "targets"}


# ------------------------------------------------------ the cached path ---


def test_qwen2_vl_prefill_and_decode_match_jax():
    """JAX ``lm.prefill`` over patch-grid embeddings, then 3 ``decode_step``s
    (one embedding row a step, ids ``broadcast(pos, (3, B, 1))``), against
    the port's cached forward over the same dense cache layout."""
    jcfg, cfg = _cfgs("qwen2-vl-7b")
    params = _jax_params(jcfg)
    B, P, steps = 2, 29, 3
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((B, P + steps, cfg.d_model)).astype(np.float32)
    ids = patch_grid_ids(B, 3, (4, 4), P - 19)
    T = P + steps + 3
    jp = jax.tree.map(jnp.asarray, params)
    jcache = jlm.init_cache(jcfg, B, T)
    jcache, jlog = jlm.prefill(jcfg, jp, {"embeds": jnp.asarray(emb[:, :P]),
                                          "mrope_position_ids": jnp.asarray(ids)},
                               jcache)
    want = [np.asarray(jlog)]
    for i in range(steps):
        jcache, jlog = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(emb[:, P + i]),
                                       jnp.int32(P + i))
        want.append(np.asarray(jlog))
    tp = from_jax_params(params, device="cpu")
    cache = lm.init_cache(cfg, B, T, device="cpu")
    with torch.no_grad():
        h, _ = lm.forward(cfg, tp, embeds=torch.from_numpy(emb[:, :P]),
                          mrope_position_ids=torch.from_numpy(ids), cache=cache,
                          cache_pos=0)
        got = [L.logits_fn(tp, cfg, h[:, -1:])[:, 0]]
        for i in range(steps):
            pos = P + i
            h, _ = lm.forward(cfg, tp, embeds=torch.from_numpy(emb[:, pos:pos + 1]),
                              mrope_position_ids=torch.full((3, B, 1), pos,
                                                            dtype=torch.int32),
                              cache=cache, cache_pos=pos)
            got.append(L.logits_fn(tp, cfg, h)[:, 0])
    for i, (g, w) in enumerate(zip(got, want)):
        w = w[:, :cfg.vocab_size]
        err = np.abs(g.numpy()[:, :cfg.vocab_size] - w).max()
        assert err <= CACHED_LOGIT_RTOL * np.abs(w).max(), (i, err)


def test_qwen2_vl_decode_step_from_embeddings_matches_jax():
    """The entry points end to end: JAX ``lm.prefill`` and 3 ``decode_step``s
    on one embedding row a step against the port's ``lm.prefill`` and
    ``lm.decode_step`` (which build the M-RoPE ids from ``pos`` as JAX
    does), the rows given as ``[B, 1, D]`` and, at the last step, ``[B, D]``."""
    jcfg, cfg = _cfgs("qwen2-vl-7b")
    params = _jax_params(jcfg, seed=1)
    B, P, steps = 2, 21, 3
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((B, P + steps, cfg.d_model)).astype(np.float32)
    ids = patch_grid_ids(B, 2, (3, 4), P - 14)
    T = P + steps
    jp = jax.tree.map(jnp.asarray, params)
    jcache = jlm.init_cache(jcfg, B, T)
    jcache, jlog = jlm.prefill(jcfg, jp, {"embeds": jnp.asarray(emb[:, :P]),
                                          "mrope_position_ids": jnp.asarray(ids)},
                               jcache)
    want = [np.asarray(jlog)]
    for i in range(steps):
        jcache, jlog = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(emb[:, P + i:P + i + 1]),
                                       jnp.int32(P + i))
        want.append(np.asarray(jlog))
    tp = from_jax_params(params, device="cpu")
    cache = lm.init_cache(cfg, B, T, device="cpu")
    with torch.no_grad():
        first, _ = lm.prefill(cfg, tp, {"embeds": torch.from_numpy(emb[:, :P]),
                                        "mrope_position_ids": torch.from_numpy(ids)},
                              cache)
        got = [first]
        for i in range(steps):
            row = torch.from_numpy(emb[:, P + i:P + i + 1])
            logits, _ = lm.decode_step(cfg, tp, cache,
                                       row[:, 0] if i == steps - 1 else row, P + i)
            got.append(logits)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w[:, :cfg.vocab_size]
        err = np.abs(g.numpy()[:, :cfg.vocab_size] - w).max()
        assert err <= CACHED_LOGIT_RTOL * np.abs(w).max(), (i, err)


def test_qwen2_vl_trajectory_matches_jax_with_grad_accum():
    """Three ``make_train_step`` steps at ``grad_accum=2`` on patch-grid
    batches: each microbatch takes its rows of the ``[3, B, S]`` ids."""
    jcfg, cfg = _cfgs("qwen2-vl-7b")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    master = _jax_params(jcfg)
    jm = jax.tree.map(jnp.asarray, master)
    jstate = JTrainState(params=jm, master=jm, opt=joptim.init_opt_state(jm))
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, joptim.OptimizerConfig(**kw), grad_accum=2))
    tstep = make_train_step(cfg, optim.OptimizerConfig(**kw), grad_accum=2)
    for i in range(3):
        batch = _batch(cfg, 4, 32, seed=200 + i, grid=True)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert tmet[key].item() == pytest.approx(float(jmet[key]), rel=1e-5), (i, key)
    ref = dict(_flat(jax.tree.map(np.asarray, jstate.master)))
    for path, leaf in _flat(tstate.master):
        scale = max(np.abs(ref[path]).max(), 1.0)
        assert np.abs(leaf.numpy() - ref[path]).max() <= TRAJ_RTOL * scale + TRAJ_ATOL, path


# ---------------------------------------------------------- serving ---


def _serve_both(arch, prompts, max_new, **geom):
    jcfg, cfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    jsrv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                        JaxServeConfig(decode_path="paged", prefill_path="flash",
                                       paged_attn_impl="xla", **geom))
    srv = MegaServe(cfg, from_jax_params(params, device="cpu"), ServeConfig(**geom),
                    device="cpu")
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p, max_new, arrival=0.0)
    return jsrv.drain(), srv.drain(), srv


@pytest.mark.parametrize("arch", ["minitron-4b", "minicpm-2b"])
def test_served_streams_equal_jax(arch):
    """MegaServe's paged path (flash prefill, paged decode) gives JAX
    MegaServe's greedy streams token for token: minitron's relu2 at G = 2,
    minicpm's MHA (G = 1), scaled embeddings and logits, tied unembedding
    and its padded vocab (257 of 512)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (5, 17, 40)]
    want, got, srv = _serve_both(arch, prompts, 8, num_slots=3, block_size=16,
                                 num_blocks=24, max_blocks_per_slot=4)
    assert got == want
    assert srv.decode_path == "paged" and srv.prefill_path == "flash"
    assert all(len(s) == 8 and max(s) < cfg.vocab_size for s in got.values())


# -------------------------------------------------------------- refusals ---


def test_embeds_arch_is_refused_by_the_loop_session_and_server():
    """R8: the loop and ``Session.train`` refuse qwen2-vl before a first step
    (JAX's loop reaches ``KeyError: 'embeds'``); serving refuses it, as
    JAX's engine and Session do."""
    cfg = get_config("qwen2-vl-7b", smoke=True)
    with pytest.raises(ValueError, match="R8"):
        train(cfg, optim.OptimizerConfig(), DataConfig(cfg.vocab_size, 16, 2),
              LoopConfig(n_steps=1), device="cpu")
    with pytest.raises(ValueError, match="R8"):
        cli.run(["train", "--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                 "--steps", "1"])
    with pytest.raises(ValueError, match="token archs"):
        cli.run(["serve", "--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                 "--continuous"])
    with pytest.raises(ValueError, match="token archs"):
        make_prefill_step(cfg)
    with pytest.raises(ValueError, match="input embeddings"):
        lm.forward(cfg, lm.init(cfg, device="cpu"), torch.zeros(1, 4, dtype=torch.long))
