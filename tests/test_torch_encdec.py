"""The encoder-decoder family (seamless-m4t-large-v2) in the port against the
JAX package on the CPU, on the smoke config (2 encoder and 2 decoder layers,
d 64, 4 heads of 16, GeGLU, layernorm, ``attn_kv_chunk`` 32) in float32.

Both sides get the same weights (JAX ``encdec.init`` with every norm scale
and bias redrawn from numpy, through ``from_jax_params``) and one numpy
batch.  Sources and targets longer than ``attn_kv_chunk`` put all three
attentions on the flash branch (K2's plain versions, against JAX's
``_make_flash``): the encoder's bidirectional self-attention, the
cross-attention over the memory (S queries over T frames) and the
decoder's causal self-attention.

The cases: layernorm; the init tree; ``encode``; the loss and every
gradient with source length apart from the target's and equal to it;
``prefill`` then 4 ``decode_step``s over the bfloat16 cache with a prompt
shorter than the source; a 3-step ``make_train_step`` trajectory; the tags
of a collector (``att_resid``, ``cross_attn_out``, layer by layer) and a
MegaScope capture; static serving through the engine steps against JAX's
``encdec.prefill``/``decode_step`` called directly (JAX's own static
Session fails on this tree, ROADMAP R3), and through the Session and the
CLI against the engine steps; ``make_batch``; the refusals (continuous
serving, the train loop, pp > 1) and the flash branch's positions check.

Tolerances: float32 on both sides differs only in the order of sums.
Outputs and tags within ``TOL`` (1e-5) of the reference's largest entry;
the loss within ``LOSS_RTOL`` (2e-6) relative; gradients within
``GRAD_TOL`` (2e-5) of each leaf's largest entry; cached logits within
``CACHED_LOGIT_RTOL`` (1e-4: the cache is bfloat16 on both sides, and a
float32 ulp can tip one rounding, ROADMAP P1) and cache leaves within one
bfloat16 ulp of the leaf's largest entry; the trajectory as
``tests/test_torch_train.py`` holds it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.hooks import Collector as JCollector  # noqa: E402
from repro.models.model import make_batch as jmake_batch  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scope.collector import ProbeSpec, ScopeCollector  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import pipeline as pl  # noqa: E402
from repro_torch.models.hooks import Collector  # noqa: E402
from repro_torch.models.model import ENCDEC, get_model, make_batch  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from repro_torch.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    grad_tree,
    make_train_step,
    unused_leaves,
)

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
CACHED_LOGIT_RTOL = 1e-4
CACHE_RTOL = 2.0 ** -8
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-3


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


@pytest.fixture(scope="module")
def smoke():
    """The float32 configs and JAX's parameters, every norm's scale and
    bias redrawn (a dropped bias or a swapped norm shows)."""
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jed.init(jcfg, k))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for path, v in optim.leaves(params):
        if path[-1] in ("scale", "bias"):
            base = 1.0 if path[-1] == "scale" else 0.0
            optim.parent(params, path)[path[-1]] = (
                base + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
    return jcfg, cfg, params


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


def _batch(cfg, B, T, S, seed):
    """Source frames ``[B, T, D]``, target tokens and targets ``[B, S]``, a
    loss mask."""
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ layers ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """``norm_apply``'s layernorm (float32 math, mean out, scale and bias,
    cast back) against JAX ``norm_apply``, on float32 and bfloat16 rows
    (within one bfloat16 ulp of the largest entry)."""
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((5, 7, 96))).astype(np.float32)
    p = {"scale": (1 + 0.3 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.3 * rng.standard_normal(96)).astype(np.float32)}
    want = JL.norm_apply(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x).astype(dtype), "layernorm", 1e-6)
    got = L.norm_apply(_torch(p), torch.from_numpy(x).to(getattr(torch, dtype)),
                       "layernorm", 1e-6)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    # bfloat16 out: a float32 ulp apart can tip one rounding
    _close(got.float(), np.asarray(want, np.float32),
           TOL if dtype == "float32" else CACHE_RTOL)


def test_init_tree_matches_jax(smoke):
    """``get_model`` gives ``ENCDEC``; its init has JAX's leaf paths and
    shapes (``embedding``, ``unembed``, ``enc_final_norm``, ``final_norm``,
    the layer-stacked ``encoder`` and ``decoder``), JAX's values cross leaf
    by leaf, and ``init(dtype=bf16)`` equals the float32 init cast by
    ``cast_params`` (norm scales and biases float32 in both)."""
    jcfg, cfg, params = smoke
    assert get_model(cfg) is ENCDEC and get_model(get_config(ARCH)) is ENCDEC
    ours = encdec.init(cfg, seed=0, device="cpu")
    shapes = {p: tuple(v.shape) for p, v in optim.leaves(ours)}
    assert shapes == {p: tuple(v.shape) for p, v in optim.leaves(params)}
    assert set(ours) == {"embedding", "unembed", "enc_final_norm", "final_norm",
                         "encoder", "decoder"}
    assert shapes[("decoder", "cross", "wq")] == (2, 64, 4, 16)
    assert shapes[("encoder", "ln1", "bias")] == (2, 64)
    crossed = from_jax_params(params, device="cpu")
    back = to_jax_params(crossed)
    for path, v in optim.leaves(params):
        assert np.array_equal(optim.parent(back, path)[path[-1]], v), path
    cast = lm.cast_params(ours, torch.bfloat16, torch.device("cpu"))
    drawn = encdec.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for (path, a), (_, b) in zip(optim.leaves(cast), optim.leaves(drawn)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert drawn["decoder"]["ln_cross"]["bias"].dtype == torch.float32
    assert drawn["decoder"]["cross"]["wk"].dtype == torch.bfloat16


def test_encode_matches_jax(smoke):
    """The memory of 48 frames (past ``attn_kv_chunk``: bidirectional K2
    plain) against JAX ``encode``, launching nothing on the CPU."""
    from repro_torch.kernels import flash_attention

    jcfg, cfg, params = smoke
    emb = np.random.default_rng(2).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, e: jed.encode(jcfg, p, e))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(emb))
    before = dict(flash_attention.launches)
    got, caps = encdec.encode(cfg, from_jax_params(params, device="cpu"),
                              torch.from_numpy(emb))
    assert flash_attention.launches == before and caps == {}
    _close(got.detach(), want)


# ---------------------------------------------------------- loss and grads ---


@pytest.mark.parametrize("T,S,remat", [(48, 40, "full"), (48, 48, "none")],
                         ids=["src48_tgt40_full", "src48_tgt48_none"])
def test_loss_and_grads_match_jax(smoke, T, S, remat):
    """Loss, metrics and every gradient leaf against ``jax.value_and_grad(
    encdec.loss_fn)``: every leaf reaches the loss (``unused_leaves`` is
    empty for the family: the decoder takes tokens)."""
    jcfg, cfg, params = smoke
    jcfg, cfg = jcfg.replace(remat=remat), cfg.replace(remat=remat)
    batch = _batch(cfg, 2, T, S, seed=3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jed.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(params, device="cpu")
    for _, leaf in optim.leaves(tp):
        leaf.requires_grad_(True)
    loss, metrics = encdec.loss_fn(cfg, tp, _torch(batch))
    assert unused_leaves(cfg) == ()
    grads = dict(optim.leaves(grad_tree(tp, loss, unused_leaves(cfg))))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert set(metrics) == set(jm) == {"loss", "ce", "aux_loss"}
    assert metrics["aux_loss"].item() == 0.0
    jflat = dict(optim.leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        _close(g, jflat[path], GRAD_TOL)


# --------------------------------------------------------- the cached path ---


def test_prefill_and_decode_match_jax(smoke):
    """JAX ``prefill`` (48 source frames, a 40-token prompt, cache length
    48) then 4 ``decode_step``s against the port's over its bfloat16 cache
    (``init_cache``: ``k``/``v`` ``[L, B, 48, K, dh]``, ``ck``/``cv`` at the
    source length): logits after every step, every cache leaf at the end."""
    jcfg, cfg, params = smoke
    B, T, P, steps = 2, 48, 40, 4
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    jcache, jlog = jax.jit(lambda p, b, c: jed.prefill(jcfg, p, b, c))(
        jp, {"embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks[:, :P])},
        jed.init_cache(jcfg, B, P + steps, T))
    decode = jax.jit(lambda p, c, t, pos: jed.decode_step(jcfg, p, c, t, pos))
    tp = from_jax_params(params, device="cpu")
    cache = encdec.init_cache(cfg, B, P + steps, T, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    with torch.no_grad():
        log, _ = encdec.prefill(cfg, tp, {"embeds": torch.from_numpy(emb),
                                          "tokens": torch.from_numpy(toks[:, :P])}, cache)
        _close(log, jlog, CACHED_LOGIT_RTOL)
        for i in range(steps):
            pos = P + i
            jcache, jlog = decode(jp, jcache, jnp.asarray(toks[:, pos]), jnp.int32(pos))
            log, _ = encdec.decode_step(cfg, tp, cache, torch.from_numpy(toks[:, pos]), pos)
            _close(log, jlog, CACHED_LOGIT_RTOL)
    for k, v in cache.items():
        _close(v.float(), np.asarray(jcache[k], np.float32), CACHE_RTOL)


def test_trajectory_matches_jax(smoke):
    """Three ``make_train_step`` steps (AdamW, lr 3e-3) from one converted
    ``TrainState`` on three ``make_batch`` batches: loss, grad_norm and lr
    each step, every master leaf at the end."""
    jcfg, cfg, params = smoke
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jm = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(params=jm, master=jm, opt=joptim.init_opt_state(jm))
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, joptim.OptimizerConfig(**kw)))
    tstep = make_train_step(cfg, optim.OptimizerConfig(**kw))
    for i in range(3):
        batch = {k: v.numpy() for k, v in
                 make_batch(cfg, 2, 40, np.random.default_rng(100 + i)).items()}
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert tmet[key].item() == pytest.approx(float(jmet[key]), rel=1e-5), (i, key)
    ref = dict(optim.leaves(jax.tree.map(np.asarray, jstate.master)))
    for path, leaf in optim.leaves(tstate.master):
        scale = max(np.abs(ref[path]).max(), 1.0)
        assert np.abs(leaf.numpy() - ref[path]).max() <= TRAJ_RTOL * scale + TRAJ_ATOL, path


# --------------------------------------------------------------- captures ---


class _JTags(JCollector):
    """Keeps the tags it sees, with their layers, as traced values of the
    one jitted trace (the layer scan unrolled, no remat), for the jitted
    function to return."""

    def __init__(self):
        self.seen = []

    def tag(self, name, x, **meta):
        if name in ("att_resid", "cross_attn_out"):
            self.seen.append((name, meta["layer"], x))
        return x


class _Tags(Collector):
    def __init__(self):
        self.seen = []

    def tag(self, name, x, *, layer=None, record=True, **meta):
        if record and name in ("att_resid", "cross_attn_out"):
            self.seen.append((name, layer, x.detach().numpy()))
        return x


def test_captures_match_jax(smoke):
    """The ``att_resid`` and ``cross_attn_out`` tags, in order and layer by
    layer (the encoder's, then the decoder's; the port under remat full,
    whose recompute records nothing), against JAX's loss with its layer
    scan unrolled and no remat; a MegaScope probe through
    ``make_train_step`` captures both, stacked over the decoder's layers
    (``att_resid`` over the encoder's too) and finite."""
    jcfg, cfg, params = smoke
    batch = _batch(cfg, 2, 40, 36, seed=5)
    jtags, tags = _JTags(), _Tags()

    def jtagged(p, b):
        jed.loss_fn(jcfg.replace(scan_unroll=True, remat="none"), p, b, jtags)
        return [(g, x) for _, g, x in jtags.seen]

    seen = jax.jit(jtagged)(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, batch))
    jtags.seen = [(n, int(g), np.asarray(x)) for (n, _, _), (g, x) in zip(jtags.seen, seen)]
    encdec.loss_fn(cfg, from_jax_params(params, device="cpu"), _torch(batch), tags)
    L_ = cfg.num_layers
    assert [(n, g) for n, g, _ in tags.seen] == [(n, g) for n, g, _ in jtags.seen] == (
        [("att_resid", g) for g in range(L_)]
        + [(n, g) for g in range(L_) for n in ("att_resid", "cross_attn_out")])
    for (_, _, got), (_, _, want) in zip(tags.seen, jtags.seen):
        _close(got, want)
    col = ScopeCollector([ProbeSpec("cross_attn_out"), ProbeSpec("att_resid")])
    jstate = JTrainState(params=params, master=params, opt=joptim.init_opt_state(params))
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    _, met = make_train_step(cfg, optim.OptimizerConfig(), collector=col)(state, batch)
    caps = met["captures"]
    assert set(caps) == {"encoder", "decoder"}
    assert set(caps["encoder"]) == {"att_resid.stats"}
    assert set(caps["decoder"]) == {"att_resid.stats", "cross_attn_out.stats"}
    for part in caps.values():
        for v in lm.tree_leaves(part):
            assert v.shape[0] == L_ and torch.isfinite(v).all()


# ----------------------------------------------------------------- serving ---


def _greedy_steps(cfg, params, prompts, emb, max_new):
    """The port's static engine steps: prefill then ``max_new - 1`` decode
    steps over ``init_cache(B, P + max_new, P)``, greedy tokens ``[B,
    max_new]``."""
    B, P = prompts.shape
    cache = get_model(cfg).init_cache(cfg, B, P + max_new, P, device="cpu")
    logits, _ = make_prefill_step(cfg)(params, {"tokens": prompts, "embeds": emb}, cache)
    tok = logits.argmax(-1)
    out, decode = [tok], make_decode_step(cfg)
    for i in range(max_new - 1):
        _, tok, _ = decode(params, cache, tok, P + i)
        out.append(tok)
    return torch.stack(out, 1).tolist()


def test_static_steps_greedy_equal_jax(smoke):
    """The static engine steps' greedy tokens equal JAX's ``encdec.prefill``
    and ``decode_step`` called directly (as JAX's ``_serve_static`` calls
    them) on the same prompts and frames, token for token: 2 x 40, 6 new."""
    jcfg, cfg, params = smoke
    B, P, new = 2, 40, 6
    rng = np.random.default_rng(6)
    prompts = rng.integers(2, cfg.vocab_size, (B, P))
    emb = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jcache, jlog = jax.jit(lambda p, b, c: jed.prefill(jcfg, p, b, c))(
        jp, {"tokens": jnp.asarray(prompts), "embeds": jnp.asarray(emb)},
        jed.init_cache(jcfg, B, P + new, P))
    decode = jax.jit(lambda p, c, t, pos: jed.decode_step(jcfg, p, c, t, pos))
    tok = jnp.argmax(jlog, -1)
    want = [tok]
    for i in range(new - 1):
        jcache, jlog = decode(jp, jcache, tok, jnp.int32(P + i))
        tok = jnp.argmax(jlog, -1)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1).tolist()
    got = _greedy_steps(cfg, from_jax_params(params, device="cpu"),
                        torch.from_numpy(prompts), torch.from_numpy(emb), new)
    assert got == want


def test_session_and_cli_serve_statically():
    """``serve --arch seamless-m4t-large-v2 --smoke --device cpu --batch 2
    --prompt-len 40 --max-new 4`` (bf16, the smoke config as registered)
    exits 0 and gives the engine steps' tokens on its prompts, the frames
    drawn after them from the run's generator and the weights of its seed."""
    out = cli.run(["serve", "--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "40", "--max-new", "4"])
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, 40))
    assert out["session"].results["static_prompts"] == prompts.tolist()
    emb = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    params = encdec.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    want = _greedy_steps(cfg, params, torch.from_numpy(prompts), emb.bfloat16(), 4)
    assert out["outputs"] == want
    assert out["metrics"]["prefill_tok_s"] > 0


# ---------------------------------------------------------- batch, refusals ---


def test_make_batch_matches_jax_layout():
    """``make_batch`` gives an enc-dec config JAX's keys, shapes and dtypes:
    float32 N(0, 1) ``embeds [B, S, d_model]``, int32 ``tokens`` and
    ``targets``, drawn from the numpy generator."""
    jcfg, cfg = _cfgs()
    ref = jmake_batch(jcfg, 3, 10, jax.random.PRNGKey(0))
    a = make_batch(cfg, 3, 10, np.random.default_rng(0))
    assert set(a) == set(ref) == {"embeds", "tokens", "targets"}
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape, k
        assert str(a[k].dtype).split(".")[-1] == str(ref[k].dtype), k
    assert torch.equal(a["embeds"], make_batch(cfg, 3, 10, np.random.default_rng(0))["embeds"])


def test_refusals_as_jax():
    """Continuous serving refuses enc-dec with JAX's words; the train loop
    and ``Session.train`` refuse an embeds arch (ROADMAP R8); the layer
    layout raises JAX's ``ValueError`` for the family, so pp > 1 does."""
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="continuous serving needs token archs"):
        cli.run(["serve", "--arch", ARCH, "--smoke", "--device", "cpu", "--continuous"])
    with pytest.raises(ValueError, match="R8"):
        cli.run(["train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="encdec"):
        lm.segment_layout(cfg)
    with pytest.raises(ValueError, match="encdec"):
        pl.pipeline_layout(cfg, 2)


def test_flash_branch_checks_causal_positions():
    """The flash branch places query row i at position i: a causal call
    with other positions raises, the same call at ``arange(S)`` (marked or
    read back) runs, and a bidirectional one reads no positions (the
    cross-attention's zeros)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
               for _ in range(3))
    kw = dict(scale=0.25, kv_chunk=32)
    with pytest.raises(ValueError, match="row i at position i"):
        L.attention(q, k, v, positions_q=torch.arange(5, 45), **kw)
    with pytest.raises(ValueError, match="row i at position i"):
        L.attention(q, k, v, positions_q=torch.zeros(40, dtype=torch.long), window=8,
                    causal=False, **kw)
    a = L.attention(q, k, v, positions_q=torch.arange(40), **kw)
    b = L.attention(q, k, v, positions_q=L.arange_positions(40, q.device), **kw)
    assert torch.equal(a, b)
    c = L.attention(q, k, v, positions_q=torch.zeros(40, dtype=torch.long),
                    causal=False, **kw)
    assert not torch.equal(a, c)
