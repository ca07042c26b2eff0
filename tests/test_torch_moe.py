"""The MoE family (phi3.5-moe) in the port against the JAX package on the CPU,
in float32.

``moe_apply`` (router, softmax top-k, renormalised gates, the load-balance
and z losses, capacity, the sort-based dispatch, the combine, the drop
fraction) against JAX's on one input for each way routing goes: S a
multiple of ``seq_groups`` (16 groups) with drops, S not a multiple (one
group a row), and a router whose experts tie exactly, where ``jax.lax.top_k``
takes the lower index first.  Then the init tree, the loss (aux loss
included) and every gradient leaf, and MegaServe's greedy streams on the
paged, chunked and speculative paths, each against JAX's same path: a
prompt routes in groups whose shape depends on the path (ROADMAP P15), so a
stream is held only to JAX's stream on that path.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.hooks import Collector  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
MOE_TOL = 1e-5


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _moe_params(cfg, seed=0):
    """One MoE layer's parameters from JAX ``lm.init`` (layer 0)."""
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    return {k: np.array(v[0]) for k, v in params["seg0"]["b0"]["mlp"].items()}


class _Tags(Collector):
    """Keeps every tag it sees."""

    def __init__(self):
        self.seen = {}

    def tag(self, name, x):
        self.seen[name] = x
        return x


def _moe_both(jcfg, cfg, p, x, n_seq_groups):
    want, jaux = JL.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                              n_seq_groups=n_seq_groups)
    tags = _Tags()
    got, aux = L.moe_apply({k: torch.tensor(v) for k, v in p.items()}, cfg,
                           torch.tensor(x), n_seq_groups=n_seq_groups, collector=tags)
    return (np.asarray(want), {k: float(v) for k, v in jaux.items()},
            got.numpy(), {k: v.item() for k, v in aux.items()}, tags.seen)


@pytest.mark.parametrize("case", ["groups_with_drops", "one_group", "tied_router"])
def test_moe_apply_matches_jax(case):
    jcfg, cfg = _cfgs()
    p = _moe_params(jcfg)
    rng = np.random.default_rng(7)
    S = 20 if case == "one_group" else 64
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    if case == "groups_with_drops":  # a skewed router overfills some experts
        p["router"][:, 0] += 0.5 * np.abs(p["router"][:, 1])
        x += 0.5
    if case == "tied_router":  # experts 1-3 score exactly 0: top-2 ties
        p["router"][:, 1:] = 0.0
    want, jaux, got, aux, tags = _moe_both(jcfg, cfg, p, x, n_seq_groups=16)
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)
    assert set(aux) == set(jaux) == {"moe_aux_loss", "moe_drop_frac"}
    assert aux["moe_aux_loss"] == pytest.approx(jaux["moe_aux_loss"], rel=1e-6)
    assert aux["moe_drop_frac"] == jaux["moe_drop_frac"]
    assert tuple(tags["router_gate"].shape) == (
        (2, S, 2) if case == "one_group" else (32, S // 16, 2))
    if case == "groups_with_drops":
        assert aux["moe_drop_frac"] > 0.05
    if case == "one_group":
        assert aux["moe_drop_frac"] == 0.0


def test_top_k_breaks_ties_by_index_as_jax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.2, 0.4, 0.0]], dtype=np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = L._top_k(torch.tensor(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _moe_cfgs(remat="full", **moe):
    """Both sides' smoke configs with ``moe`` fields replaced."""
    out = []
    for c in (jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)):
        out.append(c.replace(compute_dtype="float32", remat=remat,
                             moe=replace(c.moe, **moe)))
    return out


@pytest.mark.parametrize("extra", [0, 1], ids=["phi", "shared_and_first_dense"])
def test_init_tree_and_layout_equal_jax(extra):
    """Router ``[D, E]``, experts ``[E, D, F]``/``[E, F, D]`` and, with
    ``num_shared_experts``, ``shared/…`` SwiGLU leaves; ``first_k_dense``
    dense layers before the MoE segment."""
    jcfg, cfg = _moe_cfgs(num_shared_experts=extra, first_k_dense=extra)
    assert lm.segment_layout(cfg) == jlm.segment_layout(jcfg)
    ours = {p: tuple(v.shape) for p, v in optim.leaves(lm.init(cfg, seed=0, device="cpu"))}
    ref = {p: tuple(v.shape) for p, v in optim.leaves(
        jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0))))}
    assert ours == ref
    moe = f"seg{extra}"
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    n = cfg.num_layers - extra
    assert ours[(moe, "b0", "mlp", "router")] == (n, D, E)
    assert ours[(moe, "b0", "mlp", "w_down")] == (n, E, Fe, D)
    assert ((moe, "b0", "mlp", "shared", "w_gate") in ours) == bool(extra)


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("first_k_dense", [0, 1])
def test_loss_and_grads_match_jax(remat, first_k_dense):
    """Loss (cross entropy plus the aux loss), the metrics and every gradient
    leaf against ``jax.value_and_grad(lm.loss_fn)``; under remat full the
    recompute adds the aux loss once."""
    jcfg, cfg = _moe_cfgs(remat, first_k_dense=first_k_dense,
                          num_shared_experts=first_k_dense)
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    B, S = 2, 48
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    tp = from_jax_params(params, device="cpu")
    paths, leaves = zip(*optim.leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    seg = f"seg{first_k_dense}_moe_drop_frac"
    assert set(metrics) == {"loss", "ce", "aux_loss", seg} == set(jm)
    assert metrics["aux_loss"].item() == pytest.approx(float(jm["aux_loss"]), rel=1e-5)
    assert metrics["aux_loss"].item() > 0
    assert metrics[seg].item() == float(jm[seg])
    assert not metrics[seg].requires_grad
    jflat = dict(optim.leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(paths)
    for path, g in zip(paths, grads):
        ref = jflat[path]
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-6), (path, err)


# ---------------------------------------------------------- serving ---


@pytest.fixture(scope="module")
def phi():
    jcfg, cfg = _cfgs()
    return jcfg, cfg, jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))


def _serve_both(model, prompts, max_new, **geom):
    jcfg, cfg, params = model
    jsrv = JaxMegaServe(jcfg, jax.tree.map(jnp.asarray, params),
                        JaxServeConfig(paged_attn_impl="xla", **geom))
    srv = MegaServe(cfg, from_jax_params(params, device="cpu"), ServeConfig(**geom),
                    device="cpu")
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p, max_new, arrival=0.0)
    return jsrv.drain(), srv.drain(), jsrv, srv


@pytest.mark.parametrize("path", ["paged", "chunked", "spec"])
def test_served_streams_equal_jax(phi, path):
    """Greedy streams token for token against JAX MegaServe on the same
    path: the paged flash path (a prompt bucketed to whole blocks, routed in
    16 groups, pads included), chunked prefill (a 32-token chunk: 16 groups
    of 2 tokens) and speculation (verify steps of spec_k + 1 = 5 tokens,
    one group a slot)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, phi[1].vocab_size, size=n).tolist() for n in (7, 21, 45)]
    extra = {"paged": {}, "chunked": dict(chunked_prefill=True),
             "spec": dict(spec_decode=True, spec_k=4)}[path]
    want, got, jsrv, srv = _serve_both(
        phi, prompts, 8, num_slots=3, block_size=16, num_blocks=24,
        max_blocks_per_slot=4, decode_path="paged", prefill_path="flash", **extra)
    assert got == want
    met, jmet = srv.metrics(), jsrv.metrics()
    for k in ("generated_tokens", "finished", "steps", "spec_proposed", "spec_accepted"):
        assert met.get(k) == jmet.get(k), k
    names = [e.name for e in srv.trace_events()]
    assert names.count({"paged": "prefill", "chunked": "prefill_chunk",
                        "spec": "verify"}[path]) > 0


def test_mla_and_encdec_are_refused_naming_their_item():
    """Item 13b is ported whole: MLA on top of MoE (deepseek-v2-lite) lays
    out as the MoE family does (tests/test_torch_mla.py holds it to JAX);
    an encoder-decoder config dispatches to ``ENCDEC``, and the decoder
    LM's layer layout refuses it with JAX's ``ValueError`` (the family
    lives in ``models/encdec.py``; tests/test_torch_encdec.py)."""
    from repro_torch.models.model import ENCDEC, get_model

    cfg = get_config(ARCH, smoke=True)
    assert lm.segment_layout(cfg.replace(use_mla=True)) == lm.segment_layout(cfg)
    assert get_model(cfg.replace(family="encdec")) is ENCDEC
    with pytest.raises(ValueError, match="encdec"):
        lm.segment_layout(cfg.replace(family="encdec"))
