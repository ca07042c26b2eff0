"""The port's RWKV-6 training path against the JAX package on the CPU, in
float32: the time-mix, channel-mix and block functions, ``loss_fn`` and
every gradient leaf against ``jax.value_and_grad(lm.loss_fn)`` (JAX's
default ``kernels_impl="xla"`` branch), the loss against the Pallas branch
in interpret mode, 5-step ``make_train_step`` trajectories, the decay mask,
the train-state round trip and the CLI.

Weights: JAX ``lm.init`` on the rwkv6-3b smoke config, with every leaf that
init fills with a constant (the token-shift mixes, ``ln_x``, the norm
scales) redrawn from numpy so a dropped or misplaced term shows, and
``w_decay2`` drawn at half its init scale.  The last keeps every log-decay
above -2, where JAX's default branch (``wkv6_chunked``) clamps it (P6): at
the smoke init's own scale some decays fall below e^-2 (shown by
``test_decay_lora_scale_and_the_p6_clamp``), and there K5, exact like the
Pallas branch, rightly differs from the clamped branch.  Both sides get the same
weights and the same batch, so losses agree to ~1e-6 relative and gradients
to ~1e-5 of each leaf's largest entry (TOL below).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.model import count_params as jcount  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm, rwkv  # noqa: E402
from repro_torch.models.model import count_params  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    from_jax_params,
    from_jax_train_state,
    to_jax_train_state,
)
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import copy_state, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
# float32 on both sides, sums in another order: relative loss error, and
# errors relative to each output's or leaf's largest magnitude
LOSS_RTOL = 2e-6
TOL = 2e-5
# five AdamW steps: early updates are lr * sign-like, so a float32-ulp
# gradient difference on an entry whose gradient is near zero can move it
# by a fraction of lr (3e-3); as tests/test_torch_train.py holds it
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-3
# per-step metrics along the trajectory, relative: loss and lr as
# tests/test_torch_train.py holds them; grad_norm wider: the global norm
# sums the WKV gradients, which the two sides accumulate over the
# recurrence in other orders, so each step carries float32 noise near
# 1e-5 relative, and five steps of sign-like early Adam updates let it
# grow (this test measured 2.2e-5 at step 4)
METRIC_RTOL = {"loss": 1e-5, "lr": 1e-5, "grad_norm": 1e-4}
SEQ = 64


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    blk = params["seg0"]["b0"]
    att, ffn = blk["att"], blk["ffn"]

    def draw(tree, name, base):
        tree[name] = (base + 0.3 * rng.standard_normal(tree[name].shape)
                      ).astype(np.float32)

    for tree, names, base in (
            (att, ("mu_x", "mu"), 0.0), (ffn, ("mu_k", "mu_r"), 0.0),
            (att["ln_x"], ("bias",), 0.0), (att["ln_x"], ("scale",), 1.0),
            (blk["ln1"], ("scale",), 1.0), (blk["ln2"], ("scale",), 1.0),
            (params["final_norm"], ("scale",), 1.0)):
        for n in names:
            draw(tree, n, base)
    att["w_decay2"] = (0.5 * att["w_decay2"]).astype(np.float32)
    return params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": mask}


def _flat(tree):
    return list(optim.leaves(tree))


def _close(ours, ref, tol=TOL, what=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), (what, err)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("fn", ["time_mix", "channel_mix", "block"])
def test_rwkv_functions_match_jax(fn):
    jcfg, cfg = _cfgs()
    p = _layer0(_jax_params(jcfg)["seg0"]["b0"])
    x = np.random.default_rng(4).standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    jfn, tfn, key = {
        "time_mix": (jrwkv.time_mix_apply, rwkv.time_mix_apply, "att"),
        "channel_mix": (jrwkv.channel_mix_apply, rwkv.channel_mix_apply, "ffn"),
        "block": (jrwkv.rwkv_block_apply, rwkv.rwkv_block_apply, None),
    }[fn]
    jp = p if key is None else p[key]
    ref, jstate = jfn(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    ours, state = tfn(from_jax_params(jp, device="cpu"), cfg, torch.from_numpy(x))
    assert jstate is None and state is None
    _close(ours, ref, what=fn)


def _state_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _state_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_carried_state_and_serving_are_refused():
    """Refused until the RWKV serving slice, now ported: a carried state
    through the time mix, the channel mix and the block equals JAX's
    (output and new state), one decode tick over the pool (every leaf a
    row per slot) equals JAX's paged forward, MegaServe serves and the CLI
    completes (tests/test_torch_serve_recurrent.py holds the streams to
    JAX's)."""
    from repro.kernels.paged_attention.ops import PagedInfo as JPagedInfo
    from repro.serve.paged_cache import PagedKVCache as JPagedKVCache
    from repro.serve.paged_cache import PoolSpec as JPoolSpec
    from repro_torch.kernels.paged_attention import PagedInfo

    jcfg, cfg = _cfgs()
    jparams = _jax_params(jcfg)
    p = _layer0(jparams["seg0"]["b0"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    H, N, D = cfg.num_heads, cfg.rwkv.head_size, cfg.d_model
    st = {"att": {"x_prev": rng.standard_normal((2, D)).astype(np.float32),
                  "wkv": rng.standard_normal((2, H, N, N)).astype(np.float32)},
          "ffn": {"x_prev": rng.standard_normal((2, D)).astype(np.float32)}}
    for jfn, tfn, key in ((jrwkv.time_mix_apply, rwkv.time_mix_apply, "att"),
                          (jrwkv.channel_mix_apply, rwkv.channel_mix_apply, "ffn"),
                          (jrwkv.rwkv_block_apply, rwkv.rwkv_block_apply, None)):
        jp = p if key is None else p[key]
        js = st if key is None else st[key]
        ref, jnew = jfn(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x),
                        state=jax.tree.map(jnp.asarray, js))
        ours, new = tfn(from_jax_params(jp, device="cpu"), cfg, torch.from_numpy(x),
                        state=from_jax_params(js, device="cpu"))
        _close(ours, ref, what=tfn.__name__)
        for path, a in _state_leaves(new):
            _close(a, dict(_state_leaves(jnew))[path], what=f"{tfn.__name__} {path}")

    params = from_jax_params(jparams, device="cpu")
    tables = np.zeros((2, 1), np.int32)
    toks, pos = np.asarray([[3], [7]], np.int32), np.asarray([4, 9], np.int32)
    jkv = JPagedKVCache(jcfg, JPoolSpec(num_slots=2, num_blocks=2, block_size=8,
                                        max_blocks=1))
    assert not any(jax.tree.leaves(jkv.paged))
    hid, _, _ = jlm.forward(
        jcfg, jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(toks)},
        cache=jkv.pool, cache_pos=jnp.asarray(pos),
        paged=JPagedInfo(tables=jnp.asarray(tables), block_size=8, impl="xla"),
        paged_flags=jkv.paged)
    pool = lm.init_pool(cfg, 2, 8, torch.device("cpu"), num_slots=2)
    with torch.inference_mode():
        h, _ = lm.forward(cfg, params, torch.from_numpy(toks).long(), pool=pool,
                          cache_pos=torch.from_numpy(pos),
                          paged=PagedInfo(tables=torch.from_numpy(tables), block_size=8))
    _close(h, hid)
    assert pool["seg0"]["b0"]["att"]["wkv"].abs().sum() > 0

    srv = MegaServe(cfg, params, ServeConfig(num_slots=2, block_size=8, num_blocks=17,
                                             max_blocks_per_slot=4), device="cpu")
    srv.submit([5, 6, 7], 3)
    assert [len(s) for s in srv.drain().values()] == [3]
    out = cli.run(["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                   "--continuous", "--requests", "2", "--rate", "300", "--slots",
                   "2", "--max-new", "3", "--prompt-lens", "5"])
    assert out["metrics"]["finished"] == 2


@pytest.mark.parametrize("half_scale", [False, True], ids=["init", "half"])
def test_decay_lora_scale_and_the_p6_clamp(monkeypatch, half_scale):
    """Why the parity weights draw ``w_decay2`` at half scale: at the smoke
    init's own scale some decays on the test batch fall below e^-2, where
    JAX's default branch clamps them (P6) and K5 does not; at half scale
    every decay stays above it."""
    jcfg, cfg = _cfgs()
    params = _jax_params(jcfg)
    if not half_scale:
        params["seg0"]["b0"]["att"]["w_decay2"] *= 2.0
    seen = []
    real = rwkv.wkv6

    def spy(r, k, v, w, u, plain=False):
        seen.append(w.min().item())
        return real(r, k, v, w, u, plain=plain)

    monkeypatch.setattr(rwkv, "wkv6", spy)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, SEQ, seed=5).items()}
    with torch.no_grad():
        lm.loss_fn(cfg, from_jax_params(params, device="cpu"), batch)
    assert (min(seen) < np.exp(-2.0)) != half_scale, min(seen)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg = _cfgs(remat=remat)
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, SEQ, seed=5)

    def jloss(p):
        return jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tp = from_jax_params(params, device="cpu")
    for _, leaf in _flat(tp):
        leaf.requires_grad_(True)
    loss, metrics = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    paths, leaves = zip(*_flat(tp))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert metrics["ce"].item() == pytest.approx(loss.item())
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(paths)
    for path, g in zip(paths, grads):
        _close(g, jflat[path], what=path)


def test_loss_matches_the_pallas_branch_in_interpret_mode():
    """JAX's Pallas branch (``kernels_impl="pallas_interpret"``, the exact
    K5 counterpart; JAX cannot differentiate it) gives the same loss."""
    jcfg, cfg = _cfgs(kernels_impl="pallas_interpret")
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, SEQ, seed=6)
    jl, _ = jlm.loss_fn(jcfg, jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        loss, _ = lm.loss_fn(cfg, from_jax_params(params, device="cpu"),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_five_step_trajectory_matches_jax(grad_accum):
    jcfg, cfg = _cfgs()
    ocfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    master = _jax_params(jcfg)
    jstate = JTrainState(
        params=jax.tree.map(jnp.asarray, master),
        master=jax.tree.map(jnp.asarray, master),
        opt=joptim.init_opt_state(jax.tree.map(jnp.asarray, master)))
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, joptim.OptimizerConfig(**ocfg_kw),
                                     grad_accum=grad_accum))
    tstep = make_train_step(cfg, optim.OptimizerConfig(**ocfg_kw),
                            grad_accum=grad_accum)
    for i in range(5):
        batch = _batch(cfg, 4, SEQ, seed=100 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        for key, rtol in METRIC_RTOL.items():
            assert tm[key].item() == pytest.approx(float(jm[key]), rel=rtol), (i, key)
    ref = dict(_flat(jax.tree.map(np.asarray, jstate.master)))
    for path, leaf in _flat(tstate.master):
        scale = max(np.abs(ref[path]).max(), 1.0)
        err = np.abs(leaf.numpy() - ref[path]).max()
        assert err <= TRAJ_RTOL * scale + TRAJ_ATOL, (path, err)
    assert tstate.opt["step"] == int(jstate.opt["step"]) == 5


def test_step_consumes_its_state_and_copy_state_keeps_one():
    """The step updates master, moments and compute params in place and
    returns the state it was given; two steps from copies of one state give
    the same result."""
    _, cfg = _cfgs()
    tstep = make_train_step(cfg, optim.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                       total_steps=4))
    state = from_jax_train_state(
        {"params": _jax_params(_cfgs()[0]), "master": _jax_params(_cfgs()[0]),
         "opt": joptim.init_opt_state(_jax_params(_cfgs()[0]))}, device="cpu")
    batch = _batch(cfg, 2, 16, seed=9)
    a, b = copy_state(state), copy_state(state)
    before = state.master["seg0"]["b0"]["att"]["w_r"].clone()
    leaf = a.master["seg0"]["b0"]["att"]["w_r"]
    out, _ = tstep(a, batch)
    assert out is a and a.master["seg0"]["b0"]["att"]["w_r"] is leaf
    assert not torch.equal(leaf, before) and a.opt["step"] == 1
    assert torch.equal(state.master["seg0"]["b0"]["att"]["w_r"], before)
    tstep(b, batch)
    for (pa, x), (pb, y) in zip(_flat(a.master), _flat(b.master)):
        assert pa == pb and torch.equal(x, y)
    for (_, x), (_, y) in zip(_flat(a.params), _flat(a.master)):
        assert x.requires_grad and torch.equal(x.detach(), y)


def test_decay_mask_params_and_round_trip():
    """R1's mask leaf for leaf (stacked RWKV leaves decay, ``final_norm``
    does not), the parameter count, and a bf16 train state crossing both
    ways exactly."""
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    params = _jax_params(jcfg)
    ours_p = from_jax_params(params, device="cpu")
    ref = dict(_flat(joptim._decay_mask(params)))
    ours = dict(_flat(optim._decay_mask(ours_p)))
    assert ours == ref
    assert ours[("final_norm", "scale")] == 0.0
    for leaf in (("att", "w0"), ("att", "u"), ("att", "ln_x", "bias"),
                 ("ffn", "mu_k"), ("ln1", "scale")):
        assert ours[("seg0", "b0", *leaf)] == 1.0
    assert count_params(ours_p) == jcount(params)
    assert count_params(lm.init(cfg, seed=0, device="cpu")) == jcount(params)

    master = jax.tree.map(jnp.asarray, params)
    opt = joptim.init_opt_state(master)
    opt = {"m": jax.tree.map(lambda x: x + 0.5, opt["m"]),
           "v": jax.tree.map(lambda x: x + 0.25, opt["v"]),
           "step": jnp.asarray(3, jnp.int32)}
    state = JTrainState(params=jax.tree.map(lambda x: x.astype(jnp.bfloat16), master),
                        master=master, opt=opt)
    back = to_jax_train_state(from_jax_train_state(jax.tree.map(np.asarray, state),
                                                   device="cpu"))
    rebuilt = JTrainState(
        params=jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                            back["params"]),
        master=back["master"], opt=back["opt"])
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_trains_rwkv_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "3", "--seq-len", str(SEQ)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    steps = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
