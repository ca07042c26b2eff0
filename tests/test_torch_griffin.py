"""The port's Griffin training path against the JAX package on the CPU, in
float32: ``causal_conv1d``, ``rglru_apply``, the recurrent block and both
block kinds, ``loss_fn`` and every gradient leaf against
``jax.value_and_grad(lm.loss_fn)`` (JAX's default ``kernels_impl="xla"``
branch, whose recurrence is ``lru_scan``), the parameter tree, 5-step
``make_train_step`` trajectories, P7 at the model level, the refusals and
the CLI.

Weights: JAX ``lm.init`` on the recurrentgemma-9b smoke config (4 layers:
rec, rec, attn, rec; window 32 < seq 64, so the window masks), with every
leaf that init fills with a constant (the gate and conv biases, the norm
scales) redrawn from numpy so a dropped or misplaced term shows.  Both sides
get the same weights and the same batch, so losses agree to ~1e-6 relative
and gradients to ~1e-5 of each leaf's largest entry (TOL below).
"""

import functools
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
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.models.model import count_params as jcount  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru import launches  # noqa: E402
from repro_torch.models import griffin, lm, scan_utils  # noqa: E402
from repro_torch.models.model import count_params  # noqa: E402
from repro_torch.models.weights import from_jax_params, from_jax_train_state  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
# float32 on both sides, sums in another order: relative loss error, and
# errors relative to each output's or leaf's largest magnitude
LOSS_RTOL = 2e-6
TOL = 2e-5
# five AdamW steps, as tests/test_torch_rwkv.py holds them: early updates
# are lr * sign-like, so a float32-ulp gradient difference on an entry whose
# gradient is near zero can move it by a fraction of lr (3e-3)
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-3
METRIC_RTOL = {"loss": 1e-5, "lr": 1e-5, "grad_norm": 1e-4}
SEQ = 64


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _jax_params(seed=0):
    """A fresh copy (the tests edit leaves) of the drawn weights."""
    return jax.tree.map(np.copy, _drawn_params(seed))


@functools.lru_cache(maxsize=None)
def _drawn_params(seed):
    cfg = jax_get_config(ARCH, smoke=True)
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def draw(tree, name, base):
        tree[name] = (base + 0.3 * rng.standard_normal(tree[name].shape)
                      ).astype(np.float32)

    draw(params["final_norm"], "scale", 1.0)
    for seg in (params["seg0"], params["seg1"]):
        for blk in seg.values():
            draw(blk["ln1"], "scale", 1.0)
            draw(blk["ln2"], "scale", 1.0)
            if "rglru" in blk["mix"]:
                draw(blk["mix"], "conv_b", 0.0)
                draw(blk["mix"]["rglru"], "b_a", 0.0)
                draw(blk["mix"]["rglru"], "b_i", 0.0)
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
    assert ours.shape == ref.shape, what
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), (what, err)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _x(cfg, seed=4, width=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, SEQ, width or cfg.d_model)).astype(np.float32)


def test_segment_layout_and_param_tree_match_jax():
    """Pattern groups plus the remainder, leaf for leaf the JAX tree (names,
    shapes), the parameter count, and the init's own scales (``lam`` ~ U(-1,
    1), the zero biases)."""
    jcfg, cfg = _cfgs()
    assert lm.segment_layout(cfg) == jlm.segment_layout(jcfg) == [
        (("rec", "rec", "attn"), 1), (("rec",), 1)]
    for n in (5, 38):
        assert (lm.segment_layout(cfg.replace(num_layers=n))
                == jlm.segment_layout(jcfg.replace(num_layers=n)))
    ref = jax.eval_shape(lambda k: jlm.init(jcfg, k), jax.random.PRNGKey(0))
    ours = lm.init(cfg, seed=0, device="cpu")
    shapes = {p: tuple(v.shape) for p, v in _flat(ours)}
    assert shapes == {p: tuple(v.shape) for p, v in _flat(ref)}
    assert count_params(ours) == jcount(ref)
    lam = ours["seg0"]["b0"]["mix"]["rglru"]["lam"]
    assert lam.min() >= -1 and lam.max() <= 1 and lam.std() > 0.4
    assert not ours["seg1"]["b0"]["mix"]["conv_b"].any()


def test_causal_conv1d_matches_jax():
    _, cfg = _cfgs()
    rng = np.random.default_rng(1)
    x = _x(cfg, seed=2)
    w = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    bias = rng.standard_normal(cfg.d_model).astype(np.float32)
    ref, ref_prev = jscan.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    y, new_prev = scan_utils.causal_conv1d(*map(torch.from_numpy, (x, w, bias)))
    _close(y, ref)
    _close(new_prev, ref_prev)
    # a carried context (prefill and decode): y and the context carried on
    ref, ref_prev = jscan.causal_conv1d(*map(jnp.asarray, (x, w, bias, x[:, :3])))
    y, new_prev = scan_utils.causal_conv1d(*map(torch.from_numpy, (x, w, bias)),
                                           prev=torch.from_numpy(x[:, :3]))
    _close(y, ref)
    _close(new_prev, ref_prev)


@pytest.mark.parametrize("fn", ["rglru", "recurrent", "rec_block", "attn_block"])
def test_griffin_functions_match_jax(fn):
    jcfg, cfg = _cfgs()
    params = _jax_params()
    x = _x(cfg)
    pos = np.arange(SEQ)
    if fn == "rglru":
        jp = _layer0(params["seg0"]["b0"])["mix"]["rglru"]
        ref = jax.jit(lambda p, x: jgriffin.rglru_apply(p, jcfg, x))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        ours = griffin.rglru_apply(from_jax_params(jp, device="cpu"), cfg,
                                   torch.from_numpy(x))
        _close(ours[0], ref[0], what=fn)
        _close(ours[1], ref[1], what=fn)
        return
    if fn == "recurrent":
        jp = _layer0(params["seg0"]["b1"])["mix"]
        ref, _ = jax.jit(lambda p, x: jgriffin.recurrent_block_apply(p, jcfg, x))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        ours, _ = griffin.recurrent_block_apply(from_jax_params(jp, device="cpu"),
                                                cfg, torch.from_numpy(x))
        _close(ours, ref, what=fn)
        return
    kind, blk = {"rec_block": ("rec", "b0"), "attn_block": ("attn", "b2")}[fn]
    jp = _layer0(params["seg0"][blk])
    ref, jstate = jax.jit(lambda p, x: jgriffin.griffin_block_apply(
        p, jcfg, kind, x, positions=jnp.asarray(pos)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    ours, state = griffin.griffin_block_apply(
        from_jax_params(jp, device="cpu"), cfg, kind, torch.from_numpy(x),
        positions=torch.from_numpy(pos))
    assert jstate is None and state is None
    _close(ours, ref, what=fn)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg = _cfgs(remat=remat)
    params = _jax_params()
    batch = _batch(cfg, 2, SEQ, seed=5)

    def jloss(p):
        return jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
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


def test_p7_the_pallas_branch_clips_griffin_decays(monkeypatch):
    """P7 at the model level: on the smoke batch most decays of the first
    recurrent layer lie below e^-2, where JAX's Pallas branch
    (``kernels_impl="pallas_interpret"``) clips them; the port, exact, keeps
    JAX's default branch's loss and not the Pallas branch's."""
    jcfg, cfg = _cfgs()
    params = _jax_params()
    batch = _batch(cfg, 2, SEQ, seed=6)
    seen = []
    real = griffin.rglru_scan

    def spy(a, b, h0=None, plain=False):
        seen.append((a.log() < -2.0).float().mean().item())
        return real(a, b, h0, plain=plain)

    monkeypatch.setattr(griffin, "rglru_scan", spy)
    before = dict(launches)
    with torch.no_grad():
        loss, _ = lm.loss_fn(cfg, from_jax_params(params, device="cpu"),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert launches == before  # CPU tensors launch nothing
    assert len(seen) == 3 and seen[0] > 0.4, seen
    jb = jax.tree.map(jnp.asarray, batch)
    jp = jax.tree.map(jnp.asarray, params)
    j_xla, _ = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b))(jp, jb)
    pcfg = jcfg.replace(kernels_impl="pallas_interpret")
    j_pallas, _ = jax.jit(lambda p, b: jlm.loss_fn(pcfg, p, b))(jp, jb)
    assert abs(loss.item() - float(j_xla)) <= LOSS_RTOL * abs(float(j_xla))
    assert abs(loss.item() - float(j_pallas)) > 100 * LOSS_RTOL * abs(float(j_xla))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_five_step_trajectory_matches_jax(grad_accum):
    jcfg, cfg = _cfgs()
    ocfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    master = _jax_params()
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


def test_carried_state_and_serving_are_refused():
    """Refused until the Griffin serving slice, now ported: a carried state
    through the recurrent block equals JAX's (output and new state), one
    decode tick over the pool (an attention leaf paged, the recurrent
    leaves a row per slot) equals JAX's paged forward, MegaServe serves and
    the CLI completes (tests/test_torch_serve_recurrent.py holds the
    streams to JAX's)."""
    from repro.kernels.paged_attention.ops import PagedInfo as JPagedInfo
    from repro.serve.paged_cache import PagedKVCache as JPagedKVCache
    from repro.serve.paged_cache import PoolSpec as JPoolSpec
    from repro_torch.kernels.paged_attention import PagedInfo

    jcfg, cfg = _cfgs()
    jparams = _jax_params()
    p = _layer0(jparams["seg0"]["b0"])["mix"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, 3, cfg.lru_width)).astype(np.float32),
          "h": rng.standard_normal((2, cfg.lru_width)).astype(np.float32)}
    ref, jnew = jgriffin.recurrent_block_apply(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
        state=jax.tree.map(jnp.asarray, st))
    ours, new = griffin.recurrent_block_apply(
        from_jax_params(p, device="cpu"), cfg, torch.from_numpy(x),
        state=from_jax_params(st, device="cpu"))
    _close(ours, ref)
    for k in ("conv", "h"):
        _close(new[k], jnew[k], what=k)

    params = from_jax_params(jparams, device="cpu")
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    toks, pos = np.asarray([[3], [7]], np.int32), np.asarray([0, 5], np.int32)
    jkv = JPagedKVCache(jcfg, JPoolSpec(num_slots=2, num_blocks=5, block_size=8,
                                        max_blocks=2))
    hid, _, _ = jlm.forward(
        jcfg, jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(toks)},
        cache=jkv.pool, cache_pos=jnp.asarray(pos),
        paged=JPagedInfo(tables=jnp.asarray(tables), block_size=8, impl="xla"),
        paged_flags=jkv.paged)
    pool = lm.init_pool(cfg, 5, 8, torch.device("cpu"), num_slots=2)
    with torch.inference_mode():
        h, _ = lm.forward(cfg, params, torch.from_numpy(toks).long(), pool=pool,
                          cache_pos=torch.from_numpy(pos),
                          paged=PagedInfo(tables=torch.from_numpy(tables), block_size=8))
    _close(h, hid)
    assert pool["seg0"]["b0"]["h"].abs().sum() > 0  # the slots' rows were written

    srv = MegaServe(cfg, params, ServeConfig(num_slots=2, block_size=8, num_blocks=17,
                                             max_blocks_per_slot=4), device="cpu")
    srv.submit([5, 6, 7], 3)
    assert [len(s) for s in srv.drain().values()] == [3]
    out = cli.run(["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                   "--continuous", "--requests", "2", "--rate", "300", "--slots",
                   "2", "--max-new", "3", "--prompt-lens", "5"])
    assert out["metrics"]["finished"] == 2


def test_cli_trains_griffin_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    steps = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 3
    losses = [float(ln.split()[3]) for ln in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
