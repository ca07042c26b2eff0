"""The port's training path against the JAX package on the CPU, in float32:
``loss_fn`` loss and every gradient leaf against ``jax.value_and_grad(
lm.loss_fn)``, a 5-step ``make_train_step`` trajectory from one converted
``TrainState``, the weight-decay mask, ``SyntheticTokens``, the train-state
conversion and the ``train`` CLI.

Both sides get the same weights (JAX ``lm.init`` with norm scales and QKV
biases redrawn from numpy, so a dropped cast or bias shows) and the same
batch.  At float32 the two frameworks differ only in the order of float32
sums, so losses agree to ~1e-6 relative and gradients to ~1e-5 of each
leaf's largest entry (TOL below).  The smoke configs have
``attn_kv_chunk=32``: a sequence of 48 takes the flash branch (K2's plain
version, against JAX's ``_make_flash`` custom VJP), 32 the naive branch.
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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    from_jax_params,
    from_jax_train_state,
    to_jax_train_state,
)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "qwen3-14b"]
# float32 on both sides: relative loss error, and gradient error relative to
# each leaf's largest magnitude (sums over up to B*S*V terms in another order)
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
# five AdamW steps: early Adam updates are lr * sign-like (m/sqrt(v) ~ +-1),
# so a float32-ulp gradient difference on an entry whose gradient is near
# zero can move it by a fraction of lr (3e-3); measured at most 2.2e-4 here.
# Compared relative to each leaf's scale plus a third of lr in absolute.
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-3


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    blk = params["seg0"]["b0"]
    for tree, names in ((blk["attn"], ("bq", "bk", "bv", "q_norm", "k_norm")),
                        (blk["ln1"], ("scale",)), (blk["ln2"], ("scale",)),
                        (params["final_norm"], ("scale",))):
        for n in names:
            if n in tree:
                base = 0.0 if n.startswith("b") else 1.0
                tree[n] = (base + 0.3 * rng.standard_normal(tree[n].shape)
                           ).astype(np.float32)
    return params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": mask}


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _flat(tree):
    return [(p, v) for p, v in optim.leaves(tree)]


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("seq", [48, 32], ids=["flash", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, seq, remat):
    jcfg, cfg = _cfgs(arch, remat=remat)
    params = _jax_params(jcfg)
    batch = _batch(cfg, 2, seq, seed=5)

    def jloss(p):
        return jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tp = from_jax_params(params, device="cpu")
    for _, leaf in _flat(tp):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = lm.loss_fn(cfg, tp, tb)
    paths, leaves = zip(*_flat(tp))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert metrics["ce"].item() == pytest.approx(loss.item())
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(paths)
    for path, g in zip(paths, grads):
        ref = jflat[path]
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-6), (path, err)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_five_step_trajectory_matches_jax(arch, grad_accum):
    jcfg, cfg = _cfgs(arch)
    ocfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jocfg = joptim.OptimizerConfig(**ocfg_kw)
    master = _jax_params(jcfg)
    jstate = JTrainState(
        params=jax.tree.map(jnp.asarray, master),
        master=jax.tree.map(jnp.asarray, master),
        opt=joptim.init_opt_state(jax.tree.map(jnp.asarray, master)))
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jocfg, grad_accum=grad_accum))
    tstep = make_train_step(cfg, optim.OptimizerConfig(**ocfg_kw),
                            grad_accum=grad_accum)
    for i in range(5):
        batch = _batch(cfg, 4, 48, seed=100 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert tm[key].item() == pytest.approx(float(jm[key]), rel=1e-5), (
                i, key)
    ref = dict(_flat(jax.tree.map(np.asarray, jstate.master)))
    for path, leaf in _flat(tstate.master):
        scale = max(np.abs(ref[path]).max(), 1.0)
        err = np.abs(leaf.numpy() - ref[path]).max()
        assert err <= TRAJ_RTOL * scale + TRAJ_ATOL, (path, err)
    assert tstate.opt["step"] == int(jstate.opt["step"]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference_leaf_for_leaf(arch):
    """R1: ndim >= 2 on layer-stacked leaves, so stacked norm scales and
    biases decay and ``final_norm.scale`` does not, as in the reference."""
    jcfg, cfg = _cfgs(arch)
    params = _jax_params(jcfg)
    ref = dict(_flat(joptim._decay_mask(params)))
    ours = dict(_flat(optim._decay_mask(from_jax_params(params, device="cpu"))))
    assert ours == ref
    assert ours[("final_norm", "scale")] == 0.0
    assert ours[("seg0", "b0", "ln1", "scale")] == 1.0


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(lr=1e-3, schedule=schedule, warmup_steps=3, total_steps=20)
    for step in (0, 1, 3, 7, 18, 20, 25):
        ref = float(joptim.schedule_lr(joptim.OptimizerConfig(**kw),
                                       jnp.asarray(step, jnp.int32)))
        assert float(optim.schedule_lr(optim.OptimizerConfig(**kw), step)) == (
            pytest.approx(ref, rel=1e-6, abs=1e-12))


def test_synthetic_tokens_equal_jax_bit_for_bit():
    for kw in (dict(vocab_size=256, seq_len=64, global_batch=4, seed=0),
               dict(vocab_size=151936, seq_len=33, global_batch=3, seed=7,
                    mean_doc_len=8)):
        ours, ref = SyntheticTokens(DataConfig(**kw)), JSyntheticTokens(JDataConfig(**kw))
        for step in (0, 1, 9):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_round_trip(arch):
    """A bfloat16-params JAX TrainState crosses both ways exactly."""
    jcfg, _ = _cfgs(arch, compute_dtype="bfloat16")
    master = jax.tree.map(jnp.asarray, _jax_params(jcfg))
    opt = joptim.init_opt_state(master)
    opt = {"m": jax.tree.map(lambda x: x + 0.5, opt["m"]),
           "v": jax.tree.map(lambda x: x + 0.25, opt["v"]),
           "step": jnp.asarray(3, jnp.int32)}
    state = JTrainState(params=jax.tree.map(lambda x: x.astype(jnp.bfloat16), master),
                        master=master, opt=opt)
    ours = from_jax_train_state(jax.tree.map(np.asarray, state), device="cpu")
    for _, leaf in _flat(ours.params):
        assert leaf.dtype == torch.bfloat16 and leaf.requires_grad
    back = to_jax_train_state(ours)
    rebuilt = JTrainState(
        params=jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                            back["params"]),
        master=back["master"], opt=back["opt"])
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch", "train", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


def test_cli_trains_on_the_cpu_and_refuses_without_a_card():
    out = _cli("--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
               "--steps", "3", "--seq-len", "64")
    assert out.returncode == 0, out.stderr
    steps = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 3
    losses = [float(ln.split()[3]) for ln in steps]
    assert all(np.isfinite(losses))
    if not torch.cuda.is_available():
        out = _cli("--arch", "qwen2-0.5b", "--smoke", "--steps", "1")
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr


def test_remat_dots_and_later_slices_raise(tmp_path):
    """remat "dots" runs (its loss equals "full"'s; the gradients are held
    in tests/test_torch_runtime.py); the arguments of items once refused
    run: MegaFT's ``obs`` and ``controller`` (held to JAX in
    tests/test_torch_ft.py) and ``compile_cache`` (item 12b), whose second
    run hits the first's record of the step, sets ``train.precompile_ms``
    and takes the same step."""
    _, cfg = _cfgs("qwen2-0.5b", remat="dots")
    params = lm.init(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 8, 0).items()}
    loss, _ = lm.loss_fn(cfg, params, batch)
    full, _ = lm.loss_fn(cfg.replace(remat="full"), params, batch)
    assert loss.item() == full.item()
    from repro_torch.train.loop import LoopConfig, train

    from repro_torch.core.tracing import Tracer
    from repro_torch.ft import FtController
    from repro_torch.obs import RankEventSpec

    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry

    for kw, item in ((dict(obs=RankEventSpec(dp=2)), "item 9"),
                     (dict(controller=FtController()), "item 9"),
                     (dict(compile_cache="cc"), "item 12b")):
        if item == "item 9":
            tracer = Tracer(rank=0)
            _, hist = train(cfg, optim.OptimizerConfig(), DataConfig(256, 8, 1),
                            LoopConfig(n_steps=1), device="cpu", tracer=tracer, **kw)
            assert [h["step"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
            fwd = sorted(e.rank for e in tracer.events if e.name == "fwd")
            assert fwd == ([0, 1] if "obs" in kw else [])
            continue
        # item 12b: the step's record put cold, hit warm, the same losses
        root = tmp_path / kw["compile_cache"]
        losses = []
        try:
            for hits in (0, 1):
                cache, reg = CompileCache(root), MetricsRegistry()
                _, hist = train(cfg, optim.OptimizerConfig(), DataConfig(256, 8, 1),
                                LoopConfig(n_steps=1), device="cpu",
                                compile_cache=cache, registry=reg)
                assert cache.stats.hits == hits and cache.stats.puts == 1 - hits
                assert reg.snapshot()["train.precompile_ms"] > 0
                losses.append(hist[0]["loss"])
        finally:
            _build.use_cache(None)
        assert losses[0] == losses[1]


def test_make_batch_and_count_params():
    """``make_batch`` draws token ids in range from the numpy generator it is
    given; ``count_params`` counts the JAX tree's elements."""
    jcfg, cfg = _cfgs("qwen2-0.5b")
    from repro.models.model import count_params as jcount
    from repro_torch.models.model import count_params, make_batch

    a = make_batch(cfg, 3, 10, np.random.default_rng(0))
    b = make_batch(cfg, 3, 10, np.random.default_rng(0))
    assert set(a) == {"tokens", "targets"}
    for k in a:
        assert a[k].shape == (3, 10) and a[k].dtype == torch.int32
        assert torch.equal(a[k], b[k])
        assert 0 <= int(a[k].min()) and int(a[k].max()) < cfg.vocab_size
    params = _jax_params(jcfg)
    assert count_params(from_jax_params(params, device="cpu")) == jcount(params)
