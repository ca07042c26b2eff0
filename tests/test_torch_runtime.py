"""The port's train path through its runtime (``Session``, the ``scan`` and
``metrics`` plugins, ``RunConfig`` layering, trace and metrics export) held
to ``repro.train.loop.train`` called directly, at float32 on the CPU; the
flop count behind the MFU estimate against a count written out by hand; and
remat ``"dots"`` against remat ``"full"`` and JAX's ``"dots"``.

The train command is the one the README gives:

    python -m repro_torch train --arch qwen2-0.5b --smoke --device cpu \\
        --steps 8 --set train.seq_len=64 --set train.log_every=4 \\
        --modules scan,metrics --trace-out t.json --metrics-out m.jsonl

run in process with the smoke config at float32 and both sides starting
from the JAX package's initial state (the port's ``init_train_state`` is
pointed at it, so the ``init`` scope still runs).  At seq 64 the smoke
config's attention (``attn_kv_chunk=32``) takes the flash branch: K2's
plain version on the CPU, which the flop count replaces by K2's formula.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tracing import Tracer as JTracer  # noqa: E402
from repro.core.tracing import from_chrome as jax_from_chrome  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import StepHooks as JStepHooks  # noqa: E402
from repro.train.loop import train as jax_train  # noqa: E402
from repro.train.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train.train_step import init_train_state as jinit_state  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tracing import load_jsonl, load_trace  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import from_jax_params, from_jax_train_state  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402

ARCH = "qwen2-0.5b"
STEPS, SEQ, BATCH = 8, 64, 8  # the smoke batch default
# tests/test_torch_train.py's trajectory tolerance for per-step scalars
SCALAR_RTOL = 1e-5
LOSS_RTOL, GRAD_TOL = 2e-6, 2e-5  # and its loss and gradient tolerances
TIMED = ("train.step_time_s", "train.tokens_per_s", "train.model_flops_per_s")


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX loop and the port's CLI on the same float32 smoke run."""
    tmp = tmp_path_factory.mktemp("runtime")
    jcfg, cfg = _cfgs()
    j_losses, j_rows = [], []

    def on_step(events, metrics):
        j_rows.append({k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")})

    jtracer, jreg = JTracer(rank=0), JRegistry()
    jax_train(
        jcfg,
        JOptimizerConfig(lr=3e-4, schedule="cosine", warmup_steps=5,
                         total_steps=STEPS),
        JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
        JLoopConfig(n_steps=STEPS, log_every=4, seed=0),
        tracer=jtracer, hooks=JStepHooks(on_step=on_step), registry=jreg)
    j_losses = [r["loss"] for r in j_rows]

    jstate0 = jax.tree.map(np.asarray, jinit_state(jcfg, jax.random.PRNGKey(0)))
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop, "init_train_state",
               lambda cfg, seed, device: from_jax_train_state(jstate0, device))
    try:
        out = cli.run(
            ["train", "--arch", ARCH, "--smoke", "--device", "cpu",
             "--steps", str(STEPS), "--set", f"train.seq_len={SEQ}",
             "--set", "train.log_every=4", "--modules", "scan,metrics",
             "--trace-out", str(tmp / "t.json"),
             "--metrics-out", str(tmp / "m.jsonl")],
            model_cfg=cfg)
    finally:
        mp.undo()
    return dict(tmp=tmp, jtracer=jtracer, jreg=jreg, j_rows=j_rows,
                j_losses=j_losses, out=out)


def test_losses_equal_jax(runs):
    hist = runs["out"]["history"]
    assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
    for h, j in zip(hist, runs["j_rows"], strict=True):
        for k in ("loss", "grad_norm", "lr"):
            assert h[k] == pytest.approx(j[k], rel=SCALAR_RTOL), (h["step"], k)
    assert hist[-1]["loss"] < hist[0]["loss"]


def _spans(events):
    return Counter(e.name for e in events if e.kind != "counter")


def test_trace_export_loads_with_jax_and_equals_its_spans(runs):
    tmp = runs["tmp"]
    want = _spans(runs["jtracer"].events)
    assert want == {"init": 1, "train_step": STEPS}
    doc = json.loads((tmp / "t.json").read_text())
    jev = jax_from_chrome(doc)
    assert _spans(jev) == want
    counters = [e for e in jev if e.kind == "counter"]
    assert {e.name for e in counters} >= {"train.loss", "train.step_time_s.p50"}
    # the streamed sidecar holds the same spans, and the port loads both
    assert _spans(load_jsonl(tmp / "t.jsonl")) == want
    assert _spans(load_trace(tmp / "t.json")) == want
    session = runs["out"]["session"]
    assert _spans(session.tracer.events) == want
    assert session.results["scan"]["stream"] == str(tmp / "t.jsonl")


def test_registry_series_equal_jax(runs):
    jsnap = runs["jreg"].snapshot()
    tsnap = runs["out"]["session"].metrics_registry.snapshot()
    skip = ("train.model_flops_per_s", "train.device_mem_bytes")
    assert {k for k in tsnap if k not in skip} == {k for k in jsnap if k not in skip}
    assert "train.model_flops_per_s" in tsnap and "train.device_mem_bytes" not in tsnap
    for k, v in jsnap.items():
        if k in skip:
            continue
        if k in TIMED:  # wall-clock series: same shape, not the same times
            if isinstance(v, dict):
                assert tsnap[k]["count"] == v["count"] == STEPS, k
            continue
        assert tsnap[k] == pytest.approx(v, rel=SCALAR_RTOL), k
    assert tsnap["train.loss"] == pytest.approx(runs["j_losses"][-1], rel=SCALAR_RTOL)


def test_metrics_file_has_a_row_per_step(runs):
    rows = [json.loads(ln) for ln in (runs["tmp"] / "m.jsonl").read_text().splitlines()]
    hist = runs["out"]["history"]
    assert [r["step"] for r in rows] == list(range(1, STEPS + 1))
    assert [r["train.loss"] for r in rows] == [h["loss"] for h in hist]
    report = runs["out"]["session"].results["metrics"]
    assert report["rows"] == STEPS and "mfu_est" not in report


def _analytic_flops(cfg, B, S, remat):
    """Products of one forward and backward of the smoke qwen2 loss, by
    hand: every matrix product of a layer costs 2·m·n·k in the forward and
    twice that in the backward (dX and dW); K2 (flash branch) 4·d per
    query-key pair forward and 10·d backward; the chunked cross entropy
    forms the logits once forward and again in its backward before its two
    products.  Full remat runs the layer's forward once more in the
    backward, up to its last saved tensor: the non-reentrant checkpoint
    stops there, so the MLP's down projection, whose output nothing saves,
    is not recomputed."""
    T, D, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    down = 2 * T * F * D
    layer = 2 * T * D * (H * dh + 2 * K * dh) + 2 * T * H * dh * D + 2 * 2 * T * D * F + down
    pairs = S * (S + 1) // 2
    attn_fwd, attn_bwd = 4 * B * H * pairs * dh, 10 * B * H * pairs * dh
    per_layer = 3 * layer + attn_fwd + attn_bwd
    if remat == "full":
        per_layer += layer - down + attn_fwd
    return cfg.num_layers * per_layer + 4 * 2 * T * D * V


@pytest.mark.parametrize("remat", ["full", "none"])
def test_flop_count_equals_an_analytic_count(remat):
    _, cfg = _cfgs(remat=remat)
    state = tloop.init_train_state(cfg, seed=0, device="cpu")
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, SEQ, BATCH)).batch_at(0)
    got = tloop.step_flops(cfg, state, batch)
    want = _analytic_flops(cfg, BATCH, SEQ, remat)
    assert abs(got - want) <= 0.01 * want, (got, want)


def _jax_dots(jcfg, params, batch):
    def jloss(p):
        return jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return float(jl), jg


def _port_loss_grads(cfg, params, batch):
    tp = from_jax_params(params, device="cpu")
    for _, leaf in leaves(tp):
        leaf.requires_grad_(True)
    loss, _ = lm.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    paths, flat = zip(*leaves(tp))
    return loss.item(), dict(zip(paths, torch.autograd.grad(loss, flat)))


@pytest.mark.parametrize("seq", [48, 32], ids=["flash", "naive"])
def test_remat_dots_equals_full_and_jax(seq):
    jcfg, cfg = _cfgs(remat="dots")
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32),
             "loss_mask": (rng.random((2, seq)) > 0.1).astype(np.float32)}
    loss, grads = _port_loss_grads(cfg, params, batch)
    full_loss, full_grads = _port_loss_grads(cfg.replace(remat="full"), params, batch)
    assert loss == full_loss
    for path, g in grads.items():
        assert torch.equal(g, full_grads[path]), path
    jl, jg = _jax_dots(jcfg, params, batch)
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl)
    jflat = dict(leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        ref = jflat[path]
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-6), (path, err)


def test_dots_policy_saves_the_unbatched_products_only(monkeypatch):
    """What remat "dots" keeps: the forward's ``mm`` outputs (projections,
    MLP); ``bmm`` (attention's batched products at seq 32) and everything
    else is recomputed."""
    _, cfg = _cfgs(remat="dots")
    decisions = []
    real = lm.dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op.overloadpacket.__name__, out))
        return out

    monkeypatch.setattr(lm, "dots_policy", recording)
    params = lm.init(cfg, seed=0, device="cpu")
    for _, leaf in leaves(params):
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(DataConfig(cfg.vocab_size, 32, 2)).batch_at(0).items()}
    loss, _ = lm.loss_fn(cfg, params, batch)
    torch.autograd.grad(loss, [leaf for _, leaf in leaves(params)])
    saved = {name for name, d in decisions if d.name == "MUST_SAVE"}
    recomputed = {name for name, d in decisions if d.name != "MUST_SAVE"}
    assert saved == {"mm"}
    assert "bmm" in recomputed and "mm" not in recomputed
    # each layer's seven projections and MLP products are kept
    assert sum(name == "mm" for name, _ in decisions) == 7 * cfg.num_layers


def test_prefetcher_replays_batches_from_its_start_step():
    """``make_pipeline(start_step=n)`` yields ``batch_at(n), batch_at(n + 1),
    ...``, the JAX package's batches, so a resumed run sees the batches of
    an uninterrupted one."""
    from repro.data.pipeline import make_pipeline as jax_pipeline
    from repro_torch.data.pipeline import make_pipeline

    kw = dict(vocab_size=256, seq_len=16, global_batch=2, seed=4)
    ours = make_pipeline(DataConfig(**kw), start_step=3)
    ref = jax_pipeline(JDataConfig(**kw), start_step=3)
    src = SyntheticTokens(DataConfig(**kw))
    try:
        for step in (3, 4, 5):
            a, b = ours.next(), ref.next()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], src.batch_at(step)[k])
    finally:
        ours.close()
        ref.close()
