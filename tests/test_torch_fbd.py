"""MegaFBD on the port: ``tests/test_fbd.py``'s coordinator and placement
cases on ``repro_torch.core.fbd``, the port's launch orders, placements and
``evaluate_placement`` times against ``repro.core.fbd``'s on the same
inputs, and the decoupled forward/backward against ``torch.autograd.grad``:
bit for bit on an MLP and on the qwen2 smoke loss under remat ``"none"``
and ``"full"``, after the residuals' round trip too, and its residual bytes
against a hand count.  ``parallel.fbd_backward`` at ``pp = 1`` changes no
loss, as in JAX."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare env: deterministic few-example fallback
    from _hypothesis_shim import given, settings
    import _hypothesis_shim as st

jax = pytest.importorskip("jax")

from repro.app.config import build_run_config as jbuild  # noqa: E402
from repro.app.session import Session as JSession  # noqa: E402
from repro.core.fbd import coordinator as jcoord  # noqa: E402
from repro.core.fbd import ranks as jranks  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fbd import (  # noqa: E402
    BitVectorCoordinator,
    ThreadProgram,
    colocated_placement,
    decoupled_grad,
    evaluate_placement,
    make_decoupled_step,
    plan_placement,
    run_fcfs,
    run_with_coordinator,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import compute_params  # noqa: E402

# ------------------------------------------------------------ coordinator --


def _cross_control_scenario(mod=None):
    # two controls, two workers each; two 2-member cross-control collectives
    TP = mod.ThreadProgram if mod else ThreadProgram
    groups = {1: (0, 2), 2: (1, 3)}
    programs = [
        TP(vrank=0, control=0, group_ids=[1]),
        TP(vrank=1, control=0, group_ids=[2]),
        TP(vrank=2, control=1, group_ids=[1]),
        TP(vrank=3, control=1, group_ids=[2]),
    ]
    return programs, groups


def test_fcfs_launcher_can_deadlock():
    programs, groups = _cross_control_scenario()
    outcomes = {run_fcfs(programs, groups, 2, arrival_seed=s) is None
                for s in range(24)}
    assert True in outcomes, "expected at least one deadlocking interleaving"


def test_fcfs_outcomes_equal_jax():
    programs, groups = _cross_control_scenario()
    jprograms, _ = _cross_control_scenario(jcoord)
    for s in range(24):
        assert run_fcfs(programs, groups, 2, arrival_seed=s) == \
            jcoord.run_fcfs(jprograms, groups, 2, arrival_seed=s)


def test_coordinator_never_deadlocks_on_same_scenario():
    programs, groups = _cross_control_scenario()
    order = run_with_coordinator(programs, groups, 2)
    assert order == [1, 2]  # ascending group order among simultaneously-ready


def _consistent_programs(data):
    n_vranks = data.draw(st.integers(2, 8))
    n_controls = data.draw(st.integers(1, 4))
    control_of = [data.draw(st.integers(0, n_controls - 1)) for _ in range(n_vranks)]
    n_colls = data.draw(st.integers(1, 12))
    groups = {}
    for g in range(1, n_colls + 1):
        members = data.draw(
            st.sets(st.integers(0, n_vranks - 1), min_size=1, max_size=n_vranks)
        )
        groups[g] = tuple(sorted(members))

    def programs(TP):
        return [TP(vrank=v, control=control_of[v],
                   group_ids=[g for g in sorted(groups) if v in groups[g]])
                for v in range(n_vranks)]

    return programs, groups, n_controls


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_coordinator_deadlock_freedom_property_and_jax_order(data):
    """Any *consistent* set of thread programs (per-thread orders drawn from
    one global order) completes under the coordinator, in JAX's order."""
    programs, groups, n_controls = _consistent_programs(data)
    order = run_with_coordinator(programs(ThreadProgram), groups, n_controls)
    assert sorted(order) == sorted(groups)
    assert order == jcoord.run_with_coordinator(
        programs(jcoord.ThreadProgram), groups, n_controls)


def test_coordinator_state_is_linear_in_groups():
    g_small = {i: (0, 1) for i in range(4)}
    g_big = {i: (0, 1) for i in range(64)}
    c_small = BitVectorCoordinator(g_small, 2, 1)
    c_big = BitVectorCoordinator(g_big, 2, 1)
    assert c_big.state_bytes == 16 * c_small.state_bytes  # O(G)


# -------------------------------------------------------------- placement --

SPEEDS = {
    "heterogeneous": {d: 1.0 for d in range(4)} | {d: 0.4 for d in range(4, 8)},
    "homogeneous": {d: 1.0 for d in range(8)},
    "two-devices": {0: 1.0, 1: 0.5},
}


def test_decoupling_wins_on_heterogeneous_cluster():
    speed = SPEEDS["heterogeneous"]
    dec = evaluate_placement(plan_placement(8, speed))
    col = evaluate_placement(colocated_placement(8, speed))
    assert dec < col, (dec, col)


def test_colocated_fine_on_homogeneous_cluster():
    speed = SPEEDS["homogeneous"]
    dec = evaluate_placement(plan_placement(8, speed))
    col = evaluate_placement(colocated_placement(8, speed))
    assert dec >= col * 0.95  # no spurious "win" from the transfer model


def test_virtual_rank_counts_preserved():
    pl = plan_placement(8, SPEEDS["two-devices"])
    assert pl.mapping.n_virtual == 8
    assert len(pl.mapping.fwd_device) == len(pl.mapping.bwd_device) == 8


@pytest.mark.parametrize("name", list(SPEEDS))
@pytest.mark.parametrize("n_virtual", [3, 8])
def test_placements_and_times_equal_jax(name, n_virtual):
    speed = SPEEDS[name]
    for ours, ref in ((plan_placement(n_virtual, speed),
                       jranks.plan_placement(n_virtual, speed)),
                      (colocated_placement(n_virtual, speed),
                       jranks.colocated_placement(n_virtual, speed))):
        assert ours.mapping.fwd_device == ref.mapping.fwd_device
        assert ours.mapping.bwd_device == ref.mapping.bwd_device
        kw = dict(n_micro=4, act_bytes=8 << 20)
        assert evaluate_placement(ours, **kw) == jranks.evaluate_placement(ref, **kw)


# --------------------------------------------------------- decoupled grad --


def _mlp():
    g = torch.Generator().manual_seed(0)
    params = {"W1": (torch.randn(8, 16, generator=g) * 0.3).requires_grad_(True),
              "W2": (torch.randn(16, 4, generator=g) * 0.3).requires_grad_(True)}
    batch = {"x": torch.randn(5, 8, generator=g), "t": torch.randn(5, 4, generator=g)}

    def loss_fn(params, batch):
        h = torch.tanh(batch["x"] @ params["W1"])
        y = h @ params["W2"]
        return torch.mean((y - batch["t"]) ** 2)

    return loss_fn, params, batch


def _qwen(remat):
    cfg = get_config("qwen2-0.5b", smoke=True).replace(
        compute_dtype="float32", remat=remat)
    params = compute_params(lm.init(cfg, seed=0, device="cpu"), torch.float32)
    batch = make_batch(cfg, 2, 48, np.random.default_rng(0))
    return (lambda p, b: lm.loss_fn(cfg, p, b)[0]), params, batch, cfg


def _fused(loss_fn, params, batch):
    flat = [p for _, p in optim.leaves(params)]
    loss = loss_fn(params, batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


CASES = ["mlp", "qwen2-remat-none", "qwen2-remat-full"]


def _case(name):
    if name == "mlp":
        return _mlp()
    return _qwen(name.rsplit("-", 1)[1])[:3]


@pytest.mark.parametrize("round_trip", [False, True], ids=["direct", "copied"])
@pytest.mark.parametrize("case", CASES)
def test_decoupled_grads_equal_autograd_bit_for_bit(case, round_trip):
    """The same graph and kernels in the same order: loss and every
    gradient leaf equal ``torch.autograd.grad``'s exactly; with the
    residuals replaced by copies between fwd and bwd (the F→B transfer, and
    the originals dropped) as well."""
    loss_fn, params, batch = _case(case)
    ref_loss, ref_grads = _fused(loss_fn, params, batch)
    step = make_decoupled_step(loss_fn)
    if round_trip:
        loss, res = step.fwd(params, batch)
        originals = [t.data_ptr() for t in res.tensors]
        res.tensors = [t.clone() for t in res.tensors]
        assert not set(originals) & {t.data_ptr() for t in res.tensors}
        grads = step.bwd(params, batch, res, torch.ones_like(loss))
    else:
        loss, grads = decoupled_grad(step, params, batch)
    assert torch.equal(loss, ref_loss)
    flat = [g for _, g in optim.leaves(grads)]
    assert len(flat) == len(ref_grads)
    assert all(torch.equal(a, b) for a, b in zip(flat, ref_grads))


def test_residuals_exclude_parameters_and_batch():
    loss_fn, params, batch = _mlp()
    _, res = make_decoupled_step(loss_fn).fwd(params, batch)
    held = {t.untyped_storage().data_ptr() for t in (*params.values(), *batch.values())}
    assert res.tensors and not {t.untyped_storage().data_ptr() for t in res.tensors} & held


@pytest.mark.parametrize("batch_mask", [False, True], ids=["own-mask", "batch-mask"])
def test_residual_bytes_equal_the_hand_count_under_remat_full(batch_mask):
    """qwen2 smoke at float32 on the CPU, remat ``"full"``: what checkpoint
    keeps of each layer, its input [B, S, D], plus what is saved outside
    the layers: the positions (int64 [S], once), the final norm's input
    and (plain version) its rstd [B, S, 1] and x * rstd, the chunked cross
    entropy's input [B, S, D] and mask [B, S] (a batch leaf when the batch
    brings a float32 ``loss_mask``), and three float32 scalars of the mean
    (the count the clamp keeps, the sum and the clamped count the division
    keeps).  Parameters and batch leaves are no residuals."""
    loss_fn, params, batch, cfg = _qwen("full")
    B, S = batch["tokens"].shape
    if batch_mask:
        batch["loss_mask"] = torch.ones((B, S))
    D, n_layers, f32 = cfg.d_model, cfg.num_layers, 4
    hand = (n_layers * B * S * D * f32 + S * 8 + B * S * D * f32 + B * S * f32
            + B * S * D * f32 + B * S * D * f32 + (0 if batch_mask else B * S * f32)
            + 3 * f32)
    step = make_decoupled_step(loss_fn)
    assert step.residual_bytes(params, batch) == hand > 0
    _, res = step.fwd(params, batch)
    assert res.nbytes == hand


def test_fbd_backward_at_pp1_changes_no_loss_as_in_jax():
    argv = ["train", "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--steps", "2", "--set", "train.seq_len=32",
            "--set", "train.global_batch=2", "--modules", "none"]
    on = cli.run([*argv, "--set", "parallel.fbd_backward=true"])
    off = cli.run(argv)
    assert [h["loss"] for h in on["history"]] == [h["loss"] for h in off["history"]]
    assert [h["grad_norm"] for h in on["history"]] == [h["grad_norm"] for h in off["history"]]
    # JAX resolves no plan at pp = 1, so its flag attaches nothing there
    jcfg = jbuild("train", arch="qwen2-0.5b", smoke=True,
                  sets=["parallel.fbd_backward=true", "modules=none"])
    assert JSession(jcfg).parallel_plan() is None
