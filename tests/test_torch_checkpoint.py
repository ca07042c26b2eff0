"""The port's checkpointer: bit-exact round trips (bfloat16 included), the
atomic ``.tmp`` protocol, pruning and background-error surfacing, the JAX
package's on-disk layout in both directions (JAX's ``restore`` reads a port
checkpoint into a JAX ``TrainState``, the port restores a JAX one), and
``tests/test_integration.py::test_train_checkpoint_resume_equivalence``
again on the port, where the resumed losses and state are bit-identical to
an uninterrupted run's."""

import json
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.checkpoint import checkpointer as jck  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.train.train_step import init_train_state as jinit_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint.checkpointer import _items  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.optim import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import init_train_state  # noqa: E402

ARCH = "qwen2-0.5b"


def _state(seed, step=3):
    """A smoke TrainState (bfloat16 params, float32 master and moments)
    whose moments and step are not at their initial values."""
    cfg = get_config(ARCH, smoke=True)
    st = init_train_state(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for key, leaf in _items(st.opt):
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
    st.opt["step"] = step
    return st


def _assert_equal(a, b):
    ka, kb = dict(_items(a)), dict(_items(b))
    assert ka.keys() == kb.keys()
    for k, x in ka.items():
        y = kb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, k
            assert x.requires_grad == y.requires_grad, k
            assert torch.equal(x.detach(), y.detach()), k
        else:
            assert type(x) is type(y) and x == y, k


def test_round_trip_is_bit_exact_bf16_included(tmp_path):
    st = _state(0)
    path = save(st, 3, tmp_path, metadata={"arch": ARCH})
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["metadata"] == {"arch": ARCH}
    assert manifest["leaves"][".params.embedding"]["dtype"] == "bfloat16"
    assert manifest["leaves"][".opt.step"] == {"shape": [], "dtype": "int32"}
    assert np.load(path / ".params.embedding.npy").dtype == np.uint16
    back, _ = restore(tmp_path, _state(1, step=0))
    _assert_equal(back, st)


def test_keys_equal_the_jax_flatten_keys():
    jst = jinit_state(jax_get_config(ARCH, smoke=True), jax.random.PRNGKey(0))
    assert list(jck._flatten(jst)) == [k for k, _ in _items(_state(0))]


def test_tmp_left_by_a_crash_is_ignored(tmp_path):
    save(_state(0), 2, tmp_path)
    half = tmp_path / "step_00000009.tmp"
    half.mkdir()
    (half / "manifest.json").write_text("{}")
    (tmp_path / "step_00000005").mkdir()  # no manifest: never finished
    assert latest_step(tmp_path) == 2
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "absent", _state(0))


def test_keep_prunes_and_drain_surfaces_a_writer_error(tmp_path):
    ck = Checkpointer(tmp_path / "ck", keep=2)
    st = _state(0)
    for step in (1, 2, 3, 4):
        ck.save_async(st, step)
    ck.wait()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000003", "step_00000004"]
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    bad = Checkpointer(blocked)
    bad.save_async(st, 1)
    err = bad.drain()
    assert isinstance(err, OSError)
    assert bad.drain() is None
    bad.save_async(st, 1)
    with pytest.raises(OSError):
        bad.wait()


def test_save_async_snapshots_before_returning(tmp_path):
    ck = Checkpointer(tmp_path)
    st = _state(0)
    before = st.master["embedding"].clone()
    ck.save_async(st, 1)
    st.master["embedding"].add_(1.0)  # an in-place step right after
    ck.wait()
    back, _ = restore(tmp_path, _state(1))
    assert torch.equal(back.master["embedding"], before)


def test_jax_restores_a_port_checkpoint(tmp_path):
    st = _state(0)
    save(st, 3, tmp_path)
    target = jinit_state(jax_get_config(ARCH, smoke=True), jax.random.PRNGKey(9))
    got, manifest = jck.restore(tmp_path, target)
    assert manifest["step"] == 3
    jflat = jck._flatten(got)
    assert int(np.asarray(jflat[".opt.step"])) == 3
    for key, leaf in _items(st):
        ref = jflat[key]
        if isinstance(leaf, torch.Tensor):
            assert str(ref.dtype) == str(leaf.dtype).removeprefix("torch."), key
            np.testing.assert_array_equal(
                np.asarray(ref.astype(np.float32)),
                leaf.detach().float().numpy(), err_msg=key)


def test_port_restores_a_jax_checkpoint(tmp_path):
    jcfg = jax_get_config(ARCH, smoke=True)
    jst = jinit_state(jcfg, jax.random.PRNGKey(4))
    jst.opt["step"] = jax.numpy.asarray(7, jax.numpy.int32)
    jck.save(jst, 7, tmp_path)
    back, manifest = restore(tmp_path, _state(1, step=0))
    assert manifest["step"] == 7 and back.opt["step"] == 7
    jflat = jck._flatten(jst)
    for key, leaf in _items(back):
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_array_equal(
                leaf.detach().float().numpy(),
                np.asarray(jflat[key].astype(np.float32)), err_msg=key)


def test_train_checkpoint_resume_equivalence(tmp_path):
    """Interrupted-and-resumed training matches an uninterrupted run bit for
    bit (step-indexed data + checkpointed state), and so do the last
    checkpoints of both runs."""
    cfg = get_config(ARCH, smoke=True)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)

    def run(n, d):
        return train(cfg, ocfg, data, LoopConfig(
            n_steps=n, log_every=1, ckpt_dir=str(d), ckpt_every=4, seed=1),
            device="cpu")

    full_state, hist_full = run(8, tmp_path / "full")
    shutil.copytree(tmp_path / "full" / "step_00000004",
                    tmp_path / "res" / "step_00000004")
    res_state, hist_res = run(8, tmp_path / "res")
    assert [h["step"] for h in hist_res] == [5, 6, 7, 8]
    assert [h["loss"] for h in hist_res] == [h["loss"] for h in hist_full[4:]]
    _assert_equal(res_state, full_state)
    a, _ = restore(tmp_path / "full", _state(2))
    b, _ = restore(tmp_path / "res", _state(2))
    _assert_equal(a, b)
