"""The port's MegaServe against the JAX package's, its refusals, and its CLI.

Greedy streams must be token-identical at float32 compute: the port serves
through flash prefill and paged decode (their plain versions on the CPU) and
JAX's MegaServe through ``decode_path="paged"``, ``prefill_path="flash"``
with its XLA reference attention, on the same weights and prompts.  That
holds through preemption-by-recompute on a squeezed pool too.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.weights import from_jax_params  # noqa: E402
from repro_torch.serve import MegaServe, ServeConfig  # noqa: E402
from repro_torch.serve.server import make_poisson_workload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_get_config("qwen2-0.5b", smoke=True).replace(
        compute_dtype="float32")
    cfg = get_config("qwen2-0.5b", smoke=True).replace(compute_dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


def _both(qwen, prompts, max_new, **geom):
    jcfg, cfg, params = qwen
    jsrv = JaxMegaServe(jcfg, jax.tree.map(jax.numpy.asarray, params),
                        JaxServeConfig(decode_path="paged",
                                       prefill_path="flash",
                                       paged_attn_impl="xla", **geom))
    srv = MegaServe(cfg, from_jax_params(params, device="cpu"),
                    ServeConfig(**geom), device="cpu")
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p, max_new)
    return jsrv.drain(), srv.drain(), jsrv, srv


def test_streams_match_jax(qwen):
    """Prompts of 5, 17, 33 and 64 tokens (non-block-multiples included)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 17, 33, 64)]
    ref, got, _, srv = _both(qwen, prompts, 8, num_slots=4, block_size=16,
                             num_blocks=40, max_blocks_per_slot=8)
    assert got == ref
    assert all(len(s) == 8 for s in got.values())
    ev = [e.name for e in srv.trace_events()]
    assert ev.count("prefill") == 4 and "decode" in ev


def test_streams_match_jax_under_preemption(qwen):
    """8 usable blocks of 8 for three 16+12-token sequences: the pool runs
    dry, requests are preempted and recomputed, and streams still match."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 256, size=16).tolist() for _ in range(3)]
    ref, got, jsrv, srv = _both(qwen, prompts, 12, num_slots=3, block_size=8,
                                num_blocks=9, max_blocks_per_slot=4)
    assert srv.metrics()["preemptions"] > 0
    assert srv.metrics()["preemptions"] == jsrv.metrics()["preemptions"]
    assert got == ref


def test_workload_matches_jax_workload(qwen):
    """The port's make_poisson_workload copies the JAX one: same specs,
    prompts and pool sizing from the same seed."""
    from repro.serve.server import make_poisson_workload as jax_workload

    jcfg, cfg, _ = qwen
    kw = dict(n=9, rate=50.0, prompt_lens=(16, 64), max_new_range=(2, 9),
              num_slots=3, block_size=8, seed=4)
    js, jp, jc = jax_workload(jcfg, **kw)
    ts, tp, tc = make_poisson_workload(cfg, **kw)
    assert [vars(s) for s in js] == [vars(s) for s in ts]
    assert jp == tp
    assert (jc.num_slots, jc.num_blocks, jc.block_size,
            jc.max_blocks_per_slot) == (tc.num_slots, tc.num_blocks,
                                        tc.block_size, tc.max_blocks_per_slot)


@pytest.mark.parametrize("knob,value", [
    ("decode_path", "gathered"), ("prefill_path", "dense"),
    ("spec_decode", True), ("chunked_prefill", True),
])
def test_later_slice_paths_are_refused(qwen, knob, value):
    _, cfg, params = qwen
    with pytest.raises(NotImplementedError, match="later|slice"):
        MegaServe(cfg, from_jax_params(params, device="cpu"),
                  ServeConfig(**{knob: value}), device="cpu")


def test_default_device_is_the_card(qwen):
    """Without a card, the default device raises instead of running on the
    CPU; with one, it is the card."""
    _, cfg, params = qwen
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MegaServe(cfg, from_jax_params(params, device="cpu"), ServeConfig())


def test_cli_serves_on_cpu(capsys):
    out = cli.run(["serve", "--arch", "qwen2-0.5b", "--smoke", "--device",
                   "cpu", "--continuous", "--requests", "5", "--rate", "300",
                   "--slots", "3", "--max-new", "6", "--prompt-lens", "16,40"])
    assert out["metrics"]["finished"] == 5
    assert out["metrics"]["preemptions"] == 0
    assert "decode_path=paged prefill_path=flash" in capsys.readouterr().out


def test_cli_module_runs_to_the_end():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--arch", "qwen2-0.5b",
         "--smoke", "--device", "cpu", "--continuous", "--requests", "4",
         "--rate", "400", "--slots", "2", "--max-new", "4",
         "--prompt-lens", "16,32", "--num-blocks", "12"],
        capture_output=True, text=True, env=env, timeout=240, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"serve_config"' in proc.stdout.splitlines()[-1]


def test_cli_refuses_static_serving():
    with pytest.raises(SystemExit, match="--continuous"):
        cli.main(["serve", "--arch", "qwen2-0.5b", "--smoke", "--device",
                  "cpu"])
