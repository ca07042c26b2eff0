"""MegaFT in a world of ranks, on the CPU with gloo: the port's ``Session``
on each rank of a 2-rank ``Pool`` (spawned once for the module, as
``tests/test_torch_parallel.py`` spawns its worlds), its tasks in
``tests/_torch_ft_world_tasks.py``.  Rank 0 owns the detector and the
controller's decisions and sends every rank the actions at each step's
top; chaos fires on every rank at the same step.

* dp 2 with a crash at step 5 and a degraded link 0-1: both ranks restart
  at the same step and restore the checkpoint rank 0 wrote, both switch
  int8 compression on at the same step, and their losses equal a
  one-process supervised run of the same chaos (float32, rtol 1e-4: one
  int8 level can flip where the sums' roundings differ);
* pp 2 with a straggler on rank 1 (``obs.slow_rank=1``,
  ``ft.slow_frac_hard=1.1``) and a crash: the schedule replans to a wave
  on both stages, each rank restores the whole checkpoint and keeps its
  stage, and the losses equal the one-process pipelined step's (rtol
  2e-5, ``tests/test_torch_parallel.py``'s limit);
* compression at tp 2 is refused naming ROADMAP item 8c, and at pp 2 with
  dp 1 with JAX's ``ValueError``.
"""

import math
import os
import sys

import pytest

from repro_torch.app import cli
from repro_torch.configs import get_config

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ft_world_tasks as ft_tasks  # noqa: E402
import _torch_parallel_tasks as tasks  # noqa: E402

CFG = get_config("qwen2-0.5b", smoke=True).replace(compute_dtype="float32")
COMP_RTOL = 1e-4
LOSS_RTOL = 2e-5
BASE = ["train", "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
        "--seq-len", "32", "--global-batch", "4"]


@pytest.fixture(scope="module")
def pool():
    p = tasks.Pool(2, device="cpu", timeout=300)
    yield p
    p.close()


def _one_process(argv: list[str]) -> dict:
    out = cli.run(argv, model_cfg=CFG)
    return {**out["session"].results, "history": out["history"]}


def _losses(history) -> list[float]:
    return [h["loss"] for h in history]


@pytest.fixture(scope="module")
def dp_runs(pool, tmp_path_factory):
    d = tmp_path_factory.mktemp("ftw")
    chaos = ["--steps", "12", "--modules", "scan,metrics,ft", "--detect-online",
             "--set", "scan.detect_every=4", "--ckpt-every", "3",
             "--set", "ft.chaos.crash_at_step=5", "--set", "ft.chaos.degrade_link=0-1"]
    ranks = pool.run(ft_tasks.session_run,
                     [*BASE, *chaos, "--ckpt-dir", str(d / "w"),
                      "--set", "parallel.dp=2"], CFG)
    one = _one_process([*BASE, *chaos, "--ckpt-dir", str(d / "one")])
    return ranks, one


def test_dp2_crash_restores_on_every_rank(dp_runs):
    ranks, one = dp_runs
    for r in ranks:
        assert [h["step"] for h in r["history"]] == list(range(1, 13))
        restart = [t for t in r["ft"]["timeline"] if t["event"] == "restart"]
        assert [(t["step"], t["details"]["resumed_step"], t["details"]["reason"])
                for t in restart] == [(5, 3, "InjectedCrash")]
        assert r["ft"]["restarts"] == 1
    assert _losses(ranks[0]["history"]) == _losses(ranks[1]["history"])
    assert ranks[0]["series"]["ft.restarts"] == 1
    assert [r["coords"]["data"] for r in ranks] == [0, 1]


def test_dp2_compression_on_at_the_same_step_equals_one_process(dp_runs):
    ranks, one = dp_runs
    on = [next(t for t in r["ft"]["timeline"] if t["event"] == "mitigate:compress_on")
          for r in ranks]
    one_on = next(t for t in one["ft"]["timeline"]
                  if t["event"] == "mitigate:compress_on")
    assert on[0] == on[1] == one_on
    assert on[0]["details"]["links"] == [[0, 1]]
    d = on[0]["details"]
    assert 0 < d["wire_bytes_per_sync"] < d["baseline_bytes_per_sync"]
    # rank 0 alone decides (its detector); every rank acts
    assert [t["event"] for t in ranks[0]["ft"]["timeline"]].count("decide:replan") == 1
    assert not any(t["event"].startswith("decide") for t in ranks[1]["ft"]["timeline"])
    assert ranks[1]["scan"].get("online") is None
    assert ranks[0]["scan"]["online"]["degraded_links"] == [[0, 1]]
    assert all(r["ft"]["compression_on"] for r in ranks)
    assert _losses(ranks[0]["history"]) == pytest.approx(_losses(one["history"]),
                                                         rel=COMP_RTOL)


def test_pp2_replans_to_wave_and_restores_each_stage(pool, tmp_path):
    argv = ["--steps", "12", "--pp", "2", "--n-micro", "2",
            "--modules", "scan,metrics,ft", "--detect-online",
            "--set", "scan.detect_every=4", "--set", "obs.rank_events=true",
            "--set", "obs.slow_rank=1", "--set", "obs.slow_factor=0.5",
            "--set", "ft.slow_frac_hard=1.1", "--ckpt-every", "3",
            "--set", "ft.chaos.crash_at_step=4"]
    ranks = pool.run(ft_tasks.session_run,
                     [*BASE, *argv, "--ckpt-dir", str(tmp_path / "w")], CFG)
    ref = _one_process([*BASE, "--steps", "12", "--modules", "none"])
    for r in ranks:
        f = r["ft"]
        assert f["replans"] == 1 and f["restarts"] == 1
        rp = next(t for t in f["timeline"] if t["event"] == "mitigate:replan_schedule")
        assert rp["details"]["slow_ranks"] == [1] and rp["details"]["wave"] >= 1
        assert [h["step"] for h in r["history"]] == list(range(1, 13))
        assert all(math.isfinite(x) for x in _losses(r["history"]))
    assert [r["coords"]["stage"] for r in ranks] == [0, 1]
    for r in ranks:
        restart = next(t for t in r["ft"]["timeline"] if t["event"] == "restart")
        assert restart["details"] == {"resumed_step": 3, "reason": "InjectedCrash",
                                      "restart": 1}
    assert ranks[0]["scan"]["online"]["slow_ranks"] == [1]
    assert _losses(ranks[0]["history"]) == pytest.approx(_losses(ref["history"]),
                                                         rel=LOSS_RTOL)


def test_compression_refused_off_pp1_tp1_in_a_world(pool):
    for msgs in pool.run(ft_tasks.compression_refusals, CFG):
        tp, pp = msgs
        assert tp.startswith("NotImplementedError") and "item 8c" in tp
        assert tp.count("tp=2") == 1
        assert pp.startswith("ValueError") and "dp=1 has no data axis" in pp
