"""The port's app layer against ``repro.app``: ``RunConfig`` layering gives
the same configuration for the same arguments, ``TestRunConfig`` of
``tests/test_app.py`` runs again on the port, the ``trace`` workload writes
the same diagnosis as JAX's, continuous serving with the ``scan`` and
``metrics`` modules streams the same tokens as without them and publishes
JAX ``MegaServe``'s series names, training with the ``scope`` and ``fbd``
modules reports what JAX's plugins report, every single-engine serving path
(static, gathered, MegaScope probes, chunked prefill, speculation with either
drafter) runs to the end through the CLI, and the command lines of items
once refused (MegaFT, the compile cache, the dryrun) run."""

import json
import re
import types
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

from repro.app import cli as jcli  # noqa: E402
from repro.app.config import build_run_config as jbuild  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.serve import MegaServe as JaxMegaServe  # noqa: E402
from repro.serve.server import make_poisson_workload as jax_workload  # noqa: E402
from repro_torch.app import cli  # noqa: E402
from repro_torch.app.config import build_run_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"

ARGVS = [
    ["train", "--arch", ARCH, "--smoke", "--steps", "8", "--set",
     "train.seq_len=64", "--set", "train.log_every=4", "--modules",
     "scan,metrics", "--trace-out", "t.json", "--metrics-out", "m.jsonl"],
    ["train", "--arch", ARCH, "--set", "modules=none", "--ckpt-dir", "ck",
     "--ckpt-every", "4", "--set", "obs.peak_tflops=989", "--lr", "1e-3",
     "--schedule", "wsd", "--grad-accum", "2", "--seed", "3"],
    ["serve", "--arch", ARCH, "--smoke", "--continuous", "--requests", "5",
     "--rate", "300", "--slots", "3", "--max-new", "6", "--prompt-lens",
     "16,40", "--num-blocks", "12", "--set", "serve.spec_k=6"],
    ["trace", "--slow-rank", "3", "--iters", "2", "--dp", "2", "--pp", "2",
     "--tp", "2", "--n-micro", "4", "--out", "d", "--set",
     "scan.slow_ratio=1.3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["train", "train-knobs", "serve", "trace"])
def test_run_config_equals_jax(argv, tmp_path):
    cfg_file = tmp_path / "run.json"
    cfg_file.write_text(json.dumps({"train": {"steps": 7, "lr": 9e-4},
                                    "serve": {"slots": 2}, "seed": 1}))
    argv = [*argv, "--config", str(cfg_file)]
    jwl, jcfg = jcli._parse(argv)
    wl, cfg = cli.parse([*argv, "--device", "cpu"])
    assert wl == jwl
    ours = cfg.to_dict()
    assert ours["runtime"].pop("device") == "cpu"
    assert ours == jcfg.to_dict()


def test_layering_by_keyword_equals_jax():
    kw = dict(sets=["train.lr=5e-4", "modules=scan,metrics", "smoke=1"],
              train__steps=3, arch=ARCH)
    assert build_run_config("train", **kw).to_dict()["train"] == \
        jbuild("train", **kw).to_dict()["train"]


def _port_module(name: str) -> types.ModuleType:
    """``tests/<name>.py`` executed with its ``repro.`` imports pointed at
    ``repro_torch.``."""
    path = ROOT / "tests" / f"{name}.py"
    src = re.sub(r"^(\s*)from repro\.", r"\1from repro_torch.",
                 path.read_text(), flags=re.M)
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


# the reference's RunConfig cases, on the port's RunConfig
TestRunConfigOnThePort = _port_module("test_app").TestRunConfig


def test_trace_workload_writes_jax_diagnosis(tmp_path):
    argv = ["trace", "--slow-rank", "5", "--iters", "2"]
    ours = cli.run([*argv, "--out", str(tmp_path / "t")])
    jcli.run([*argv, "--out", str(tmp_path / "j")])
    assert ours["truth"]["detected"] and ours["truth"]["slow_ranks"] == [5]
    assert (tmp_path / "t" / "diagnosis.json").read_text() == \
        (tmp_path / "j" / "diagnosis.json").read_text()
    assert json.loads((tmp_path / "t" / "trace.json").read_text()) == \
        json.loads((tmp_path / "j" / "trace.json").read_text())
    # offline triage of the saved trace (and of JAX's) gives JAX's diagnosis
    for side in ("t", "j"):
        argv = ["trace", "--detect", str(tmp_path / side / "trace.json")]
        again = cli.run(argv)
        assert again["diagnosis"] == jcli.run(argv)["diagnosis"]
        assert again["diagnosis"]["slow_ranks"] == [5]


SERVE = ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
         "--continuous", "--requests", "6", "--rate", "400", "--slots", "3",
         "--max-new", "6", "--prompt-lens", "16,40"]


def test_serve_modules_on_off_identical_and_series_equal_jax(tmp_path):
    cfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    on = cli.run([*SERVE, "--modules", "scan,metrics",
                  "--trace-out", str(tmp_path / "s.json"),
                  "--metrics-out", str(tmp_path / "m.jsonl")], model_cfg=cfg)
    off = cli.run([*SERVE, "--modules", "none"], model_cfg=cfg)
    assert on["streams"] == off["streams"]
    session = on["session"]
    reg = session.metrics_registry
    assert off["session"].metrics_registry is None
    assert not off["session"].tracer.events
    n = len(on["streams"])
    assert reg.snapshot()["serve.ttft_s"]["count"] == n
    assert reg.snapshot()["serve.tokens"] == sum(len(s) for s in on["streams"].values())
    names = {e.name for e in session.tracer.events}
    assert {"prefill", "decode"} <= names
    # the JAX MegaServe on the same workload publishes the same series
    jcfg = jax_get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    specs, prompts, scfg = jax_workload(
        jcfg, n=6, rate=400.0, prompt_lens=(16, 40), max_new_range=(1, 6),
        num_slots=3, block_size=16, num_blocks=0, seed=0)
    from dataclasses import replace

    jreg = JRegistry()
    jsrv = JaxMegaServe(
        jcfg, jlm.init(jcfg, jax.random.PRNGKey(0)),
        replace(scfg, decode_path="paged", prefill_path="flash",
                paged_attn_impl="xla"), registry=jreg)
    for s in specs:
        jsrv.submit(prompts[s.rid], s.max_new, arrival=s.arrival)
    jsrv.drain()
    assert set(reg.snapshot()) == set(jreg.snapshot())
    rows = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(rows) == session.results["metrics"]["rows"] > 0


def test_peak_tflops_gives_an_mfu_estimate(tmp_path):
    out = cli.run(["train", "--arch", ARCH, "--smoke", "--device", "cpu",
                   "--steps", "2", "--set", "train.seq_len=32",
                   "--set", "train.global_batch=2",
                   "--set", "obs.peak_tflops=0.001"])
    report = out["session"].results["metrics"]
    flops_s = out["session"].metrics_registry.snapshot()["train.model_flops_per_s"]
    # the report rounds to 6 decimals, as the JAX plugin does
    assert report["mfu_est"] == pytest.approx(flops_s["p50"] / 1e9, abs=1e-6)


def test_scope_and_fbd_modules_report_what_jax_plugins_report():
    """``train --modules scan,scope,fbd`` on the CPU: the ``scope`` report
    (probes, perturbations, one captured hit a step for every leaf) equals
    JAX ``ScopePlugin``'s over the JAX loop run directly with the same
    collector settings and steps (``Session.train`` itself fails on this
    tree: ROADMAP R3), and the ``fbd`` report equals JAX ``FbdPlugin``'s for
    the same section."""
    from repro.app import plugins as jplugins
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.train.loop import LoopConfig as JLoopConfig
    from repro.train.loop import StepHooks as JStepHooks
    from repro.train.loop import train as jtrain
    from repro.train.optim import OptimizerConfig as JOptimizerConfig

    probes = "mlp_hidden:stats,att_resid:stats,q:channels,final_hidden:stats"
    argv = ["train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--set", "train.seq_len=32", "--set", "train.global_batch=2",
            "--modules", "scan,scope,fbd", "--set", f"scope.probes={probes}",
            "--set", "scope.perturbs=ffn_resid:offset:0.0:99",
            "--set", "fbd.n_virtual=6"]
    out = cli.run(argv)
    ours = out["session"].results
    _, jcfg = jcli._parse(argv[:4] + argv[6:])  # JAX has no --device
    session = types.SimpleNamespace()
    scope_plugin = jplugins.ScopePlugin(jcfg)
    scope_plugin.setup(session)
    fbd_plugin = jplugins.FbdPlugin(jcfg)
    fbd_plugin.setup(session)
    mcfg = jax_get_config(ARCH, smoke=True)
    jtrain(mcfg, JOptimizerConfig(total_steps=2),
           JDataConfig(vocab_size=mcfg.vocab_size, seq_len=32, global_batch=2),
           JLoopConfig(n_steps=2, log_every=1), collector=session.collector,
           hooks=JStepHooks(on_step=lambda ev, m: scope_plugin.on_step(session, ev, m)))
    assert ours["scope"] == scope_plugin.finalize(session)
    assert set(ours["scope"]["captured"].values()) == {2}
    assert ours["fbd"] == fbd_plugin.finalize(session)
    assert len(out["history"]) == 2


@pytest.mark.parametrize("argv,item", [
    (["train", "--modules", "scan,ft"], "item 9"),
    (["train", "--detect-online"], "item 9"),
    (["train", "--compile-cache", "cc"], "item 12b"),
    (["train", "--set", "obs.rank_events=true"], "item 9"),
    (["dryrun"], "item 14b"),
], ids=lambda v: "-".join(v) if isinstance(v, list) else v)
def test_later_slices_are_refused_with_their_item(argv, item, tmp_path):
    """The items these command lines once were refused for are ported, and
    each runs.  Item 9 (MegaFT and live detection): two short steps that
    report ``results["ft"]``, ``results["scan"]["online"]`` or the per-rank
    events in the trace.  Item 12b: two runs through one compile cache,
    the second a hit of the first's train-step record.  Item 14b: a dryrun
    cell of the smoke config on the host mesh."""
    full = [argv[0], "--arch", ARCH, "--smoke", "--device", "cpu", *argv[1:]]
    if item == "item 14b":
        res = cli.run([*full, "--shape", "decode_32k", "--host-mesh",
                       "--out", str(tmp_path)])
        (cell,) = res["cells"].values()
        assert cell["flops"] > 0 and cell["memory"]["peak_est_bytes"] > 0
        return
    if item == "item 12b":
        from repro_torch.kernels import _build

        full[full.index("cc")] = str(tmp_path / "cc")
        stats = []
        try:
            for _ in range(2):
                res = cli.run([*full, "--steps", "2", "--seq-len", "32",
                               "--global-batch", "2"])
                stats.append(res["session"].compile_cache.stats.as_dict())
                assert [h["step"] for h in res["history"]] == [1, 2]
        finally:
            _build.use_cache(None)
        assert stats == [{"hits": 0, "misses": 1, "puts": 1, "errors": 0},
                         {"hits": 1, "misses": 0, "puts": 0, "errors": 0}]
        return
    res = cli.run([*full, "--steps", "2", "--seq-len", "32", "--global-batch", "2"])
    results = res["session"].results
    assert [h["step"] for h in res["history"]] == [1, 2]
    if "--modules" in argv:
        assert results["ft"]["restarts"] == 0 and results["ft"]["timeline"] == []
    elif argv[1] == "--detect-online":
        assert results["scan"]["online"] == {"passes": 0, "first_detect_step": None,
                                             "slow_ranks": [], "degraded_links": []}
    else:
        ranks = {e.rank for e in res["session"].tracer.events if e.name == "fwd"}
        assert ranks == {0, 1}


@pytest.mark.parametrize("argv", [
    ["train", "--pp", "2", "--set", "parallel.dp=2"],
    ["train", "--pp", "2", "--set", "parallel.tp=2"],
    ["train", "--multi-pod"],
], ids=lambda v: "-".join(v))
def test_item_8b_argv_train_or_name_the_missing_ranks(argv):
    """What item 8b refused runs now: the composed plans train in their
    spawned ranks and report ``results["parallel"]``; ``--multi-pod`` asks
    for the 2 x 16 x 16 mesh, which a one-rank world cannot hold."""
    argv = [argv[0], "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
            "--set", "train.seq_len=32", "--set", "train.global_batch=8",
            "--modules", "none", *argv[1:]]
    if "--multi-pod" in argv:
        with pytest.raises(SystemExit, match=re.escape(
                "needs 512 ranks, the world has 1")):
            cli.main(argv)
        return
    par = cli.run(argv)["session"].results["parallel"]
    assert par["pp"] == 2 and par["world"] == 4 == len(par["ranks"])
    assert par["backend"] == "gloo"


@pytest.mark.parametrize("argv,want", [
    (["--replicas", "2", "--router-policy", "jsq", "--prefill-replicas", "1"],
     dict(replicas=2, policy="jsq", traffic="poisson")),
    (["--traffic", "bursty"], dict(replicas=1, policy="", traffic="bursty")),
], ids=lambda v: "-".join(v) if isinstance(v, list) else "")
def test_routed_and_bursty_serving_run(argv, want, capsys):
    """MegaRoute (two replicas, one of them prefill-only, behind jsq) and
    bursty traffic on one engine, which earlier slices refused, run to the
    end through the CLI: every request finishes and ``serve_config``
    reports the fleet and the traffic, as JAX's CLI prints them."""
    out = cli.run(["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                   "--continuous", "--requests", "6", "--rate", "300",
                   "--slots", "3", "--max-new", "6", "--prompt-lens", "16,40",
                   *argv])
    printed = capsys.readouterr().out
    met, sc = out["metrics"], out["serve_config"]
    assert met["finished"] == 6 and len(out["streams"]) == 6
    assert {k: sc[k] for k in want} == want
    if want["replicas"] > 1:
        assert "replicas=2 policy=jsq" in printed
        # every request that did not end at its first token migrated to
        # the decode replica
        n_mig = sum(len(v) > 1 for v in out["streams"].values())
        assert met["migrations"] == n_mig > 0
        assert met["placed_per_replica"] == [6 - n_mig, n_mig]
        for key in ("shed_rate", "redirects", "load_skew"):
            assert re.search(rf"^  {key} ", printed, re.M), key
        events = out["session"].tracer.events
        assert {e.rank for e in events if e.kind != "counter"} == {0, 1, 2}
        assert sum(e.name == "route" for e in events) == 6
    else:
        assert "traffic=bursty" in printed and "load_skew" not in printed


@pytest.mark.parametrize("argv,paths", [
    (["serve", "--continuous", "--modules", "scope",
      "--set", "scope.probes=final_hidden:stats"], ("gathered", "dense")),
    (["serve"], None),
    (["serve", "--continuous", "--spec-decode"], ("paged", "flash")),
    (["serve", "--continuous", "--spec-decode", "--drafter", "random"],
     ("paged", "flash")),
    (["serve", "--continuous", "--chunked-prefill"], ("paged", "flash")),
    (["serve", "--continuous", "--decode-path", "gathered"], ("gathered", "dense")),
], ids=lambda v: "-".join(v) if isinstance(v, list) else str(v))
def test_single_engine_serve_paths_run(argv, paths, capsys):
    """The serving paths earlier slices refused run to the end: every
    request finishes, the chosen decode and prefill paths are reported, and
    static serving emits ``max_new`` tokens a prompt."""
    out = cli.run([argv[0], "--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "5", "--rate", "400", "--slots", "3",
                   "--max-new", "6", "--prompt-lens", "16,40", "--batch", "2",
                   "--prompt-len", "24", *argv[1:]])
    printed = capsys.readouterr().out
    if paths is None:
        assert "static" in printed
        assert [len(g) for g in out["outputs"]] == [6, 6]
        assert [len(p) for p in out["prompts"]] == [24, 24]
        return
    assert out["metrics"]["finished"] == 5
    assert f"decode_path={paths[0]} prefill_path={paths[1]}" in printed
    res = out["session"].results
    assert (res["decode_path"], res["prefill_path"]) == paths
    if "--spec-decode" in argv:
        assert out["metrics"]["spec_proposed"] > 0
    if "scope" in argv:
        items = [it for s in res["stream_items"].values() for it in s]
        assert items and all("final_hidden.stats" in it.captures["top"]
                             for it in items)
        assert res["scope"]["captured"]["top/final_hidden.stats/mean"] == len(items)
