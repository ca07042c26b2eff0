"""Rank-side tasks of ``tests/test_torch_ft_world.py``: each runs on every
rank of a ``_torch_parallel_tasks.Pool`` world and imports only the port."""

from repro_torch.app.cli import parse
from repro_torch.app.session import Session
from repro_torch.ft import GradCompressor
from repro_torch.launch.mesh import make_pipeline_mesh
from repro_torch.parallel.plan import ParallelPlan, resolve_plan
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step


def session_run(argv: list[str], model_cfg) -> dict:
    """``python -m repro_torch`` as a rank of this world runs it (the world
    is joined, so the Session runs in place): this rank's history, its
    ``ft`` and ``scan`` reports and its coordinates."""
    _, rc = parse(argv)
    session = Session(rc, model_cfg=model_cfg)
    _, history = session.run()
    res = session.results
    return {"history": history, "ft": res.get("ft"), "scan": res.get("scan"),
            "coords": res["parallel"]["coords"],
            "series": res.get("metrics", {}).get("series", {})}


def compression_refusals(cfg) -> list[str]:
    """The messages of a compressed step at tp 2 and at pp 2 x dp 1."""
    out = []
    for kw in (dict(tp=2), dict(pp=2, n_micro=2)):
        plan = resolve_plan(ParallelPlan(**kw))
        mesh = make_pipeline_mesh(plan.pp, plan.dp, plan.tp)
        try:
            make_train_step(cfg, optim.OptimizerConfig(), plan=plan, mesh=mesh,
                            compressor=GradCompressor())
        except (NotImplementedError, ValueError) as e:
            out.append(f"{type(e).__name__}: {e}")
        else:
            out.append("built")
    return out
