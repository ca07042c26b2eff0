"""MegaFT, counterpart of ``repro.ft``: chaos injection, the mitigation
policy and controller, int8 gradient compression with error feedback, and
the checkpoint/restart supervisor.  The supervised train loop is
``repro_torch.train.loop.train`` given a :class:`FtController`."""

from repro_torch.ft.chaos import (
    ChaosInjector,
    ChaosSpec,
    InjectedCrash,
    parse_link,
    simulate_policy,
)
from repro_torch.ft.compress import GradCompressor
from repro_torch.ft.controller import FtController, FtOptions, PendingAction
from repro_torch.ft.failover import TrainSupervisor
from repro_torch.ft.mitigation import MitigationAction, MitigationPolicy

__all__ = [
    "ChaosInjector",
    "ChaosSpec",
    "FtController",
    "FtOptions",
    "GradCompressor",
    "InjectedCrash",
    "MitigationAction",
    "MitigationPolicy",
    "PendingAction",
    "TrainSupervisor",
    "parse_link",
    "simulate_policy",
]
