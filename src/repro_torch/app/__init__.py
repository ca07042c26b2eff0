"""`repro_torch.app` — the Session API and the CLI, counterpart of
``repro.app``: :class:`~repro_torch.app.config.RunConfig` (typed, layered
run configuration), :class:`~repro_torch.app.session.Session` (device,
module plugins, the shared trace export), the
:class:`~repro_torch.app.plugins.ModulePlugin` protocol and
``python -m repro_torch {train,serve,trace}`` (:mod:`repro_torch.app.cli`).
"""

from repro_torch.app.config import (
    WORKLOADS,
    RunConfig,
    apply_dict,
    apply_sets,
    build_run_config,
    parse_modules,
    set_by_path,
)
from repro_torch.app.plugins import (
    PLUGIN_REGISTRY,
    DppPlugin,
    FbdPlugin,
    FtPlugin,
    MetricsPlugin,
    ModulePlugin,
    ScanPlugin,
    ScopePlugin,
    build_plugins,
    register_plugin,
)
from repro_torch.app.session import Session

__all__ = [
    "PLUGIN_REGISTRY",
    "RunConfig",
    "Session",
    "WORKLOADS",
    "ModulePlugin",
    "ScanPlugin",
    "MetricsPlugin",
    "FtPlugin",
    "ScopePlugin",
    "FbdPlugin",
    "DppPlugin",
    "apply_dict",
    "apply_sets",
    "build_plugins",
    "build_run_config",
    "parse_modules",
    "register_plugin",
    "set_by_path",
]
