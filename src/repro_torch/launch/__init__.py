"""Launch layer of the port: the streaming quantile service
(``quantile_service.QuantileService``, its slot table, tick ring, warm
exact queries, windows and snapshots), the ``StreamingCalibrator`` kept on
it, its threaded ingest (``ingest_pool.IngestPool``), the serving
entry point (``serve``: ``generate`` and the int8 calibrations), the
training loop (``train``, its step in ``steps``), the roofline terms
under the H100's rates and the collective parsers (``roofline``), and the
dry-run tooling: the production meshes over ``torch.distributed``'s
DeviceMesh and the fake process group (``mesh``), the sharding rules as
DTensor placements (``sharding``), each cell's step and abstract inputs
(``steps.input_specs``), the per-rank step analyzer (``step_analysis``)
and the CLI that traces every (arch x shape x mesh) cell (``dryrun``)."""
from .quantile_service import (QuantileService, RWLock, StreamingCalibrator,
                               Window, ingest_dispatches,
                               record_ingest_dispatch,
                               reset_ingest_dispatches)
from .ingest_pool import IngestPool, default_ingest_workers

# loaded on first use: ``python -m repro_torch.launch.serve`` runs a module
# not yet imported, and the dry-run's modules pull in torch.distributed
_LAZY = {
    "serve": ("calibrate_int8_scale", "calibrate_int8_scales", "generate"),
    "mesh": ("fake_world", "make_production_mesh", "make_mesh",
             "batch_axes"),
    "sharding": ("param_spec", "param_shardings", "opt_shardings",
                 "batch_spec", "cache_shardings", "placements",
                 "distribute_params"),
    "steps": ("input_specs",),
    "step_analysis": ("analyze",),
}

__all__ = ["QuantileService", "RWLock", "StreamingCalibrator", "Window",
           "ingest_dispatches", "record_ingest_dispatch",
           "reset_ingest_dispatches", "IngestPool", "default_ingest_workers",
           *(name for names in _LAZY.values() for name in names)]


def __getattr__(name):
    import importlib
    for module, names in _LAZY.items():
        if name in names:
            return getattr(importlib.import_module(f".{module}", __name__),
                           name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
