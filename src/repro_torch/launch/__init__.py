"""Launch layer of the port: the streaming quantile service
(``quantile_service.QuantileService``, its slot table, tick ring, warm
exact queries, windows and snapshots), the ``StreamingCalibrator`` kept on
it, its threaded ingest (``ingest_pool.IngestPool``), the serving
entry point (``serve``: ``generate`` and the int8 calibrations), the
training loop (``train``, its step in ``steps``) and the roofline terms
under the H100's rates (``roofline``)."""
from .quantile_service import (QuantileService, RWLock, StreamingCalibrator,
                               Window, ingest_dispatches,
                               record_ingest_dispatch,
                               reset_ingest_dispatches)
from .ingest_pool import IngestPool, default_ingest_workers

_SERVE = ("calibrate_int8_scale", "calibrate_int8_scales", "generate")

__all__ = ["QuantileService", "RWLock", "StreamingCalibrator", "Window",
           "ingest_dispatches", "record_ingest_dispatch",
           "reset_ingest_dispatches", "IngestPool", "default_ingest_workers",
           *_SERVE]


def __getattr__(name):
    # the serve functions load on first use, so that
    # ``python -m repro_torch.launch.serve`` runs a module not yet imported
    if name in _SERVE:
        from . import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
