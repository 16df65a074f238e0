"""Launch layer of the port: the streaming quantile service
(``quantile_service.QuantileService``), its slot table, tick ring, warm
exact queries, windows and snapshots."""
from .quantile_service import (QuantileService, RWLock, Window,
                               ingest_dispatches, record_ingest_dispatch,
                               reset_ingest_dispatches)

__all__ = ["QuantileService", "RWLock", "Window", "ingest_dispatches",
           "record_ingest_dispatch", "reset_ingest_dispatches"]
