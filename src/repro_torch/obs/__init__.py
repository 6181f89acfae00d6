"""Observability for the port's DES: the process-wide metrics registry
(``metrics``), copied from ``repro.obs``.  Trace export and the run ledger
are not ported yet (ROADMAP 1.16)."""
from . import metrics  # noqa: F401

__all__ = ["metrics"]
