from .manager import cleanup, latest_step, restore, save

__all__ = ["cleanup", "latest_step", "restore", "save"]
