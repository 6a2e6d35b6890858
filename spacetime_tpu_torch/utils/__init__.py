"""Device selection and phase timing."""

from .device import resolve_device
from .profiling import PhaseTimer

__all__ = ["resolve_device", "PhaseTimer"]
