from .checkpoint import CheckpointManager
from .component_store import ComponentStore
from .enums import (
    AdversarialIterationEvents,
    AdversarialKeys,
    OrderingTransformations,
    OrderingType,
    StrEnum,
)
from .guards import GuardState, guard_nans, init_guard
from .logging import MetricsLogger
from .misc import unsqueeze_left, unsqueeze_right
from .ordering import Ordering
from .export import ExportedFunction, export_fn, load_exported, load_fn, save_exported
from .profiling import StepTimer, annotate, trace

__all__ = [
    "AdversarialIterationEvents", "AdversarialKeys", "CheckpointManager", "ComponentStore",
    "ExportedFunction", "GuardState", "MetricsLogger", "Ordering", "OrderingTransformations", "OrderingType",
    "StepTimer", "StrEnum", "annotate", "export_fn", "guard_nans", "init_guard", "load_exported",
    "load_fn", "save_exported", "trace", "unsqueeze_left", "unsqueeze_right",
]
