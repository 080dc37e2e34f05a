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
from .profiling import StepTimer

__all__ = [
    "AdversarialIterationEvents", "AdversarialKeys", "CheckpointManager", "ComponentStore",
    "GuardState", "MetricsLogger", "Ordering", "OrderingTransformations", "OrderingType",
    "StepTimer", "StrEnum", "guard_nans", "init_guard", "unsqueeze_left", "unsqueeze_right",
]
