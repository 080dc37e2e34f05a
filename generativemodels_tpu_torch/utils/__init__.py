from .component_store import ComponentStore
from .enums import (
    AdversarialIterationEvents,
    AdversarialKeys,
    OrderingTransformations,
    OrderingType,
    StrEnum,
)
from .misc import unsqueeze_left, unsqueeze_right
from .ordering import Ordering
from .profiling import StepTimer

__all__ = [
    "AdversarialIterationEvents", "AdversarialKeys", "ComponentStore", "Ordering",
    "OrderingTransformations", "OrderingType", "StepTimer", "StrEnum", "unsqueeze_left",
    "unsqueeze_right",
]
