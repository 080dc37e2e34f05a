from .component_store import ComponentStore
from .enums import AdversarialIterationEvents, AdversarialKeys, StrEnum
from .misc import unsqueeze_left, unsqueeze_right
from .profiling import StepTimer

__all__ = [
    "AdversarialIterationEvents", "AdversarialKeys", "ComponentStore", "StepTimer", "StrEnum",
    "unsqueeze_left", "unsqueeze_right",
]
