from .component_store import ComponentStore
from .enums import StrEnum
from .misc import unsqueeze_left, unsqueeze_right
from .profiling import StepTimer

__all__ = ["ComponentStore", "StepTimer", "StrEnum", "unsqueeze_left", "unsqueeze_right"]
