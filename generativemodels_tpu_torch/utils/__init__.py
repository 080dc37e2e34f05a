from .component_store import ComponentStore
from .enums import StrEnum
from .misc import unsqueeze_left, unsqueeze_right

__all__ = ["ComponentStore", "StrEnum", "unsqueeze_left", "unsqueeze_right"]
