"""Enumerations shared across the port.

Counterpart of generativemodels_tpu/utils/enums.py; only what the
schedulers use is ported so far.
"""
from __future__ import annotations

from enum import Enum


class StrEnum(str, Enum):
    """String-valued enum whose members compare equal to their value."""

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return self.value
