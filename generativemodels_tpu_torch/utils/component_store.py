"""Named component registry used for extensible noise schedules.

Counterpart of generativemodels_tpu/utils/component_store.py, with the same
public surface: add / add_def / __getitem__ / __getattr__ / __contains__ /
__len__ / __iter__ / __str__.
"""
from __future__ import annotations

import keyword
from typing import Any, Callable, Iterator, NamedTuple, TypeVar

T = TypeVar("T")


class _Entry(NamedTuple):
    description: str
    value: Any


def _is_identifier(name: str) -> bool:
    return name.isidentifier() and not keyword.iskeyword(name)


class ComponentStore:
    """A name -> (description, value) registry.

    Components (typically functions) are registered under valid Python
    identifiers and retrieved by attribute or item access::

        NoiseSchedules = ComponentStore("NoiseSchedules", "beta schedules")

        @NoiseSchedules.add_def("my_schedule", "my custom schedule")
        def _my_schedule(num_train_timesteps, beta_start=1e-4, beta_end=2e-2):
            return torch.linspace(beta_start, beta_end, num_train_timesteps)
    """

    def __init__(self, name: str, description: str) -> None:
        self.components: dict[str, _Entry] = {}
        self.name = name
        self.description = description

    def add(self, name: str, desc: str, value: T) -> T:
        if not _is_identifier(name):
            raise ValueError("Name of component must be valid Python identifier")
        self.components[name] = _Entry(desc, value)
        return value

    def add_def(self, name: str, desc: str) -> Callable[[Callable], Callable]:
        def deco(func: Callable) -> Callable:
            return self.add(name, desc, func)

        return deco

    def __contains__(self, name: str) -> bool:
        return name in self.components

    def __len__(self) -> int:
        return len(self.components)

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        for k, entry in self.components.items():
            yield k, entry.value

    def __str__(self) -> str:
        lines = [f"Component store '{self.name}': {self.description}"]
        for k, entry in self.components.items():
            lines.append(f"* {k}: {entry.description}")
        return "\n".join(lines)

    def __getattr__(self, name: str) -> Any:
        components = self.__dict__.get("components", {})
        if name in components:
            return components[name].value
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        if name in self.components:
            return self.components[name].value
        raise ValueError(f"Component '{name}' not found")
