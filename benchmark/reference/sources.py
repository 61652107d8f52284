"""The sources a configuration separates, whatever its network."""

from __future__ import annotations

from typing import Mapping, Tuple


def source_names(arch: Mapping) -> Tuple[str, ...]:
    """The separated sources of the configuration's task, in output order."""
    return {"voice": ("accompaniment", "vocals"),
            "multi_instrument": ("bass", "drums", "other", "vocals")}[
                arch["task"]]
