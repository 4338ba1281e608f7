"""DEPRECATED alias of :mod:`repro_torch.core.fabric` (a copy of
``repro.core.fabricspec``, DESIGN.md §10).

The fabric spec historically lived here, apart from the rest of the
switch model, leaving two import surfaces for one subsystem.  The spec
now lives IN ``repro_torch.core.fabric``, and this module only forwards, emitting a :class:`DeprecationWarning` per attribute
access.  Migrate::

    from repro_torch.core.fabricspec import FabricSpec      # deprecated
    from repro_torch.core.fabric import FabricSpec          # canonical
"""
from __future__ import annotations

import warnings

from repro_torch.core import fabric as _fabric

_NAMES = (
    "CROSSBAR_OCS", "OCS_ARRAY", "PATCH_PANEL", "PACKET", "TECHNOLOGIES",
    "StaticFabricError", "CrossSubSwitchError",
    "SwitchBackend", "CrossbarOCS", "OCSArray", "PatchPanel", "PacketSwitch",
    "NATURAL_BACKEND", "MODE_BACKENDS", "DEFAULT_PART", "FabricSpec",
)


def __getattr__(name: str):
    if name in _NAMES:
        warnings.warn(
            f"repro_torch.core.fabricspec is deprecated; import {name} from "
            "repro_torch.core.fabric",
            DeprecationWarning, stacklevel=2)
        return getattr(_fabric, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(_NAMES)
