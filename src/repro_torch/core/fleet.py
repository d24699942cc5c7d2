"""One frozen bundle for the engines' fleet options (``repro.core.fleet``
ported; pure Python, as the reference).

``FleetConfig`` carries ``comms``, ``hetero``, ``async_cfg``, ``faults``,
``guards``, ``live_mask``, ``topology`` and ``stream`` as one value, taken
as ``fleet=`` by ``EdgeEngine.run_rounds_fused``, ``run_events_fused`` /
``EdgeEngine.run_async``, ``run_federated_rounds`` and ``run_experiment``.
The per-feature options keep working through ``resolve_fleet``: each
driver builds a ``FleetConfig`` from whichever form the caller used,
warning when both are mixed (the legacy values win, field by field).  The
``SCENARIOS`` registry's presets return ``FleetConfig`` s, so a scenario
and a hand-built ``fleet=`` take the same code path.

A ``FleetConfig`` validates nothing but its field names; each driver
names the fields it supports (``allowed=``), so the cross-engine rules
(no ``stream`` on the round-synchronous engine, no ``live_mask`` on the
event loop) live in one place.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

#: every bundled option, in the reference's order: the legacy-option shim
#: and the drivers' ``allowed`` subsets read it
FLEET_FIELDS = ("comms", "hetero", "async_cfg", "faults", "guards",
                "live_mask", "topology", "stream")


@dataclass(frozen=True)
class FleetConfig:
    """Everything that shapes a fleet's dynamics, in one value: ``comms``
    (``core.comms.CommsConfig``), ``hetero`` (``core.hetero.HeteroConfig``),
    ``async_cfg`` (``core.async_engine.AsyncConfig``), ``faults`` /
    ``guards`` (``core.faults.FaultConfig`` / ``GuardConfig``),
    ``live_mask`` (a ``[rounds, D]`` host liveness schedule, round engine
    only), ``topology`` (``core.topology.FogTopology``) and ``stream``
    (``core.stream.StreamConfig``, async engine only).  Every field
    defaults to None (off); frozen, so presets share instances safely."""

    comms: Optional[Any] = None
    hetero: Optional[Any] = None
    async_cfg: Optional[Any] = None
    faults: Optional[Any] = None
    guards: Optional[Any] = None
    live_mask: Optional[Any] = None
    topology: Optional[Any] = None
    stream: Optional[Any] = None

    def set_fields(self) -> Tuple[str, ...]:
        """Names of the options that are on."""
        return tuple(f for f in FLEET_FIELDS
                     if getattr(self, f) is not None)

    def merged(self, **overrides) -> "FleetConfig":
        """A copy with the given non-None fields replaced (how
        ``run_experiment`` layers the caller's options over a scenario's)."""
        live = {k: v for k, v in overrides.items() if v is not None}
        return replace(self, **live) if live else self


def resolve_fleet(fleet: Optional[FleetConfig], context: str,
                  allowed: Tuple[str, ...] = FLEET_FIELDS,
                  **legacy) -> FleetConfig:
    """The ``FleetConfig`` of a call from its ``fleet=`` bundle and its
    per-feature options (``legacy``, by field name).

    ``fleet=None`` builds one from the options, so a call with options
    only equals the bundled call.  Both forms at once warn, and the
    options that are set win field by field.  A set field outside
    ``allowed`` raises ``ValueError`` naming the driver ``context``."""
    unknown = sorted(set(legacy) - set(FLEET_FIELDS))
    if unknown:
        raise ValueError(f"{context}: unknown fleet knob(s) {unknown}; "
                         f"valid: {list(FLEET_FIELDS)}")
    live = {k: v for k, v in legacy.items() if v is not None}
    if fleet is None:
        fleet = FleetConfig(**live)
    elif live:
        warnings.warn(
            f"{context}: both fleet= and legacy kwarg(s) {sorted(live)} "
            f"were passed; the legacy values take precedence — migrate "
            f"them into the FleetConfig", stacklevel=3)
        fleet = replace(fleet, **live)
    bad = sorted(set(fleet.set_fields()) - set(allowed))
    if bad:
        raise ValueError(
            f"{context} does not support fleet field(s) {bad}; "
            f"supported here: {sorted(allowed)}")
    return fleet
