"""Synthetic road frames and the scenario families with analytic ground
truth (numpy; the same frames as ``repro.data`` from the same seeds)."""

from .images import RoadScene, frame_stream, synthetic_road  # noqa: F401
from .scenarios import (  # noqa: F401
    ScenarioFamily,
    get_family,
    make_scenario,
    scenario_batch,
    scenario_names,
    scenario_stream,
    segment_rho_theta,
)
