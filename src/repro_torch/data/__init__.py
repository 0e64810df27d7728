"""Synthetic road frames, the scenario families with analytic ground truth,
and the drive cycles (numpy; the same frames as ``repro.data`` from the same
seeds)."""

from .images import RoadScene, frame_stream, synthetic_road  # noqa: F401
from .scenarios import (  # noqa: F401
    NOISY_FAMILIES,
    DriveCycle,
    DriveCycleFrame,
    ScenarioFamily,
    get_family,
    make_drive_cycle,
    make_scenario,
    scenario_batch,
    scenario_names,
    scenario_stream,
    segment_rho_theta,
    standard_drive_cycle,
    transform_rho_theta,
)
