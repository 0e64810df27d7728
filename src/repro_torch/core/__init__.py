"""The paper's line detector in PyTorch: Canny (conv kernel) -> Hough vote
(vote kernel) -> get-lines-coordinates, with the paper's float->int rewrite
and phase profiling; the fused hot path (fused_detect kernel -> vote
kernel); the temporal layer, lane tracking with prediction-gated and
corridor-filtered detection; and the consumer it serves, bird's-eye
geometry and a pure-pursuit lateral controller."""

from .canny import (  # noqa: F401
    GAUSS_5x5, SOBEL_X, SOBEL_Y, CannyConfig, canny, estimate_edge_count,
    estimate_edge_count_device,
)
from .hough import (  # noqa: F401
    CORRIDOR_INF, HoughConfig, auto_max_edges, full_corridors, fused_hough,
    fused_hough_tiered, hough_transform, hough_transform_tiered,
    max_edge_tiers, resolve_max_edges, rho_bins,
)
from .lines import (  # noqa: F401
    LinesConfig, get_lines, peak_segments, render_lines,
)
from .plan import (  # noqa: F401
    DetectionPlan, PlanCache, batch_bucket, load_frame, resolve_static,
)
from .metrics import (  # noqa: F401
    DetectionScore, aggregate_scores, match_peaks, score_batch, score_frame,
)
from .geometry import (  # noqa: F401
    DEFAULT_CAMERA, CameraConfig, CameraGeometry, canonical_rho_theta,
)
from .control import (  # noqa: F401
    ControlConfig, LateralController, SteeringCommand, Waypoints,
    extract_waypoints, ground_boundaries,
)
from .pipeline import DetectionResult, LineDetector, PipelineConfig  # noqa: F401
from .profiling import PhaseProfiler, StageCost, line_detection_costs  # noqa: F401
from .quantize import (  # noqa: F401
    Quantized, dequantize, quantize, quantize_frames, quantize_weights_int8,
    quantized_matmul,
)
from .tracking import (  # noqa: F401
    LaneTracker, Track, TrackedFrame, TrackerConfig, TrackingPipeline,
    merge_peaks, signed_residual, tracks_as_peaks, wrap_canonical,
)
