"""The paper's own application as a config: line detection pipelines.

The paper's platform matrix (Table 7) as execution variants of the same
detector, with the reference's names (``repro/configs/paper_lines.py``):

    from repro_torch.configs.paper_lines import PLATFORMS
    det = LineDetector(PLATFORMS["boom+gemmini"])
"""

from repro_torch.core import CannyConfig, PipelineConfig

PLATFORMS = {
    # Rocket 50MHz baseline: scalar stencils
    "rocket": PipelineConfig(canny=CannyConfig(impl="stencil")),
    # BOOM: same program on a better core (the conv kernel)
    "boom": PipelineConfig(canny=CannyConfig()),
    # +Gemmini (the paper's Workload 3): conv-as-GEMM offload, int pipeline
    "rocket+gemmini": PipelineConfig(canny=CannyConfig(integer=True)),
    "boom+gemmini": PipelineConfig(canny=CannyConfig(integer=True)),
    # beyond-paper: fused 7x7 single-pass masks
    "tpu-fused": PipelineConfig(canny=CannyConfig(fused=True)),
}

# The paper's frame geometry (Fig. 4-scale) and deployment target.
FRAME_HW = (240, 320)
DEPLOY_HW = (720, 1280)
REALTIME_BUDGET_S = 0.300     # paper: 300 ms/frame -> ~4 m at 50 km/h
