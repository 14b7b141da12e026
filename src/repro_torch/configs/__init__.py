"""Architecture registry: import the config modules to populate it."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeSpec,
    cell_applicable,
    get_arch,
    list_archs,
    pad_to,
    reduced,
)
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    ds_paper_100m,
    granite_34b,
    h2o_danube_3_4b,
    internvl2_1b,
    mamba2_1p3b,
    mixtral_8x7b,
    nemotron_4_340b,
    qwen2_72b,
    whisper_tiny,
    zamba2_1p2b,
)
