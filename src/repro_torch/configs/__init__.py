"""Architecture registry: import the config modules to populate it."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    get_arch,
    pad_to,
    reduced,
)
from repro_torch.configs import ds_paper_100m, mamba2_1p3b  # noqa: F401
