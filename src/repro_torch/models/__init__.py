"""Model substrate: layers and the dense decoder's paged serving path."""
from repro_torch.models.transformer import Model, ModelRuntime  # noqa: F401
