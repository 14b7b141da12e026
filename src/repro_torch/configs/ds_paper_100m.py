"""The examples' ~100M-parameter LM (the model the serving examples,
bench and tests build)."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("ds-paper-100m")
def ds_paper_100m() -> ArchConfig:
    return ArchConfig(
        name="ds-paper-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=32768,
        activation="silu",
        source="[examples; synthetic]",
    )
