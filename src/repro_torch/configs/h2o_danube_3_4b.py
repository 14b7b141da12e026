"""H2O-Danube3-4B [arXiv:2401.16818; unverified]: llama+mistral mix, SWA."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("h2o-danube-3-4b")
def h2o_danube_3_4b() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        head_dim=120,
        sliding_window=4096,  # mistral-style SWA -> sub-quadratic
        activation="silu",
        rope_theta=10_000.0,
        source="[arXiv:2401.16818; unverified]",
    )
