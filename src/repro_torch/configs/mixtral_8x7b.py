"""Mixtral-8x7B [arXiv:2401.04088; hf]: 8 experts top-2, SWA."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("mixtral-8x7b")
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=0,  # every FFN is MoE
        vocab_size=32000,
        n_experts=8,
        top_k=2,
        moe_d_ff=14336,
        sliding_window=4096,
        activation="silu",
        rope_theta=1_000_000.0,
        source="[arXiv:2401.04088; hf]",
    )
