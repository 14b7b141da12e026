"""Mamba2-1.3B [arXiv:2405.21060; unverified]: attention-free SSD."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("mamba2-1.3b")
def mamba2_1p3b() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=128,
        tie_embeddings=True,
        source="[arXiv:2405.21060; unverified]",
    )
