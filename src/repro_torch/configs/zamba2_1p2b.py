"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + one shared
attention block (width 2*d_model) invoked every 6 layers with
per-invocation LoRA."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("zamba2-1.2b")
def zamba2_1p2b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_headdim=64,
        ssm_chunk=128,
        shared_attn_every=6,
        shared_attn_lora_rank=128,
        activation="gelu_gated",
        source="[arXiv:2411.15242; hf]",
    )
