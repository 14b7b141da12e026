"""Qwen2-72B [arXiv:2407.10671; hf]: dense GQA with QKV bias."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("qwen2-72b")
def qwen2_72b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        activation="silu",
        rope_theta=1_000_000.0,
        source="[arXiv:2407.10671; hf]",
    )
