"""Granite-34B-Code [arXiv:2405.04324; hf]: llama-style dense, MQA (kv=1)."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("granite-34b")
def granite_34b() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,  # MQA
        d_ff=24576,
        vocab_size=49152,
        # ungated GELU matches the published 34B total (gpt_bigcode-style
        # MLP); a gated MLP would give 47B.
        activation="gelu",
        rope_theta=10_000.0,
        source="[arXiv:2405.04324; hf]",
    )
