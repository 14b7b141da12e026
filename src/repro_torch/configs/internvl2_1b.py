"""InternVL2-1B [arXiv:2404.16821; hf]: LLM backbone only; the InternViT
frontend is a STUB (input_specs provides precomputed patch embeddings,
256 tokens prepended to the text stream)."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("internvl2-1b")
def internvl2_1b() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        qkv_bias=True,
        n_vision_tokens=256,
        activation="silu",
        rope_theta=1_000_000.0,
        source="[arXiv:2404.16821; hf]",
    )
