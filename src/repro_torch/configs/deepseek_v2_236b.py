"""DeepSeek-V2-236B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + 160 routed
experts top-6 + 2 shared experts; first layer dense."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("deepseek-v2-236b")
def deepseek_v2_236b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # the dense first layer's FFN
        vocab_size=102400,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        first_k_dense=1,
        activation="silu",
        source="[arXiv:2405.04434; hf]",
    )
