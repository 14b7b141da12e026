"""Whisper-tiny [arXiv:2212.04356; unverified]: enc-dec; conv/audio frontend
is a STUB (input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("whisper-tiny")
def whisper_tiny() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",  # plain GELU MLP (not gated)
        norm="layernorm",
        is_encoder_decoder=True,
        n_encoder_layers=4,
        encoder_seq=1500,
        max_position_embeddings=32768,  # learned positions, sized for decode_32k
        tie_embeddings=True,
        source="[arXiv:2212.04356; unverified]",
    )
