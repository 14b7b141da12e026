"""Nemotron-4-340B [arXiv:2402.16819; unverified]: dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch("nemotron-4-340b")
def nemotron_4_340b() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        activation="relu2",  # squared ReLU, ungated
        rope_theta=10_000.0,
        source="[arXiv:2402.16819; unverified]",
    )
