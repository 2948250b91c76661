"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24 layers,
d_model 1024, 16 heads (GQA, 8 kv heads) of 64, MoE of 32 experts with d_ff
512 each, top-8, vocab 49,155, bfloat16; about 1.39 B parameters (2.8 GB),
about 0.48 B active a token."""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,
        vocab=49155,
        n_experts=32,
        moe_top_k=8,
        param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab=128,
        n_experts=4,
        moe_top_k=2,
        param_dtype=torch.float32,
    )
