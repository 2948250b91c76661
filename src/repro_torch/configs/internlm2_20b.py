"""internlm2-20b [arXiv:2403.17297]: 48 layers, d_model 6144, 48 heads (GQA,
8 kv heads) of 128, d_ff 16,384, vocab 92,544, bfloat16; about 1.99e10
parameters (40 GB)."""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="internlm2-20b",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab=92544,
        param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="internlm2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=4,
        d_head=8,
        d_ff=128,
        vocab=128,
        param_dtype=torch.float32,
    )
