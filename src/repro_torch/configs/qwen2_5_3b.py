"""qwen2.5-3b [hf:Qwen/Qwen2.5 family]: 36 layers, d_model 2048, 16 heads (GQA,
2 kv heads) of 128, d_ff 11008, vocab 151,936, QKV bias, bfloat16; about
3.4 B parameters (6.8 GB)."""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_head=128,
        d_ff=11008,
        vocab=151936,
        qkv_bias=True,
        param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        vocab=128,
        qkv_bias=True,
        param_dtype=torch.float32,
    )
