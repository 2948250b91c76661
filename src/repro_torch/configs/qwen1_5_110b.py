"""qwen1.5-110b [hf:Qwen/Qwen1.5 family]: 80 layers, d_model 8192, 64 heads
(GQA, 8 kv heads) of 128, d_ff 49,152, vocab 152,064, QKV bias, bfloat16;
about 1.11e11 parameters (222 GB): more than one 80 GB card holds whole."""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-110b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=49152,
        vocab=152064,
        qkv_bias=True,
        param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-110b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=128,
        qkv_bias=True,
        param_dtype=torch.float32,
    )
