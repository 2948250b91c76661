"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]: 48
layers, d_model 5120, 40 heads (GQA, 8 kv heads) of 128, MoE of 16 experts
with d_ff 8192 each, top-1, vocab 202,048, bfloat16; text tokens only (the
modality front end is a stub in the JAX package too). About 1.02e11
parameters (204 GB): more than one 80 GB card holds whole."""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202048,
        n_experts=16,
        moe_top_k=1,
        param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=64,
        vocab=256,
        n_experts=4,
        moe_top_k=1,
        param_dtype=torch.float32,
    )
