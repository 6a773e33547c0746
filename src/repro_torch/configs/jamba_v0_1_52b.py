"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE
[arXiv:2403.19887].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536,
MoE 16 experts top-2 on every other layer; attention on layer i when
i % 8 == 4 (1 attention : 7 mamba); mamba d_state=16, conv=4, expand=2.
long_500k is native: mamba state is constant-size and the single attention
layer per block uses a sliding-window KV cache.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    attention="gqa", decode_window=8192,
    attn_layer_period=8, attn_layer_offset=4,
    ssm_kind="mamba", ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=14336,
    moe_layer_period=2, moe_layer_offset=1,
    act="silu", optimizer="adamw",
    citation="arXiv:2403.19887",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, n_experts=4, top_k=2, moe_d_ff=512,
        attn_layer_period=2, attn_layer_offset=1, ssm_state_dim=8)


register(CONFIG, reduced)
