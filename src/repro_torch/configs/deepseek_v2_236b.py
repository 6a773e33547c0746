"""deepseek-v2-236b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

60L, d_model=5120, 128 heads, MLA kv_lora=512 (+64-dim decoupled rope),
per-expert d_ff=1536, vocab=102400, 160 routed experts top-6 + 2 shared,
first layer dense (d_ff=12288), q_lora=1536, v_head_dim=128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                      # the dense (first) layer's FFN
    vocab_size=102400,
    attention="mla", head_dim=128, v_head_dim=128,
    kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    decode_window=8192,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    moe_layer_period=1, first_dense_layers=1,
    act="silu", optimizer="adamw",
    citation="arXiv:2405.04434",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        head_dim=64, v_head_dim=64, kv_lora_rank=64, q_lora_rank=96,
        rope_head_dim=32, d_ff=512, vocab_size=512,
        n_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=128,
        first_dense_layers=1)


register(CONFIG, reduced)
