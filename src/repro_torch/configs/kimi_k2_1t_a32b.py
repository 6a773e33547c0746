"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE [arXiv:2501.kimi2].

61L, d_model=7168, 64 heads (GQA kv=8 per the assignment table), per-expert
d_ff=2048, vocab=163840, 384 routed experts top-8 + 1 shared, first layer
dense.  Trains with Adafactor: fp32 Adam moments for 1T params would need
~16 GB/chip on the 512-chip mesh.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432,                     # dense (first) layer FFN
    vocab_size=163840,
    attention="gqa", head_dim=112, rope_theta=5e4, decode_window=8192,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    moe_layer_period=1, first_dense_layers=1,
    act="silu", optimizer="adafactor",
    citation="arXiv:2501.kimi2",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
        n_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=128,
        first_dense_layers=1)


register(CONFIG, reduced)
