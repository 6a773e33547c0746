"""tinyllama-1.1b [dense] — llama2-architecture small model [arXiv:2401.02385].

22L, d_model=2048, 32 heads, GQA kv=4, d_ff=5632, vocab=32000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000,
    attention="gqa", rope_theta=1e4, decode_window=8192,
    act="silu", optimizer="adamw",
    citation="arXiv:2401.02385",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512)


register(CONFIG, reduced)
