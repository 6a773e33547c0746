"""minitron-4b [dense] — pruned Nemotron [arXiv:2407.14679].

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000.
Nemotron family: squared-ReLU MLP (non-gated), no qkv bias.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    attention="gqa", rope_theta=1e4, decode_window=8192,
    act="relu2", optimizer="adamw",
    citation="arXiv:2407.14679",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512)


register(CONFIG, reduced)
