"""qwen3-0.6b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family].

28L, d_model=1024, 16 heads (GQA kv=8), d_ff=3072, vocab=151936,
head_dim=128 (decoupled from d_model/n_heads), per-head RMS qk-norm.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936,
    attention="gqa", head_dim=128, qk_norm=True, rope_theta=1e6,
    decode_window=8192, tie_embeddings=True,
    act="silu", optimizer="adamw",
    citation="hf:Qwen/Qwen3-8B",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512)


register(CONFIG, reduced)
