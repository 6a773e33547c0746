"""codeqwen1.5-7b [dense] — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads (MHA kv=32), d_ff=13440, vocab=92416.
Qwen1.5 uses qkv biases.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    attention="gqa", qkv_bias=True, rope_theta=1e6, decode_window=8192,
    act="silu", optimizer="adamw",
    citation="hf:Qwen/CodeQwen1.5-7B",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512)


register(CONFIG, reduced)
