"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

24L, d_model=2048, attention-free (RWKV6 time-mix, head size 64 -> 32 heads),
channel-mix d_ff=7168, vocab=65536.  Constant-size recurrent state makes
long_500k decode native (no KV cache at all).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    attention="none", ssm_kind="rwkv6", ssm_head_dim=64,
    act="relu2",                     # RWKV channel-mix uses squared ReLU
    optimizer="adamw",
    citation="arXiv:2404.05892",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        ssm_head_dim=32)


register(CONFIG, reduced)
