"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP-style patch prefix.

[hf:microsoft/Phi-3-vision-128k-instruct]: 32L, d_model=3072, 32 heads
(MHA, kv=32), d_ff=8192, vocab=32064.  The vision frontend (CLIP ViT-L/14 +
projector) is a STUB per instructions: input_specs() supplies projected patch
embeddings (B, num_prefix, d_model); the language transformer consumes them
as a prefix ahead of the text tokens.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    attention="gqa", rope_theta=1e4, decode_window=8192,
    modality="vision", num_prefix_embeddings=576,   # 24x24 CLIP patch grid
    act="silu", optimizer="adamw",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, num_prefix_embeddings=16)


register(CONFIG, reduced)
