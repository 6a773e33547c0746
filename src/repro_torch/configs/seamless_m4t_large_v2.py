"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal [arXiv:2308.11596].

Assigned spec: 24L, d_model=1024, 16 heads (kv=16), d_ff=8192, vocab=256206.
Interpreted as the model card's 24 encoder + 24 decoder layers (text decoder
with cross-attention).  The speech frontend (mel-spectrogram + conformer
feature extractor) is a STUB: input_specs() supplies frame embeddings
(B, n_frames, d_model) as encoder input; decode shapes lower the decoder with
the encoder memory precomputed.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    attention="gqa", rope_theta=1e4, decode_window=8192,
    is_encoder_decoder=True, n_encoder_layers=24,
    modality="audio", num_prefix_embeddings=1024,   # encoder frames (default)
    act="gelu", optimizer="adamw",
    citation="arXiv:2308.11596",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab_size=512, num_prefix_embeddings=32)


register(CONFIG, reduced)
