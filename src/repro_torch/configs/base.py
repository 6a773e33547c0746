"""Architecture configuration schema + registry (a copy of the JAX package's
``configs/base.py``; pure Python).

One file per configuration the port can run lives next to this module; each
exports ``CONFIG`` (the published widths) and ``reduced()`` (the 2-layer,
narrow smoke-test variant of the same family).  ``get_config(name)`` /
``list_configs()`` are the lookup API of the ``--arch`` flag.  The registry
holds the reference's ten configurations: the dense GQA decoders, the vision
prefix model (phi-3-vision), the encoder-decoder (seamless-m4t), the
attention-free RWKV6 model (rwkv6), the Mamba / attention hybrid with MoE
FFNs (jamba), MLA with fine-grained MoE (deepseek-v2) and GQA at head dim
112 with MoE and Adafactor (kimi-k2).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ARCH_IDS = (
    "tinyllama-1.1b",
    "qwen3-0.6b",
    "codeqwen1.5-7b",
    "minitron-4b",
    "phi-3-vision-4.2b",
    "seamless-m4t-large-v2",
    "rwkv6-1.6b",
    "jamba-v0.1-52b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    attention: str = "gqa"          # gqa | mla | none
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0         # 0 = full attention (training/prefill)
    decode_window: int = 0          # >0: windowed KV cache for long_500k
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    moe_layer_period: int = 1       # layer i is MoE iff i % period == offset
    moe_layer_offset: int = 0
    first_dense_layers: int = 0     # leading dense layers (deepseek/kimi style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- hybrid / ssm ---
    attn_layer_period: int = 0      # jamba: attention 1-in-8
    attn_layer_offset: int = 0
    ssm_kind: str = ""              # rwkv6 | mamba
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64          # rwkv6 head size
    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # --- multimodal stub frontend ---
    modality: str = "text"          # text | vision | audio
    num_prefix_embeddings: int = 0  # patch/frame embeddings from the stub
    # --- misc ---
    act: str = "silu"               # silu (gated) | gelu (gated) | relu2 (mlp)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    citation: str = ""

    # ------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim if self.v_head_dim is not None else self.resolved_head_dim

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the mixer of decoder layer i."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.attn_layer_period > 0:
            return ("attn" if i % self.attn_layer_period == self.attn_layer_offset
                    else "ssm")
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        vhd = self.resolved_v_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attention == "mla":
                kv_in = self.q_lora_rank if self.q_lora_rank else d
                p = d * self.kv_lora_rank                      # kv down
                p += d * self.rope_head_dim                    # shared k_rope
                if self.q_lora_rank:
                    p += d * self.q_lora_rank
                p += kv_in * self.n_heads * (hd + self.rope_head_dim)  # q up
                p += self.kv_lora_rank * self.n_heads * (hd + vhd)     # kv up
                p += self.n_heads * vhd * d                    # out
                return p
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            gate = 3 if self.act in ("silu", "gelu") else 2
            return gate * d * ff

        def ssm_params() -> int:
            if self.ssm_kind == "rwkv6":
                # r,k,v,g,w projections + output + decay lora (approx.)
                return 6 * d * d + 2 * d * 64
            inner = d * self.ssm_expand
            return (2 * d * inner + inner * self.ssm_conv_dim
                    + inner * (2 * self.ssm_state_dim + 2)  # B,C,dt
                    + inner * self.ssm_state_dim + inner * d)

        for i in range(self.n_layers):
            total += attn_params() if self.layer_kind(i) == "attn" else ssm_params()
            if self.layer_is_moe(i):
                total += self.n_experts * mlp_params(self.moe_d_ff)
                total += self.n_shared_experts * mlp_params(self.moe_d_ff)
                total += d * self.n_experts                    # router
            else:
                total += mlp_params(self.d_ff)
            total += 2 * d                                     # norms
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += attn_params() + mlp_params(self.d_ff) + 2 * d
            total += self.n_layers * attn_params()             # cross-attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        gate = 3 if self.act in ("silu", "gelu") else 2
        per_expert = gate * d * self.moe_d_ff
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive


_REGISTRY = {}


def register(cfg: ModelConfig, reduced_fn) -> ModelConfig:
    _REGISTRY[cfg.name] = (cfg, reduced_fn)
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg, reduced_fn = _REGISTRY[name]
    return reduced_fn() if reduced else cfg


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    for arch in ARCH_IDS:
        importlib.import_module("repro_torch.configs."
                                + arch.replace("-", "_").replace(".", "_"))
    _LOADED = True
