"""Dream: Qwen2-style bidirectional diffusion LM.

The reference implements Dream as a separate 954-line model file
(llava/model/language_model/dream/modeling_dream.py); structurally it is the
same computation our LLaDA core already expresses — llama-layout blocks
(separate q/k/v with bias, o_proj without, SwiGLU gate/up/down, RMSNorm,
half-rotation RoPE, non-causal SDPA, GQA) — so this build reuses
models/llada.forward with a Dream-geometry config and a name-mapping weight
converter.  The prefix-LM cache (DreamPrefixLMCache, modeling_dream.py:
660-692: write-once prefix, concat on read) is exactly our rotated-key KV
cache semantics.

Differences live in the *sampler* (generation/dream_sampler.py): AR-shifted
logits, prefill-argmax first token, maskgit/topk_margin/entropy confidence.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import jax.numpy as jnp

from ..config import LLaDAConfig

# token ids: configuration_dream.py:49-50, conversation stop 151643
DREAM_MASK_ID = 151666
DREAM_PAD_ID = 151643
DREAM_EOS_ID = 151643


def dream_7b_config(**kw) -> LLaDAConfig:
    """Dream-v0-7B (Qwen2.5-7B geometry)."""
    base = dict(
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        n_layers=28,
        mlp_hidden_size=18944,
        block_type="llama",
        activation="silu",
        rope=True,
        rope_theta=1000000.0,
        layer_norm_type="rms",
        rms_norm_eps=1e-6,
        include_qkv_bias=True,
        vocab_size=151936,
        embedding_size=151936,
        weight_tying=False,
        max_sequence_length=4096,
        mask_token_id=DREAM_MASK_ID,
        eos_token_id=DREAM_EOS_ID,
        pad_token_id=DREAM_PAD_ID,
    )
    base.update(kw)
    return LLaDAConfig(**base)


def tiny_dream_config(**kw) -> LLaDAConfig:
    base = dict(
        d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        mlp_hidden_size=128, rope_theta=10000.0, rms_norm_eps=1e-6,
        include_qkv_bias=True, vocab_size=512, embedding_size=512,
        weight_tying=False, max_sequence_length=512,
        block_type="llama", layer_norm_type="rms",
        mask_token_id=500, eos_token_id=501, pad_token_id=501,
    )
    base.update(kw)
    return LLaDAConfig(**base)


# reference HF names (modeling_dream.py) -> our llada-layout names
_LINEAR_MAP = {
    "self_attn.q_proj": "q_proj",
    "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj",
    "self_attn.o_proj": "attn_out",
    "mlp.gate_proj": "ff_proj",
    "mlp.up_proj": "up_proj",
    "mlp.down_proj": "ff_out",
}
_NORM_MAP = {
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "ff_norm",
}


def convert_dream_state_dict(
    state: Mapping[str, np.ndarray],
    cfg: LLaDAConfig,
    dtype=jnp.bfloat16,
    prefix: str = "model.",
) -> dict:
    """torch Dream state_dict -> llada-layout params pytree (stacked)."""
    def get(name: str) -> np.ndarray:
        for cand in (prefix + name, name, "model." + name):
            if cand in state:
                return np.asarray(state[cand])
        raise KeyError(f"missing dream weight: {prefix + name}")

    def has(name: str) -> bool:
        return any(
            c in state for c in (prefix + name, name, "model." + name)
        )

    L = cfg.n_layers
    blocks: dict = {}
    for src, dst in _LINEAR_MAP.items():
        ws = [get(f"layers.{i}.{src}.weight").T for i in range(L)]
        blocks[dst] = {"kernel": jnp.asarray(np.stack(ws), dtype)}
        if has(f"layers.0.{src}.bias"):
            bs = [get(f"layers.{i}.{src}.bias") for i in range(L)]
            blocks[dst]["bias"] = jnp.asarray(np.stack(bs), dtype)
    for src, dst in _NORM_MAP.items():
        ws = [get(f"layers.{i}.{src}.weight") for i in range(L)]
        blocks[dst] = {"weight": jnp.asarray(np.stack(ws), dtype)}

    params = {
        "wte": jnp.asarray(get("embed_tokens.weight"), dtype),
        "ln_f": {"weight": jnp.asarray(get("norm.weight"), dtype)},
        "blocks": blocks,
    }
    # separate lm head (modeling_dream.py DreamModel.lm_head)
    for cand in ("lm_head.weight",):
        if cand in state:
            params["ff_out"] = {
                "kernel": jnp.asarray(np.asarray(state[cand]).T, dtype)
            }
            break
    else:
        raise KeyError("missing dream weight: lm_head.weight")
    return params
