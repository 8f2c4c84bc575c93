"""models/reference.py: the plain f32 LLaDA forward that the on-card
serving checks compare against must equal models/llada.py's forward on
the same weights, in every layout it decodes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.models.reference import llada_logits


@pytest.mark.parametrize("layout", ["stacked", "unstacked", "fused",
                                    "int8", "int4", "gqa_bias_tied"])
def test_reference_matches_llada_forward(layout):
    kw = dict(d_model=128, n_heads=4, n_kv_heads=4, mlp_hidden_size=256,
              vocab_size=256, embedding_size=256, mask_token_id=250)
    if layout == "gqa_bias_tied":
        kw.update(n_kv_heads=2, include_qkv_bias=True, weight_tying=True)
    cfg = tiny_llada_config(**kw)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    if layout == "gqa_bias_tied":
        params["blocks"]["q_proj"]["bias"] = 0.1 * jnp.ones_like(
            params["blocks"]["q_proj"]["bias"])
    if layout != "stacked":
        params = jl.unstack_blocks(params)
    if layout == "fused":
        params, cfg = jl.to_fused_layout(params, cfg)
    if layout in ("int8", "int4"):
        params = jl.quantize_params(params, bits=int(layout[3:]), group=64)
    ids = jnp.asarray(np.arange(3, 40)[None])
    embeds = jl.embed_tokens(params, ids)
    with jax.default_matmul_precision("highest"):
        got, _ = jl.forward(params, cfg, embeds)
    ref = llada_logits(params, cfg, embeds)
    assert ref.shape == got.shape and ref.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
