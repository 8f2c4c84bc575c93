"""MC log-likelihood tests: single-token exactness, stratified-count
semantics, convergence stability."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import tiny_llada_config
from lavida_mod.generation.log_likelihood import _mc_round, get_log_likelihood
from lavida_mod.models import llada as jl


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jnp.arange(5, 13)[None]
    prefix = jl.embed_tokens(params, prompt)
    return cfg, params, prefix


def test_single_token_is_exact(tiny):
    """Ta=1: every MC sample masks the one token with p_mask=1, so the
    estimate equals log softmax(logits)[answer] exactly."""
    cfg, params, prefix = tiny
    answer = jnp.array([42])
    ll = get_log_likelihood(params, cfg, prefix, answer, mc_num=4,
                            batch_size=2)

    mask_embed = jl.embed_tokens(params, jnp.array([[cfg.mask_token_id]]))
    embeds = jnp.concatenate([prefix, mask_embed], axis=1)
    logits, _ = jl.forward(params, cfg, embeds)
    expect = float(jax.nn.log_softmax(logits[0, -1].astype(jnp.float32))[42])
    np.testing.assert_allclose(ll, expect, atol=1e-4)


def test_mc_round_finite_and_negative_ll(tiny):
    cfg, params, prefix = tiny
    answer = jnp.asarray(np.random.default_rng(0).integers(3, 400, size=12))
    ll = get_log_likelihood(params, cfg, prefix, answer, mc_num=16,
                            batch_size=8)
    assert np.isfinite(ll) and ll < 0.0


def test_estimates_are_stable_across_seeds(tiny):
    """Two independent 64-sample estimates of the same pair should agree to
    within MC noise (loose band; catches weighting/masking bugs which move
    the value by O(1))."""
    cfg, params, prefix = tiny
    answer = jnp.asarray(np.random.default_rng(1).integers(3, 400, size=6))
    a = get_log_likelihood(params, cfg, prefix, answer, mc_num=64,
                           batch_size=16, key=jax.random.PRNGKey(1))
    b = get_log_likelihood(params, cfg, prefix, answer, mc_num=64,
                           batch_size=16, key=jax.random.PRNGKey(2))
    assert abs(a - b) / abs(a) < 0.25, (a, b)


def test_ranking_prefers_trained_continuation(tiny):
    """The estimator must rank a continuation the model assigns high
    probability above a random one.  Construct it directly: pick the
    argmax tokens under full masking as the 'good' answer."""
    cfg, params, prefix = tiny
    Ta = 4
    mask_embed = jl.embed_tokens(
        params, jnp.full((1, Ta), cfg.mask_token_id)
    )
    embeds = jnp.concatenate([prefix, mask_embed], axis=1)
    logits, _ = jl.forward(params, cfg, embeds)
    good = jnp.argmax(logits[0, -Ta:], axis=-1)
    bad = (good + 97) % cfg.vocab_size
    ll_good = get_log_likelihood(params, cfg, prefix, good, mc_num=32,
                                 batch_size=16)
    ll_bad = get_log_likelihood(params, cfg, prefix, bad, mc_num=32,
                                batch_size=16)
    assert ll_good > ll_bad, (ll_good, ll_bad)


# ---------------------------------------------------------------------------
# Quantized serving layouts (what `eval --quant int4/mixed` actually ships):
# adapter.py passes the converted tree into get_log_likelihood, so the MC
# estimator must be correct over the int8 tree (mixed rides it — a full
# non-causal forward is prefill-shaped) and the fused-int4 decode tree.
# ---------------------------------------------------------------------------


def _quant_cfg():
    from lavida_mod.config import LLaDAConfig

    # a sequential-block (fused layout) geometry for the int4/int8 trees
    return LLaDAConfig(
        d_model=512, n_heads=4, n_layers=2, mlp_hidden_size=1024,
        block_type="sequential", activation="swiglu",
        vocab_size=512, embedding_size=512, mask_token_id=3,
        max_sequence_length=256, rope_theta=10000.0,
    )


def test_loglikelihood_int8_layout_matches_bf16():
    """Same key -> same MC masks: the only difference is forward numerics,
    so the int8 estimate must track the bf16 one closely."""
    cfg = _quant_cfg()
    params = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    prompt = jnp.arange(5, 21)[None]
    prefix = jl.embed_tokens(params, prompt)
    answer = jnp.asarray(np.random.default_rng(0).integers(5, 500, size=12))

    ll_bf16 = get_log_likelihood(params, cfg, prefix, answer, mc_num=8,
                                 batch_size=4, key=jax.random.PRNGKey(7))
    q8 = jl.quantize_params(jl.unstack_blocks(params), bits=8)
    prefix8 = jl.embed_tokens(q8, prompt)
    ll_int8 = get_log_likelihood(q8, cfg, prefix8, answer, mc_num=8,
                                 batch_size=4, key=jax.random.PRNGKey(7))
    assert np.isfinite(ll_int8)
    assert abs(ll_int8 - ll_bf16) / abs(ll_bf16) < 0.05, (ll_int8, ll_bf16)


def test_mc_round_forward_chunking_is_exact(tiny):
    """Row-chunked forward (forward_chunk < b) must match the whole-batch
    forward bit-for-bit in f32 tolerance: rows are attention-independent,
    chunking only bounds the live activation set (the OOM fix for MMMU
    geometry over the fused-int4 layout)."""
    from lavida_mod.generation.log_likelihood import _mc_round

    cfg, params, prefix = tiny
    answer = jnp.asarray(np.random.default_rng(1).integers(5, 500, size=8))
    key = jax.random.PRNGKey(3)
    whole = _mc_round(params, cfg, prefix, answer, key, 4,
                      forward_chunk=4)
    chunked = _mc_round(params, cfg, prefix, answer, key, 4,
                        forward_chunk=2)
    np.testing.assert_allclose(float(whole), float(chunked), rtol=2e-6)


def test_loglikelihood_act_int8_knob_tracks_weight_only():
    """The opt-in W8A8 knob (act_int8=True, the int8-GEMM prefill
    linears) must track the weight-only int8 estimate within the
    documented ~0.5% activation-quant band — same key, same masks."""
    cfg = _quant_cfg()
    params = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    prompt = jnp.arange(5, 21)[None]
    q8 = jl.quantize_params(jl.unstack_blocks(params), bits=8)
    prefix8 = jl.embed_tokens(q8, prompt)
    answer = jnp.asarray(np.random.default_rng(0).integers(5, 500, size=12))

    ll_w = get_log_likelihood(q8, cfg, prefix8, answer, mc_num=8,
                              batch_size=4, key=jax.random.PRNGKey(7))
    ll_a8 = get_log_likelihood(q8, cfg, prefix8, answer, mc_num=8,
                               batch_size=4, key=jax.random.PRNGKey(7),
                               act_int8=True)
    assert np.isfinite(ll_a8)
    assert abs(ll_a8 - ll_w) / abs(ll_w) < 0.05, (ll_a8, ll_w)


def test_loglikelihood_fused_int4_self_consistent():
    """Ta=1 exactness against the fused-int4 model's OWN forward: the
    estimator must be internally exact over the serving layout (quant noise
    cancels — both sides run the same kernels).  Starts from llama-block
    params because to_fused_layout converts llama -> fused-sequential —
    exactly the 8B serving sequence (`eval --quant int4/mixed`)."""
    from lavida_mod.config import LLaDAConfig

    cfg = LLaDAConfig(
        d_model=512, n_heads=4, n_layers=2, mlp_hidden_size=1024,
        block_type="llama", activation="silu",
        vocab_size=512, embedding_size=512, mask_token_id=3,
        max_sequence_length=256, rope_theta=10000.0,
    )
    params = jl.init_params(cfg, jax.random.PRNGKey(1), jnp.bfloat16)
    lp, fcfg = jl.to_fused_layout(jl.unstack_blocks(params), cfg)
    q4 = jl.quantize_params(lp, bits=4)

    prompt = jnp.arange(5, 21)[None]
    prefix = jl.embed_tokens(q4, prompt)
    answer = jnp.array([42])
    ll = get_log_likelihood(q4, fcfg, prefix, answer, mc_num=4,
                            batch_size=2)

    mask_embed = jl.embed_tokens(q4, jnp.array([[fcfg.mask_token_id]]))
    embeds = jnp.concatenate([prefix, mask_embed], axis=1)
    logits, _ = jl.forward(q4, fcfg, embeds)
    expect = float(jax.nn.log_softmax(logits[0, -1].astype(jnp.float32))[42])
    # the estimator pads/batches (mc_num,T) while the oracle runs (1,T):
    # the int4 matmul kernel tiles the two shapes differently, so the
    # accumulation order differs — ~1e-3 relative drift is kernel noise,
    # not estimator error (bf16 Ta=1 exactness is tested at 1e-5 above)
    np.testing.assert_allclose(ll, expect, rtol=5e-3)

    # longer answers: finite and rank-sane through the fused layout
    ans = jnp.asarray(np.random.default_rng(2).integers(5, 500, size=10))
    ll_long = get_log_likelihood(q4, fcfg, prefix, ans, mc_num=8,
                                 batch_size=4)
    assert np.isfinite(ll_long) and ll_long < 0.0


def test_adapter_loglikelihood_uses_prefill_tree_when_mixed():
    """Mixed serving: loglikelihood is compute-bound (mc_num full
    forwards), so the adapter must ride the int8 prefill tree, not the
    int4 decode tree (adapter.py loglikelihood)."""
    from lavida_mod.eval import adapter as adapter_mod

    class FakeModel:
        lm_family = "llada"
        prefill_params = {"tag": "int8-prefill"}
        params = {"llada": {"tag": "int4-decode"}}

    seen = {}

    def fake_get_ll(lm, cfg, prefix, ans, mc_num, act_int8=False):
        seen["lm"] = lm
        seen["act_int8"] = act_int8
        return -1.0

    orig = adapter_mod.get_log_likelihood
    adapter_mod.get_log_likelihood = fake_get_ll
    try:
        a = adapter_mod.LavidaEvalModel.__new__(adapter_mod.LavidaEvalModel)
        a.model = FakeModel()
        a.mc_num = 4
        a.loglik_act_int8 = False
        a.tokenizer = type("T", (), {"__call__": lambda s, t: type(
            "R", (), {"input_ids": [1, 2]})()})()
        a._build_inputs = lambda text, images: (None, None, None, type(
            "M", (), {"encode_prompt": lambda s, *a: None})())
        a.model.cfg = type("C", (), {"llada": None})()
        FakeModel.cfg = a.model.cfg
        a.loglikelihood("q", [], "ans")
    finally:
        adapter_mod.get_log_likelihood = orig
    assert seen["lm"] == {"tag": "int8-prefill"}
    assert seen["act_int8"] is False  # W8A8 stays opt-in (quality dial)
