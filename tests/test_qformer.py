"""Q-Former resampler parity vs the reference's vendored BLIP-2 BERT
(llava/model/multimodal_resampler/qformer.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.models.qformer import (
    QformerConfig, apply, convert_qformer_state_dict, init_params,
)


@pytest.fixture(scope="module")
def torch_qformer(reference_llava):
    import sys

    import torch
    import torch.nn as nn

    # modern transformers moved these helpers to pytorch_utils; shim them
    # back so the vendored (older-API) module imports
    import transformers.modeling_utils as mu
    import transformers.pytorch_utils as pu

    for name in ("apply_chunking_to_forward",
                 "find_pruneable_heads_and_indices", "prune_linear_layer"):
        if not hasattr(mu, name):
            setattr(mu, name, getattr(pu, name))
    sys.path.insert(0, str(reference_llava / "llava" / "model"
                           / "multimodal_resampler"))
    from qformer import BertConfig, BertLMHeadModel

    cfg = BertConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    cfg.encoder_width = 24
    cfg.add_cross_attention = True
    cfg.cross_attention_freq = 2
    cfg.query_length = 8
    torch.manual_seed(0)
    qf = BertLMHeadModel(config=cfg)
    qf.cls = None
    qf.bert.embeddings.word_embeddings = None
    qf.bert.embeddings.position_embeddings = None
    for layer in qf.bert.encoder.layer:
        layer.output = None
        layer.intermediate = None
    query_tokens = nn.Parameter(torch.zeros(1, 8, 32))
    query_tokens.data.normal_(mean=0.0, std=0.02)
    ln_vision = nn.LayerNorm(24)
    with torch.no_grad():
        ln_vision.weight.uniform_(0.5, 1.5)
        ln_vision.bias.uniform_(-0.1, 0.1)
    return qf.eval(), query_tokens, ln_vision


def test_qformer_parity(torch_qformer):
    import torch

    qf, query_tokens, ln_vision = torch_qformer
    cfg = QformerConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=64, encoder_width=24, num_query_tokens=8,
        cross_attention_freq=2,
    )
    state = {f"Qformer.{k}": v.numpy() for k, v in qf.state_dict().items()}
    state["query_tokens"] = query_tokens.detach().numpy()
    state.update({f"ln_vision.{k}": v.numpy()
                  for k, v in ln_vision.state_dict().items()})
    params = convert_qformer_state_dict(state, cfg)

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 10, 24)).astype(np.float32)
    with torch.no_grad():
        x = ln_vision(torch.from_numpy(feats))
        atts = torch.ones(x.size()[:-1], dtype=torch.long)
        qt = query_tokens.expand(x.shape[0], -1, -1)
        ref = qf.bert(
            query_embeds=qt, encoder_hidden_states=x,
            encoder_attention_mask=atts, return_dict=True,
        ).last_hidden_state.numpy()
    ours = np.asarray(apply(params, cfg, jnp.asarray(feats)))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_qformer_random_init_runs_and_grads():
    cfg = QformerConfig(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        encoder_width=16, num_query_tokens=4)
    params = init_params(cfg, jax.random.PRNGKey(0))
    feats = jnp.asarray(
        np.random.default_rng(1).standard_normal((1, 6, 16)),
        jnp.float32,
    )
    out = apply(params, cfg, feats)
    assert out.shape == (1, 4, 32)
    g = jax.grad(
        lambda p: jnp.sum(apply(p, cfg, feats) ** 2)
    )(params)
    assert float(jnp.abs(g["query_tokens"]).sum()) > 0
    assert float(jnp.abs(g["layers"][0]["cross"]["k"]["kernel"]).sum()) > 0
