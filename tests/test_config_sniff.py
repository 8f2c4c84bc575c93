"""config.json sniffing — the analogue of the reference builder's
AutoConfig.from_pretrained step (builder.py:128-146): a checkpoint dir's
config.json determines geometry + lm family, so users load any-geometry
checkpoints without hand-building a LaViDaConfig.

Field layouts covered:
  - llada: flat OLMo-style ModelConfig fields serialized by the HF
    LLaDAConfig wrapper (configuration_llada.py:398-414);
  - dream: Qwen2-style fields (dream/configuration_dream.py:28-86);
  - LLaVA composition fields written onto the composed config by the
    trainer (llava_arch.py:42-110) incl. the stringified
    image_grid_pinpoints form mm_utils accepts.
"""

import json

import pytest

from lavida_mod.config import (LaViDaConfig, config_from_checkpoint,
                               tiny_llada_config)


def _write(tmp_path, cj):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cj, f)
    return str(tmp_path)


LLADA_TINY_CJ = {
    "model_type": "llava_llada",
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "n_layers": 2,
    "mlp_hidden_size": 128, "block_type": "llama",
    "activation_type": "silu", "rope": True, "rope_theta": 10000.0,
    "layer_norm_type": "rms", "rms_norm_eps": 1e-5,
    "vocab_size": 512, "embedding_size": 512, "weight_tying": False,
    "max_sequence_length": 512, "mask_token_id": 500,
    "eos_token_id": 501, "pad_token_id": 501,
}


def test_llada_flat_fields(tmp_path):
    cfg, fam = config_from_checkpoint(_write(tmp_path, LLADA_TINY_CJ))
    assert fam == "llada"
    assert cfg.llada == tiny_llada_config()


def test_llada_8b_defaults_survive_sparse_config(tmp_path):
    """A config.json carrying only a few fields keeps our 8B defaults for
    the rest (the HF wrapper serializes everything, but partial configs
    from hand-edits must not zero out geometry)."""
    cfg, fam = config_from_checkpoint(
        _write(tmp_path, {"model_type": "llava_llada", "n_layers": 16}))
    assert fam == "llada"
    assert cfg.llada.n_layers == 16
    assert cfg.llada.d_model == LaViDaConfig().llada.d_model
    assert cfg.llada.mask_token_id == 126336


def test_dream_qwen2_fields(tmp_path):
    cj = {
        "model_type": "Dream",
        "hidden_size": 3584, "num_attention_heads": 28,
        "num_key_value_heads": 4, "num_hidden_layers": 28,
        "intermediate_size": 18944, "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6, "vocab_size": 151936,
        "max_position_embeddings": 32768, "tie_word_embeddings": False,
        "mask_token_id": 151666, "pad_token_id": 151643,
        "eos_token_id": 151643,
    }
    cfg, fam = config_from_checkpoint(_write(tmp_path, cj))
    assert fam == "dream"
    c = cfg.llada
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.n_layers) == (
        3584, 28, 4, 28)
    assert c.mlp_hidden_size == 18944
    assert c.include_qkv_bias  # qwen2 geometry default (dream_7b_config)
    assert c.mask_token_id == 151666
    assert c.embedding_size == 151936
    assert c.max_sequence_length == 32768


def test_dream_detected_without_model_type(tmp_path):
    """Qwen2 field names alone (hidden_size + num_attention_heads, no
    d_model) identify a dream-family checkpoint."""
    _, fam = config_from_checkpoint(_write(tmp_path, {
        "hidden_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 2, "intermediate_size": 128,
        "vocab_size": 512}))
    assert fam == "dream"


def test_vision_fields_and_stringified_pinpoints(tmp_path):
    cj = dict(LLADA_TINY_CJ)
    cj.update({
        "mm_hidden_size": 32, "mm_projector_type": "mlp2x_gelu",
        "image_aspect_ratio": "square",
        "image_grid_pinpoints": "[[56, 112], [112, 56]]",
        "mm_patch_merge_type": "spatial_unpad",
        "mm_spatial_pool_mode": "average", "mm_spatial_pool_stride": 2,
        "vision_tower_config": {
            "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 3, "num_attention_heads": 4,
            "image_size": 56, "patch_size": 14},
        "tokenizer_model_max_length": 4096,
    })
    cfg, _ = config_from_checkpoint(_write(tmp_path, cj))
    v = cfg.vision
    assert v.mm_hidden_size == 32
    assert v.image_aspect_ratio == "square"
    assert v.grid_pinpoints == ((56, 112), (112, 56))
    assert v.spatial_pool_mode == "average"
    assert v.siglip.hidden_size == 32
    assert v.siglip.image_size == 56
    assert cfg.tokenizer_model_max_length == 4096


def test_no_config_json_returns_none(tmp_path):
    cfg, fam = config_from_checkpoint(str(tmp_path))
    assert cfg is None and fam is None


def test_load_sniffs_geometry(ref_state_ckpt):
    """LaViDa.load with cfg=None reads geometry from config.json and
    produces the same logits as an explicit tiny config."""
    import numpy as np

    from lavida_mod.models.lavida import LaViDa
    from test_checkpoint_loading import _logits_of, _tiny_cfg

    import jax.numpy as jnp

    path = ref_state_ckpt
    auto = LaViDa.load(path, dtype=jnp.float32)
    assert auto.lm_family == "llada"
    assert auto.cfg.llada == _tiny_cfg().llada
    explicit = LaViDa.load(path, _tiny_cfg(), dtype=jnp.float32)
    np.testing.assert_allclose(_logits_of(auto), _logits_of(explicit),
                               atol=0, rtol=0)


@pytest.fixture()
def ref_state_ckpt(tmp_path, reference_llada, reference_llava):
    """Tiny reference-named checkpoint dir WITH a full flat config.json."""
    from test_checkpoint_loading import _save_safetensor_shards, ref_state

    state = ref_state.__wrapped__(reference_llada, reference_llava)
    d = tmp_path / "ckpt"
    _save_safetensor_shards(state, d, n_shards=2)
    cj = dict(LLADA_TINY_CJ)
    cj.update({
        "mm_hidden_size": 32,
        "image_grid_pinpoints": [[56, 112], [112, 56], [112, 112]],
        "vision_tower_config": {
            "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 3, "num_attention_heads": 4,
            "image_size": 56, "patch_size": 14},
    })
    with open(d / "config.json", "w") as f:
        json.dump(cj, f)
    return str(d)
