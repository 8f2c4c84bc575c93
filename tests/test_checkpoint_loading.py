"""On-disk checkpoint round-trips for the reference's three load modes
(builder.py:62-170): full shards, base + mm_projector.bin overlay, and
base + LoRA merge.  Everything goes through actual files in tmp_path —
the converters were already oracle-tested in memory; these tests cover
the file boundary (sharding, dtype, torch-bin vs safetensors naming)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import (LaViDaConfig, VisionConfig,
                               tiny_llada_config, tiny_siglip_config)
from lavida_mod.models import multimodal
from lavida_mod.models.lavida import (LaViDa, convert_lavida_state_dict,
                                      merge_lora_state)

from test_llada_parity import _make_ref_model  # tiny torch LLaDA fixture


def _tiny_cfg():
    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
            grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        ),
    )


@pytest.fixture(scope="module")
def ref_state(reference_llada, reference_llava):
    """A reference-named composed state dict (numpy) for the tiny config:
    model.transformer.* + model.vision_tower.vision_tower.vision_model.*
    + model.mm_projector.* + model.image_newline."""
    from llava.model.multimodal_encoder.siglip_base import (
        SigLipVisionConfig, SigLipVisionTransformer,
    )

    lm, _ = _make_ref_model(reference_llada)
    state = {f"model.{k}": v.detach().float().numpy()
             for k, v in lm.state_dict().items()}

    vcfg = SigLipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14)
    torch.manual_seed(1)
    vt = SigLipVisionTransformer(vcfg)
    for p in vt.parameters():
        torch.nn.init.normal_(p, std=0.02)
    state.update({
        f"model.vision_tower.vision_tower.vision_model.{k}":
            v.detach().float().numpy()
        for k, v in vt.state_dict().items()})

    torch.manual_seed(2)
    proj = torch.nn.Sequential(
        torch.nn.Linear(32, 64), torch.nn.GELU(), torch.nn.Linear(64, 64))
    state.update({f"model.mm_projector.{k}": v.detach().float().numpy()
                  for k, v in proj.state_dict().items()})
    state["model.image_newline"] = (
        np.random.default_rng(3).standard_normal(64).astype(np.float32))
    return state


def _logits_of(model: LaViDa) -> np.ndarray:
    """Forward a tiny multimodal prompt through the loaded params."""
    from lavida_mod.models import llada as L

    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.standard_normal((1, 3, 56, 56)), jnp.float32)
    feats = multimodal.encode_image(model.params, model.cfg, pix, (56, 56))
    ids = np.array([5, 6, -200, 7, 8, 9])
    emb, _ = multimodal.splice_embeddings(model.params, model.cfg, ids,
                                          [feats])
    logits, _ = L.forward(model.params["llada"], model.cfg.llada,
                          emb[None])
    return np.asarray(logits)


def _expected_params(ref_state, cfg):
    return convert_lavida_state_dict(ref_state, cfg, dtype=jnp.float32)


def _save_safetensor_shards(state, path, n_shards=2):
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    keys = sorted(state)
    per = -(-len(keys) // n_shards)
    for i in range(n_shards):
        shard = {k: state[k] for k in keys[i * per:(i + 1) * per]}
        save_file(shard, os.path.join(
            path, f"model-{i+1:05d}-of-{n_shards:05d}.safetensors"))


def test_full_load_safetensors_shards(ref_state, tmp_path):
    cfg = _tiny_cfg()
    _save_safetensor_shards(ref_state, tmp_path / "full", n_shards=2)
    model = LaViDa.load(str(tmp_path / "full"), cfg, dtype=jnp.float32)
    ref = LaViDa(cfg, _expected_params(ref_state, cfg))
    np.testing.assert_allclose(_logits_of(model), _logits_of(ref),
                               atol=1e-5, rtol=1e-5)


def test_full_load_torch_bin(ref_state, tmp_path):
    cfg = _tiny_cfg()
    d = tmp_path / "bin"
    os.makedirs(d)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                ref_state.items()}, d / "pytorch_model.bin")
    model = LaViDa.load(str(d), cfg, dtype=jnp.float32)
    ref = LaViDa(cfg, _expected_params(ref_state, cfg))
    np.testing.assert_allclose(_logits_of(model), _logits_of(ref),
                               atol=1e-5, rtol=1e-5)


def test_projector_overlay_load(ref_state, tmp_path):
    """base + mm_projector.bin (builder.py:160-165): base checkpoint has
    a stale projector; the overlay's projector must win."""
    cfg = _tiny_cfg()
    stale = dict(ref_state)
    for k in list(stale):
        if k.startswith("model.mm_projector."):
            stale[k] = np.zeros_like(stale[k])
    _save_safetensor_shards(stale, tmp_path / "base")
    d = tmp_path / "proj"
    os.makedirs(d)
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in ref_state.items()
                if k.startswith("model.mm_projector.")},
               d / "mm_projector.bin")
    model = LaViDa.load(str(d), cfg, dtype=jnp.float32,
                        base=str(tmp_path / "base"))
    ref = LaViDa(cfg, _expected_params(ref_state, cfg))
    np.testing.assert_allclose(_logits_of(model), _logits_of(ref),
                               atol=1e-5, rtol=1e-5)


def test_lora_merge_load(ref_state, tmp_path):
    """base + peft adapter (builder.py:102-121): LoRA pairs merged into
    q_proj/ff_out, non_lora_trainables supplying the projector."""
    from safetensors.numpy import save_file

    cfg = _tiny_cfg()
    stale = dict(ref_state)
    for k in list(stale):
        if k.startswith("model.mm_projector."):
            stale[k] = np.zeros_like(stale[k])
    _save_safetensor_shards(stale, tmp_path / "base")

    rng = np.random.default_rng(7)
    r, alpha = 4, 8
    adapter = {}
    targets = ["model.transformer.blocks.0.q_proj",
               "model.transformer.blocks.1.ff_out"]
    for t in targets:
        w = ref_state[t + ".weight"]
        adapter[f"base_model.model.{t}.lora_A.weight"] = (
            rng.standard_normal((r, w.shape[1])).astype(np.float32) * 0.1)
        adapter[f"base_model.model.{t}.lora_B.weight"] = (
            rng.standard_normal((w.shape[0], r)).astype(np.float32) * 0.1)

    d = tmp_path / "lora"
    os.makedirs(d)
    save_file(adapter, d / "adapter_model.safetensors")
    with open(d / "adapter_config.json", "w") as f:
        json.dump({"r": r, "lora_alpha": alpha,
                   "target_modules": ["q_proj", "ff_out"]}, f)
    torch.save(
        {f"base_model.model.{k}": torch.from_numpy(np.asarray(v))
         for k, v in ref_state.items()
         if k.startswith("model.mm_projector.")},
        d / "non_lora_trainables.bin")

    model = LaViDa.load(str(d), cfg, dtype=jnp.float32,
                        base=str(tmp_path / "base"))

    # expectation: dense merge done by hand on the full state dict
    merged = merge_lora_state(dict(ref_state), adapter, alpha / r)
    ref = LaViDa(cfg, _expected_params(merged, cfg))
    np.testing.assert_allclose(_logits_of(model), _logits_of(ref),
                               atol=1e-5, rtol=1e-5)
    # and the merge moved the weights (the test bites)
    plain = LaViDa(cfg, _expected_params(ref_state, cfg))
    assert np.abs(_logits_of(model) - _logits_of(plain)).max() > 1e-3


def test_load_then_int4_fused_serving_layout(ref_state, tmp_path):
    """The predict/worker/eval --int4 sequence on a LOADED checkpoint:
    unstack -> to_fused_layout (token-exact) -> quantize_params(bits=4)
    -> generate.  Covers the CLI serving path end-to-end from real
    files (the fused cfg must replace the model's)."""
    from lavida_mod.config import GenerationConfig
    from lavida_mod.models import llada as jl

    cfg = _tiny_cfg()
    _save_safetensor_shards(ref_state, tmp_path / "q4", n_shards=2)
    model = LaViDa.load(str(tmp_path / "q4"), cfg, dtype=jnp.float32)

    lp = jl.unstack_blocks(model.params["llada"])
    lp, lcfg = jl.to_fused_layout(lp, model.cfg.llada)
    model.cfg = model.cfg.replace(llada=lcfg)
    model.params["llada"] = jl.quantize_params(lp, bits=4, group=64)

    gen = GenerationConfig(max_new_tokens=8, block_length=8,
                           prefix_lm=True)
    out = model.generate(np.arange(5, 13), gen=gen)
    assert out.shape[-1] == 8
    assert (np.asarray(out) != model.cfg.llada.mask_token_id).all()


def test_load_then_mixed_serving_layout(ref_state, tmp_path):
    """The eval/worker `--quant mixed` sequence on a LOADED checkpoint:
    unstack -> to_fused_layout -> int8 prefill tree (quantized BEFORE the
    consuming int4 pass frees the bf16 kernels) -> consuming int4 decode
    tree -> generate with the mixed split (eval/__main__.py --quant
    mixed, worker.py --mixed).  The consume ordering is the part a unit
    test of quantize_params alone cannot catch."""
    from lavida_mod.config import GenerationConfig
    from lavida_mod.models import llada as jl

    cfg = _tiny_cfg()
    _save_safetensor_shards(ref_state, tmp_path / "mx", n_shards=2)
    model = LaViDa.load(str(tmp_path / "mx"), cfg, dtype=jnp.float32)

    lp = jl.unstack_blocks(model.params["llada"])
    lp, lcfg = jl.to_fused_layout(lp, model.cfg.llada)
    model.cfg = model.cfg.replace(llada=lcfg)
    model.prefill_params = jl.quantize_params(lp, bits=8)
    model.params["llada"] = jl.quantize_params(
        lp, bits=4, group=64, consume=True)

    # consume=True must have freed the full-precision linear kernels out
    # of the source blocks — the ordering the CLIs rely on (prefill int8
    # quantized BEFORE the consuming pass; embeddings/norms stay)
    assert not any(
        hasattr(x, "ndim") and x.ndim == 2
        and x.dtype in (jnp.float32, jnp.bfloat16)
        for x in jax.tree.leaves(lp["blocks"]))

    gen = GenerationConfig(max_new_tokens=8, block_length=8,
                           prefix_lm=True)
    out = model.generate(np.arange(5, 13), gen=gen)
    assert out.shape[-1] == 8
    assert (np.asarray(out) != model.cfg.llada.mask_token_id).all()


def test_host_staging_load_matches_direct(ref_state, tmp_path):
    """load(host_staging=True) converts onto the CPU backend (the 8B
    serving path: the bf16 tree stays off the device until quantized);
    .to_device() then ships the params.
    Must be numerically identical to the direct load, and every leaf
    must land on the default device afterwards."""
    import jax

    cfg = _tiny_cfg()
    _save_safetensor_shards(ref_state, tmp_path / "hs", n_shards=2)
    staged = LaViDa.load(str(tmp_path / "hs"), cfg, dtype=jnp.float32,
                         host_staging=True)
    cpu = jax.devices("cpu")[0]
    assert all(list(x.devices()) == [cpu]
               for x in jax.tree.leaves(staged.params))
    # leaves must be COMMITTED to cpu — uncommitted arrays would migrate
    # to the default accelerator at the first downstream op (the fuse
    # concats), shipping the full-precision tree to the device
    assert all(getattr(x, "committed", getattr(x, "_committed", True))
               for x in jax.tree.leaves(staged.params))
    staged.to_device()
    dev = jax.devices()[0]
    assert all(list(x.devices()) == [dev]
               for x in jax.tree.leaves(staged.params))
    direct = LaViDa.load(str(tmp_path / "hs"), cfg, dtype=jnp.float32)
    np.testing.assert_allclose(_logits_of(staged), _logits_of(direct),
                               atol=1e-5, rtol=1e-5)
