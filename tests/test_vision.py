"""Vision-stack tests: SigLIP logit parity vs the torch reference, pooling
semantics vs torch, anyres geometry vs reference mm_utils, merge shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import (
    LaViDaConfig, SigLIPConfig, VisionConfig, tiny_siglip_config,
)
from lavida_mod.data.anyres import (
    anyres_grid_shape, divide_to_patches, fit_within, select_best_resolution,
    unpad_slice,
)
from lavida_mod.models import siglip as js
from lavida_mod.models.siglip import convert_siglip_state_dict
from lavida_mod.ops.pooling import pool_2d

PINPOINTS = [(384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152)]


# ---------------------------------------------------------------------------
# SigLIP parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_siglip(reference_llava):
    from llava.model.multimodal_encoder.siglip_base import (
        SigLipVisionConfig, SigLipVisionTransformer,
    )

    cfg = SigLipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14,
    )
    torch.manual_seed(0)
    model = SigLipVisionTransformer(cfg)
    # random-init weights deterministically (reference _init_weights is a no-op)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    model.eval()
    return model


def test_siglip_parity(ref_siglip):
    cfg = tiny_siglip_config()  # 3 layers, drop_last -> 2 used
    state = {k: v.detach().numpy() for k, v in ref_siglip.state_dict().items()}
    params = convert_siglip_state_dict(
        state, cfg, dtype=jnp.float32, prefix=""
    )
    rng = np.random.default_rng(0)
    pix = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)

    # reference: run embeddings + first n_layers_used layers, raw hidden state
    with torch.no_grad():
        t = torch.from_numpy(pix)
        h = ref_siglip.embeddings(t)
        for layer in ref_siglip.encoder.layers[: cfg.n_layers_used]:
            h = layer(h, attention_mask=None)[0]
    ours = js.forward(params, cfg, jnp.asarray(pix))
    np.testing.assert_allclose(
        np.asarray(ours), h.numpy(), atol=2e-4, rtol=1e-3
    )


def test_siglip_pos_interp_runs(ref_siglip):
    cfg = tiny_siglip_config()
    state = {k: v.detach().numpy() for k, v in ref_siglip.state_dict().items()}
    params = convert_siglip_state_dict(state, cfg, dtype=jnp.float32, prefix="")
    pix = np.zeros((1, 3, 84, 84), np.float32)  # 6x6 grid != 4x4 trained
    out = js.forward(params, cfg, jnp.asarray(pix))
    assert out.shape == (1, 36, 32)


# ---------------------------------------------------------------------------
# Pooling parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["average", "max", "bilinear"])
def test_pool_2d_matches_torch(mode):
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 27 * 27, 8)).astype(np.float32)
    ours = np.asarray(pool_2d(jnp.asarray(x), mode, 2))

    t = torch.from_numpy(x).view(2, 27, 27, 8).permute(0, 3, 1, 2)
    if mode == "average":
        ref = F.avg_pool2d(t, 2)
    elif mode == "max":
        ref = F.max_pool2d(t, 2)
    else:
        ref = F.interpolate(t, size=[14, 14], mode="bilinear")
    ref = ref.permute(0, 2, 3, 1).reshape(2, -1, 8).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert ours.shape[1] == (196 if mode == "bilinear" else 169)


# ---------------------------------------------------------------------------
# Anyres geometry vs reference mm_utils
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_mm_utils(reference_llava):
    from llava import mm_utils

    return mm_utils


@pytest.mark.parametrize(
    "size",
    [(500, 300), (300, 500), (1000, 1000), (123, 987), (384, 384), (2000, 50)],
)
def test_best_resolution_matches_reference(ref_mm_utils, size):
    assert select_best_resolution(size, PINPOINTS) == tuple(
        ref_mm_utils.select_best_resolution(size, [list(p) for p in PINPOINTS])
    )
    assert anyres_grid_shape(size, PINPOINTS, 384) == tuple(
        ref_mm_utils.get_anyres_image_grid_shape(
            size, [list(p) for p in PINPOINTS], 384
        )
    )


@pytest.mark.parametrize("size", [(500, 300), (640, 480), (87, 1022)])
def test_resize_pad_matches_reference(ref_mm_utils, size):
    from PIL import Image

    rng = np.random.default_rng(2)
    img = Image.fromarray(
        rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
    )
    best = select_best_resolution(img.size, PINPOINTS)
    ours = np.asarray(
        __import__(
            "lavida_mod.data.anyres", fromlist=["resize_and_pad_image"]
        ).resize_and_pad_image(img, best)
    )
    ref = np.asarray(ref_mm_utils.resize_and_pad_image(img, best))
    np.testing.assert_array_equal(ours, ref)


def _ref_unpad_image(tensor, original_size):
    """Literal numpy oracle of llava_arch.py:154-186 unpad_image (importing
    llava_arch pulls the full torch tower zoo)."""
    ow, oh = original_size
    ch, cw = tensor.shape[1:]
    if ow / oh > cw / ch:
        scale = cw / ow
        nh = int(oh * scale)
        pad = (ch - nh) // 2
        return tensor[:, pad : ch - pad, :]
    else:
        scale = ch / oh
        nw = int(ow * scale)
        pad = (cw - nw) // 2
        return tensor[:, :, pad : cw - pad]


def test_unpad_slice_matches_reference_unpad():
    rng = np.random.default_rng(3)
    for osize, chw in [((500, 300), (28, 28)), ((300, 500), (28, 42)),
                       ((640, 640), (28, 28)), ((100, 900), (56, 14))]:
        x = rng.standard_normal((8, chw[0], chw[1])).astype(np.float32)
        ref = _ref_unpad_image(x, osize)
        rs, cs = unpad_slice(osize, chw)
        ours = x[:, rs, cs]
        np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# End-to-end tiny composition
# ---------------------------------------------------------------------------

def test_encode_and_splice_shapes():
    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import multimodal as mm

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(),
            mm_hidden_size=32,
            grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        ),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))

    # anyres image 100x60 -> best (112, 56) wait (w,h); grid 2x1 tiles
    img_size = (100, 60)
    nw, nh = anyres_grid_shape(img_size, cfg.vision.grid_pinpoints, 56)
    views = jnp.zeros((1 + nw * nh, 3, 56, 56), jnp.float32)
    block = mm.encode_image(params, cfg, views, img_size)
    # pooled grid per view: ceil(4/2)=2 -> 4 tokens
    g = 2
    rs, cs = unpad_slice(img_size, (nh * g, nw * g))
    H = rs.stop - rs.start
    W = cs.stop - cs.start
    assert block.shape == (4 + H * (W + 1), cfg.llada.d_model)

    ids = np.array([5, 6, -200, 7, 8, 9])
    embeds, labels = mm.splice_embeddings(
        params, cfg, ids, [block], labels=np.array([5, 6, -200, 7, 8, 9])
    )
    assert embeds.shape == (5 + block.shape[0], cfg.llada.d_model)
    assert (labels[2 : 2 + block.shape[0]] == -100).all()

    # batch prep pads and masks
    e, valid, labs, lens = mm.prepare_multimodal_batch(
        params, cfg, [ids, np.array([1, 2, 3])], [[views], []],
        [[img_size], []],
        batch_labels=[ids.copy(), np.array([1, 2, 3])],
    )
    assert e.shape[0] == 2 and bool(valid[1, 3:].any()) is False
    assert lens.tolist() == [5 + block.shape[0], 3]


def test_square_pad_path_unpooled():
    """The square/pad aspect path must return unpooled tokens with no
    newline (llava_arch.py:700-702: encode_images only)."""
    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import multimodal as mm

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
            image_aspect_ratio="pad",
        ),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    views = jnp.zeros((1, 3, 56, 56), jnp.float32)
    block = mm.encode_image(params, cfg, views, (56, 56))
    # 4x4 grid unpooled = 16 tokens, no newline token appended
    assert block.shape == (16, cfg.llada.d_model)

    # anyres config still pools + newlines
    cfg2 = cfg.replace(vision=cfg.vision.replace(image_aspect_ratio="anyres"))
    block2 = mm.encode_image(params, cfg2, views, (56, 56))
    assert block2.shape == (4 + 1, cfg.llada.d_model)  # pooled 2x2 + newline


def test_siglip_int8_tower_parity():
    """quantize_tower + forward(act_int8=True): per-channel int8 weights
    with per-token int8 activations must track the float tower closely
    (serving option behind bench --vision-int8)."""
    from lavida_mod.config import tiny_siglip_config
    from lavida_mod.models import siglip

    cfg = tiny_siglip_config()
    p = siglip.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    views = jax.random.normal(
        jax.random.PRNGKey(1), (2, 3, cfg.image_size, cfg.image_size)
    )
    ref = siglip.forward(p, cfg, views)
    q = siglip.forward(siglip.quantize_tower(p), cfg, views, act_int8=True)
    err = float(jnp.max(jnp.abs(q - ref)) / jnp.max(jnp.abs(ref)))
    assert err < 0.01, err
    # bf16-weight params + act_int8=True is a harmless no-op fallback
    same = siglip.forward(p, cfg, views, act_int8=True)
    assert float(jnp.max(jnp.abs(same - ref))) == 0.0


def test_tower_casts_pixels_to_param_dtype():
    """f32 processor pixels into a bf16 tower must run the tower in
    bf16 (llava_arch.py:700 images.to(dtype)): before the fix the
    f32 x bf16 promotion ran the whole serving prefill AND the KV
    cache in f32 — caught on chip as f32[8,1184,32,128] cache buffers
    that OOM'd the B=8 worker graph (_serve_concurrency probe)."""
    from lavida_mod.config import tiny_siglip_config
    from lavida_mod.models import clip, eva_clip, mlcd, siglip

    cfg = tiny_siglip_config()
    views_f32 = jax.random.normal(
        jax.random.PRNGKey(1), (2, 3, cfg.image_size, cfg.image_size),
        jnp.float32)

    p = siglip.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    assert siglip.forward(p, cfg, views_f32).dtype == jnp.bfloat16

    pc = clip.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    assert clip.forward(pc, cfg, views_f32).dtype == jnp.bfloat16

    pm = mlcd.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    assert mlcd.forward(pm, cfg, views_f32).dtype == jnp.bfloat16

    ecfg = eva_clip.EVAConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        width=64, layers=2, head_width=16, mlp_ratio=2.0)
    pe = eva_clip.init_params(ecfg, jax.random.PRNGKey(0), jnp.bfloat16)
    assert eva_clip.forward(pe, ecfg, views_f32).dtype == jnp.bfloat16
