"""SHIRG tests: scoring semantics vs a torch oracle, budget exactness,
2-view preprocessing geometry, end-to-end encode + generation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import (
    LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
)
from lavida_mod.models import shirg as S


def _torch_base_scores(tokens):
    import torch.nn.functional as F

    t = torch.from_numpy(tokens)
    tn = F.normalize(t, dim=-1)
    cls = tn[:, 0:1]
    attn = torch.matmul(tn, cls.transpose(-1, -2)).squeeze(-1)
    sim = torch.norm(t, dim=-1)

    def mm(x):
        lo = x.min(dim=1, keepdim=True)[0]
        hi = x.max(dim=1, keepdim=True)[0]
        return (x - lo) / (hi - lo + 1e-8)

    return (0.7 * mm(attn) + 0.3 * mm(sim)).numpy()


def test_base_scores_match_torch_oracle():
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((2, 16, 8)).astype(np.float32)
    ours = np.asarray(S.shirg_scores(jnp.asarray(tokens), method="base"))
    ref = _torch_base_scores(tokens)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_edge_prior_matches_torch_sobel():
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    tokens = rng.standard_normal((1, 16, 4)).astype(np.float32)
    ours = np.asarray(S.edge_prior(jnp.asarray(tokens)))

    t = torch.from_numpy(tokens).view(1, 4, 4, 4).permute(0, 3, 1, 2)
    tm = t.mean(dim=1, keepdim=True)
    tp = F.pad(tm, (1, 1, 1, 1), mode="replicate")
    sx = torch.tensor([[-1., 0, 1], [-2, 0, 2], [-1, 0, 1]]).view(1, 1, 3, 3)
    sy = torch.tensor([[-1., -2, -1], [0, 0, 0], [1, 2, 1]]).view(1, 1, 3, 3)
    ex = F.conv2d(tp, sx)
    ey = F.conv2d(tp, sy)
    mag = torch.sqrt(ex**2 + ey**2).view(1, 16)
    lo, hi = mag.min(dim=1, keepdim=True)[0], mag.max(dim=1, keepdim=True)[0]
    ref = ((mag - lo) / (hi - lo + 1e-8)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_topk_select_order_and_budget():
    rng = np.random.default_rng(2)
    tokens = jnp.asarray(rng.standard_normal((1, 10, 4)).astype(np.float32))
    scores = jnp.asarray(np.array([[5, 1, 9, 3, 7, 2, 8, 0, 4, 6]], np.float32))
    out = np.asarray(S.topk_select(tokens, scores, 3))
    # descending score order: indices 2, 6, 4
    np.testing.assert_allclose(out[0, 0], np.asarray(tokens)[0, 2])
    np.testing.assert_allclose(out[0, 1], np.asarray(tokens)[0, 6])
    np.testing.assert_allclose(out[0, 2], np.asarray(tokens)[0, 4])


@pytest.mark.parametrize("method", ["base", "entropy", "edge", "edge_only",
                                    "custom", "full", "random"])
def test_all_methods_produce_valid_scores(method):
    rng = np.random.default_rng(3)
    tokens = jnp.asarray(rng.standard_normal((1, 64, 8)).astype(np.float32))
    s = S.shirg_scores(tokens, method=method, key=jax.random.PRNGKey(0))
    assert s.shape == (1, 64)
    assert bool(jnp.isfinite(s).all())


def test_radial_weight_prefers_edges():
    w = np.asarray(S.radial_weight(64, 0.65))
    grid = w.reshape(8, 8)
    assert grid[0, 0] > grid[3, 3]  # corners weighted above center
    np.testing.assert_allclose(w.mean(), 1.0, atol=1e-5)


def _torch_merge_similar(tokens, threshold):
    """Transcription of the reference greedy merge
    (siglip_shirg.py:689-787), pad noise zeroed for determinism."""
    import torch.nn.functional as F

    t = torch.from_numpy(tokens)
    B, K, D = t.shape
    tn = F.normalize(t, dim=-1)
    sim = torch.bmm(tn, tn.transpose(1, 2))
    mask = torch.triu(torch.ones(K, K), diagonal=1)
    pairs = (sim * mask) > threshold
    outs = []
    for b in range(B):
        bt = t[b].clone()
        kept = torch.ones(K, dtype=torch.bool)
        for i in range(K):
            if kept[i]:
                similar = pairs[b, i, :] & kept
                if similar.any():
                    idx = similar.nonzero(as_tuple=True)[0]
                    all_idx = torch.cat([torch.tensor([i]), idx])
                    bt[i] = bt[all_idx].mean(dim=0)
                    kept[idx] = False
        u = int(kept.sum())
        uniq = bt[kept]
        if u < K:
            pad = uniq[-1:].expand(K - u, -1)
            final = torch.cat([uniq, pad], dim=0)
        else:
            final = bt
        outs.append(final[None])
    return torch.cat(outs, 0).numpy()


def test_merge_similar_tokens_matches_torch_oracle():
    rng = np.random.default_rng(7)
    # build clusters of near-duplicates so merging actually fires
    base = rng.standard_normal((1, 6, 16)).astype(np.float32)
    tokens = np.concatenate(
        [base + 0.01 * rng.standard_normal(base.shape) for _ in range(3)],
        axis=1,
    )  # [1, 18, 16] with ~3 copies of each row
    ref = _torch_merge_similar(tokens, 0.9)
    ours = np.asarray(S.merge_similar_tokens(jnp.asarray(tokens), 0.9))
    assert ours.shape == tokens.shape  # exactly K preserved (:693)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    # merging actually happened (duplicates collapsed)
    assert np.abs(ours - tokens).max() > 1e-3


def test_merge_similar_tokens_no_pairs_is_identity():
    rng = np.random.default_rng(8)
    tokens = rng.standard_normal((2, 12, 32)).astype(np.float32)
    out = np.asarray(S.merge_similar_tokens(jnp.asarray(tokens), 0.999))
    np.testing.assert_allclose(out, tokens, atol=1e-6)


def test_shirg_encode_merge_similar_wiring():
    """merge_similar+method='full' routes through the merge (shape keeps
    the 980-token contract); other methods bypass it (:548)."""
    rng = np.random.default_rng(9)
    tokens = jnp.asarray(rng.standard_normal((1, 64, 8)).astype(np.float32))
    s = S.shirg_scores(tokens, method="full", key=jax.random.PRNGKey(0))
    sel = S.topk_select(tokens, s, 16)
    merged = S.merge_similar_tokens(sel, 0.5)
    assert merged.shape == sel.shape


def test_2view_preprocess_geometry():
    from PIL import Image

    from lavida_mod.data import SigLIPImageProcessor

    img = Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (600, 900, 3),
                                          dtype=np.uint8)
    )
    views = S.process_shirg_2view(img, SigLIPImageProcessor(size=384))
    assert views.shape == (2, 3, 448, 448)
    # views differ (global resize vs center crop)
    assert np.abs(views[0] - views[1]).max() > 0.1


def test_shirg_encode_end_to_end():
    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
        ),
    )
    from lavida_mod.models import multimodal as mm

    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    # tiny geometry: 448-analogue = 8x8 grid -> use 112x112 (8x8 patches)
    views = jnp.asarray(
        np.random.default_rng(1).standard_normal((2, 3, 112, 112))
        .astype(np.float32)
    )
    out = S.shirg_encode(params, cfg, views, method="base")
    # global 8x8 -> 4x4=16 pooled; foveal 64 tokens -> min(64, 724)=64
    assert out.shape == (16 + 64, cfg.llada.d_model)

    # feeds generation like any image block
    from lavida_mod.config import GenerationConfig
    from lavida_mod.generation import generate
    from lavida_mod.models import llada as jl
    from lavida_mod.models.multimodal import splice_embeddings

    ids = np.array([5, 6, -200, 7, 8])
    embeds, _ = splice_embeddings(params, cfg, ids, [out])
    x = generate(params["llada"], cfg.llada, embeds[None],
                 GenerationConfig(max_new_tokens=8, block_length=8))
    assert (np.asarray(x) != cfg.llada.mask_token_id).all()
