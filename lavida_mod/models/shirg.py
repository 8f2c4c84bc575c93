"""SHIRG-Fovea: high-resolution vision-token selection.

Re-design of the reference mixin (llava/model/multimodal_encoder/
siglip_shirg.py) as pure fixed-shape functions — the whole selection is one
jittable score + top-k + gather (the "fused top-k gather kernel" of the
north star):

  2-view pipeline (siglip_shirg.py:46-215):
    global 448^2 -> 1024 tokens -> 2x2 avg pool -> 256
    foveal 448^2 -> 1024 tokens -> top-K 724 (70.7%)
    concat -> exactly 980 tokens (KV-cache-parity with the 5-view baseline)

  scoring (topk_per_view, :393-553): 0.7·token-0-similarity ("CLS" proxy —
  SigLIP has no CLS; the reference uses token 0) + 0.3·text-sim-or-magnitude,
  min-max normalized; methods base / entropy (std noise gate) / edge (Sobel
  prior, :555-607) / edge_only / custom / full (adds pairwise-similarity
  distance penalty :609-634 and anti-center radial weight :636-687) /
  random.

  token budget is exact by construction (top-k of fixed K).

Host preprocessing (mm_utils.py:318-407): both views processed at 448^2 —
global is a LANCZOS resize of the full image, foveal a center crop.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LaViDaConfig
from . import projector as projector_model
from . import siglip as siglip_model

SHIRG_GLOBAL_TOKENS = 256
SHIRG_FOVEAL_TOKENS = 724
SHIRG_TOTAL_TOKENS = SHIRG_GLOBAL_TOKENS + SHIRG_FOVEAL_TOKENS  # 980


# ---------------------------------------------------------------------------
# host-side preprocessing
# ---------------------------------------------------------------------------

def process_shirg_2view(image, processor) -> np.ndarray:
    """PIL image -> [2, C, 448, 448]: global resize + center-crop foveal
    (mm_utils.py:318-407)."""
    from PIL import Image

    size = 448
    global_view = image.resize((size, size), Image.LANCZOS)
    w, h = image.size
    cx, cy = w // 2, h // 2
    left = max(0, cx - size // 2)
    top = max(0, cy - size // 2)
    right = min(w, left + size)
    bottom = min(h, top + size)
    if right - left < size:
        left = max(0, right - size)
    if bottom - top < size:
        top = max(0, bottom - size)
    foveal = image.crop((left, top, right, bottom))
    if foveal.size != (size, size):
        foveal = foveal.resize((size, size), Image.LANCZOS)

    import dataclasses

    proc448 = dataclasses.replace(processor) if dataclasses.is_dataclass(
        processor
    ) else type(processor)(
        size=size, image_mean=tuple(processor.image_mean),
        image_std=tuple(processor.image_std),
        rescale_factor=processor.rescale_factor,
    )
    proc448.size = size
    return np.stack([proc448(global_view), proc448(foveal)], axis=0)


# ---------------------------------------------------------------------------
# scoring components
# ---------------------------------------------------------------------------

def _minmax(x: jax.Array) -> jax.Array:
    lo = x.min(axis=-1, keepdims=True)
    hi = x.max(axis=-1, keepdims=True)
    return (x - lo) / (hi - lo + 1e-8)


def _normalize(x: jax.Array) -> jax.Array:
    return x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def edge_prior(tokens: jax.Array) -> jax.Array:
    """Sobel edge magnitude over the channel-mean token grid
    (siglip_shirg.py:555-607). tokens: [B, N, D] with N a square."""
    B, N, D = tokens.shape
    g = int(round(math.sqrt(N)))
    assert g * g == N
    grid = tokens.mean(axis=-1).reshape(B, g, g).astype(jnp.float32)
    p = jnp.pad(grid, ((0, 0), (1, 1), (1, 1)), mode="edge")

    def shift(dy, dx):
        return p[:, 1 + dy : 1 + dy + g, 1 + dx : 1 + dx + g]

    gx = (
        -shift(-1, -1) + shift(-1, 1)
        - 2 * shift(0, -1) + 2 * shift(0, 1)
        - shift(1, -1) + shift(1, 1)
    )
    gy = (
        -shift(-1, -1) - 2 * shift(-1, 0) - shift(-1, 1)
        + shift(1, -1) + 2 * shift(1, 0) + shift(1, 1)
    )
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(B, N)
    return _minmax(mag)


def distance_penalty(tokens: jax.Array) -> jax.Array:
    """Mean off-diagonal cosine similarity (siglip_shirg.py:609-634)."""
    B, N, D = tokens.shape
    tn = _normalize(tokens.astype(jnp.float32))
    sim = jnp.einsum("bnd,bmd->bnm", tn, tn)
    avg = (sim.sum(axis=-1) - 1.0) / (N - 1)
    return _minmax(avg)


def radial_weight(n: int, sigma: float) -> jax.Array:
    """Anti-center-bias weight, mean-normalized (siglip_shirg.py:636-687)."""
    g = int(round(math.sqrt(n)))
    if g * g != n:
        return jnp.ones((n,), jnp.float32)
    y = jnp.arange(g, dtype=jnp.float32)[:, None]
    x = jnp.arange(g, dtype=jnp.float32)[None, :]
    cy = cx = g / 2 - 0.5
    d2 = (y - cy) ** 2 + (x - cx) ** 2
    dnorm = jnp.sqrt(d2 / ((g / 2) ** 2 + (g / 2) ** 2))
    w = 1.0 - jnp.exp(-((dnorm / sigma) ** 2))
    w = w.reshape(n)
    return w / w.mean()


def shirg_scores(
    tokens: jax.Array,
    text_embeddings: Optional[jax.Array] = None,
    method: str = "base",
    params: Optional[dict] = None,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """[B, N, D] -> combined selection scores [B, N]
    (siglip_shirg.py topk_per_view :415-530)."""
    p = params or {}
    B, N, D = tokens.shape
    tf = tokens.astype(jnp.float32)
    tn = _normalize(tf)
    attn = _minmax(jnp.einsum("bnd,bd->bn", tn, tn[:, 0]))
    if text_embeddings is not None and text_embeddings.shape[-1] == D:
        te = _normalize(text_embeddings.astype(jnp.float32)).mean(
            axis=1
        )
        sim = jnp.einsum("bnd,bd->bn", tn, te)
    else:
        sim = jnp.linalg.norm(tf, axis=-1)
    sim = _minmax(sim)

    if method == "random":
        assert key is not None
        return jax.random.uniform(key, (B, N))
    if method == "base":
        return 0.7 * attn + 0.3 * sim
    if method == "entropy":
        tau = p.get("entropy_threshold", 0.12)
        gate = (attn.std(axis=-1, keepdims=True) <= tau).astype(jnp.float32)
        return (0.7 * attn + 0.3 * sim) * gate
    if method == "edge":
        ep = edge_prior(tokens)
        ew = p.get("edge_weight", 0.25)
        return 0.4 * attn + (0.35 - ew) * sim + ew * ep
    if method == "edge_only":
        ep = edge_prior(tokens)
        ew = p.get("edge_weight", 0.8)
        return (1.0 - ew) * sim + ew * ep
    if method == "custom":
        aw = p.get("attention_weight", 0.0)
        sw = p.get("similarity_weight", 0.2)
        ew = p.get("edge_weight", 0.8)
        tot = max(aw + sw + ew, 1e-8)
        ep = edge_prior(tokens)
        return (aw / tot) * attn + (sw / tot) * sim + (ew / tot) * ep
    if method == "full":
        tau = p.get("entropy_threshold", 0.12)
        gate = (attn.std(axis=-1, keepdims=True) <= tau).astype(jnp.float32)
        ep = edge_prior(tokens)
        dp = distance_penalty(tokens)
        sigma = p.get("radial_sigma", 0.65)
        rw = radial_weight(N, sigma)[None]
        raw = 0.4 * attn + 0.25 * sim - 0.1 * dp + 0.25 * ep
        return raw * gate * rw
    raise ValueError(f"unknown SHIRG method: {method}")


def topk_select(tokens: jax.Array, scores: jax.Array, k: int) -> jax.Array:
    """The fused top-k gather: [B, N, D] + [B, N] -> [B, K, D], keeping
    torch.topk's score-descending order (siglip_shirg.py:532-545)."""
    # epsilon budget guarantee (:531-535)
    scores = scores + 1e-6
    _, idx = jax.lax.top_k(scores, k)
    return jnp.take_along_axis(tokens, idx[..., None], axis=1)


def merge_similar_tokens(
    tokens: jax.Array, threshold: float = 0.9,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """Post-selection budget-reclaim merge, fixed-shape rebuild of
    siglip_shirg.py:689-787 (invoked at :548-549 under
    `merge_similar`+`method='full'`): greedy in-order cosine merging —
    token i absorbs every still-kept j>i with sim(i,j) > threshold as
    their mean (of ORIGINAL values; absorbed tokens can never re-merge)
    — then kept tokens compact to the front and the tail pads by
    repeating the last kept token, so exactly K tokens survive (the
    reference's own hard LaViDa cache-compatibility constraint, :693).

    The reference adds 1e-6 gaussian noise to the pad rows; pass `key`
    to reproduce that, default None pads noiselessly (1e-6 is below
    bf16 resolution — documented deviation)."""
    B, K, D = tokens.shape
    triu = jnp.triu(jnp.ones((K, K), jnp.float32), k=1)

    def one(tok):
        tokf = tok.astype(jnp.float32)
        # F.normalize semantics: x / max(||x||, 1e-12)
        tn = tokf / jnp.maximum(
            jnp.linalg.norm(tokf, axis=-1, keepdims=True), 1e-12)
        # torch computes (sim * triu_mask) > threshold — multiply THEN
        # compare, so lower-tri entries compare 0 > threshold (:715-716)
        pairs = (tn @ tn.T) * triu > threshold

        def step(kept, inp):
            row, i = inp
            similar = row & kept & kept[i]
            any_sim = similar.any()
            group = similar.at[i].set(True)
            mean = (tokf * group[:, None].astype(jnp.float32)).sum(0) \
                / jnp.maximum(group.sum(), 1)
            new_row = jnp.where(any_sim, mean, tokf[i])
            return kept & ~similar, new_row

        kept, merged = jax.lax.scan(
            step, jnp.ones((K,), bool), (pairs, jnp.arange(K)))
        # compaction: kept rows first in original order, tail repeats the
        # last kept row (kept[0] is always True — row 0 has no j<0 to
        # absorb it — so u >= 1 and the :762-764 fallback is dead code)
        order = jnp.argsort(~kept, stable=True)
        u = kept.sum()
        pos = jnp.arange(K)
        src = jnp.where(pos < u, order[pos], order[u - 1])
        return merged[src].astype(tok.dtype), (pos < u)

    out, live = jax.vmap(one)(tokens)
    if key is not None:
        noise = 1e-6 * jax.random.normal(key, out.shape, jnp.float32)
        out = jnp.where(live[..., None], out,
                        out + noise.astype(out.dtype))
    return out


# ---------------------------------------------------------------------------
# full SHIRG encode
# ---------------------------------------------------------------------------

def shirg_encode(
    params: dict,
    cfg: LaViDaConfig,
    views: jax.Array,                     # [2, C, 448, 448]
    text_embeddings: Optional[jax.Array] = None,
    method: str = "base",
    selection_params: Optional[dict] = None,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """2-view SHIRG pipeline -> projected tokens [980, D_lm].

    Matches the reference flow: tower features (truncated SigLIP, raw
    hidden state) -> global 2x2 avg pool to 256 + foveal top-724 ->
    mm_projector; pooling in llava_arch is bypassed for non-729 counts
    (llava_arch.py:205-213)."""
    feats = siglip_model.forward(
        params["siglip"], cfg.vision.siglip, views,
    )  # [2, 1024, D]
    g_feat = feats[0:1]
    f_feat = feats[1:2]
    B, N, D = g_feat.shape
    gsz = int(round(math.sqrt(N)))
    grid = g_feat.reshape(B, gsz, gsz, D)
    go = gsz // 2
    pooled = grid[:, : go * 2, : go * 2].reshape(
        B, go, 2, go, 2, D
    ).mean(axis=(2, 4)).reshape(B, go * go, D)

    k = SHIRG_FOVEAL_TOKENS if f_feat.shape[1] == 1024 else min(
        f_feat.shape[1], SHIRG_FOVEAL_TOKENS
    )
    scores = shirg_scores(f_feat, text_embeddings, method,
                          selection_params, key)
    selected = topk_select(f_feat, scores, k)

    # optional post-selection merge (siglip_shirg.py:548-549: only under
    # merge_similar AND method='full')
    sp = selection_params or {}
    if sp.get("merge_similar", False) and method == "full":
        selected = merge_similar_tokens(
            selected, sp.get("merge_threshold", 0.9))

    tokens = jnp.concatenate([pooled, selected], axis=1)  # [1, 980, D]
    projected = projector_model.forward(
        params["projector"], cfg.vision.projector_type, tokens
    )
    return projected[0]
