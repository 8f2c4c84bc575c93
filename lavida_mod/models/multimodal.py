"""Multimodal composition: vision encode -> project -> pool -> anyres merge
-> token splicing.  The functional re-design of llava_arch.py's
LlavaMetaModel/LlavaMetaForCausalLM (reference llava/model/llava_arch.py).

Structure of a composed LaViDa parameter pytree:

  {"llada": <models.llada params>,
   "siglip": <models.siglip params>,
   "projector": <models.projector params>,
   "image_newline": [D_lm]}        (llava_arch.py:61)

Pipeline parity notes:
  - encode_images applies the projector BEFORE pooling (llava_arch.py:235-281
    then :490-533): tower [V,729,1152] -> mm_projector [V,729,4096] ->
    2x2 pool [V,196,4096].
  - anyres merge (llava_arch.py:548-678 "spatial_unpad"): tiles reshaped to
    (nh, nw, 14, 14, D) -> [D, nh*14, nw*14] -> unpad -> image_newline column
    appended -> flatten; base view's 196 tokens prepended.
  - token splicing (llava_arch.py:694-909): each IMAGE_TOKEN_INDEX (-200) in
    input_ids is replaced by that image's feature block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LaViDaConfig, VisionConfig
from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..data.anyres import anyres_grid_shape, unpad_slice
from ..ops.pooling import pool_2d
from . import llada as llada_model
from . import projector as projector_model
from . import siglip as siglip_model


def init_params(cfg: LaViDaConfig, key: jax.Array, dtype=jnp.float32) -> dict:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {
        "llada": llada_model.init_params(cfg.llada, k1, dtype),
        "siglip": siglip_model.init_params(cfg.vision.siglip, k2, dtype),
        "projector": projector_model.init_params(
            cfg.vision.projector_type, cfg.vision.mm_hidden_size,
            cfg.llada.d_model, k3, dtype,
        ),
        "image_newline": (
            jax.random.normal(k4, (cfg.llada.d_model,)) /
            jnp.sqrt(cfg.llada.d_model)
        ).astype(dtype),
    }


def encode_views(params: dict, cfg: LaViDaConfig, pixel_values: jax.Array,
                 remat: bool = False, pool: bool = True,
                 act_int8: bool = False) -> jax.Array:
    """[V, C, S, S] -> projected(+pooled) features [V, T', D_lm].

    The jit-compiled device hot path of the vision stack; view count V is a
    static shape (1 for square, 1+tiles for anyres).  `pool=False` is the
    reference's square/pad 4D-tensor path (llava_arch.py:700-702:
    encode_images only — 729 unpooled tokens, no newline).
    """
    feats = siglip_model.forward(
        params["siglip"], cfg.vision.siglip, pixel_values, remat=remat,
        act_int8=act_int8,
    )
    feats = projector_model.forward(
        params["projector"], cfg.vision.projector_type, feats
    )
    if not pool:
        return feats
    return pool_2d(
        feats, cfg.vision.spatial_pool_mode, cfg.vision.spatial_pool_stride
    )


_encode_views_jit = jax.jit(
    encode_views, static_argnames=("cfg", "remat", "pool", "act_int8")
)


def merge_anyres(
    features: jax.Array,
    image_size: tuple[int, int],
    cfg: VisionConfig,
    image_newline: jax.Array,
) -> jax.Array:
    """Anyres "spatial_unpad" merge of pooled per-view features.

    features: [V, T, D] with V = 1 base + nh*nw tiles, T a square grid.
    Returns [n_tokens, D]: base tokens ++ unpadded tile grid with a newline
    column (llava_arch.py:548-678).
    """
    V, T, D = features.shape
    g = int(round(float(np.sqrt(T))))
    if V == 1:
        # single view: append one newline token (llava_arch.py:681-690)
        return jnp.concatenate([features[0], image_newline[None]], axis=0)
    base = features[0]
    tiles = features[1:]
    nw, nh = anyres_grid_shape(
        image_size, cfg.grid_pinpoints, cfg.siglip.image_size
    )
    assert nh * nw == V - 1, (nh, nw, V)
    grid = tiles.reshape(nh, nw, g, g, D)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(nh * g, nw * g, D)
    rs, cs = unpad_slice(image_size, (nh * g, nw * g))
    grid = grid[rs, cs]
    H, W = grid.shape[:2]
    nl = jnp.broadcast_to(image_newline, (H, 1, D)).astype(grid.dtype)
    grid = jnp.concatenate([grid, nl], axis=1).reshape(H * (W + 1), D)
    return jnp.concatenate([base, grid], axis=0)


def encode_image(
    params: dict,
    cfg: LaViDaConfig,
    views: jax.Array,
    image_size: Optional[tuple[int, int]] = None,
    remat: bool = False,
) -> jax.Array:
    """One image's views [V, C, S, S] -> merged token block [n, D_lm]."""
    if views.shape[0] == 1 and cfg.vision.image_aspect_ratio in (
        "square", "pad"
    ):
        # reference square/pad path: tower+projector only — UNPOOLED
        # tokens, no newline (llava_arch.py:700-702)
        return _encode_views_jit(params, cfg, views, remat, False)[0]
    feats = _encode_views_jit(params, cfg, views, remat)
    assert image_size is not None or views.shape[0] == 1
    return merge_anyres(
        feats, image_size or (cfg.vision.siglip.image_size,) * 2,
        cfg.vision, params["image_newline"],
    )


def encode_video(
    params: dict,
    cfg: LaViDaConfig,
    frame_views: jax.Array,      # [F, C, S, S]
) -> jax.Array:
    """Video path: per-frame encode+pool, flatten frames, append ONE newline
    token (llava_arch.py:600-610, mm_newline_position="one_token")."""
    feats = _encode_views_jit(params, cfg, frame_views, False)  # [F, T, D]
    F, T, D = feats.shape
    flat = feats.reshape(F * T, D)
    return jnp.concatenate(
        [flat, params["image_newline"][None].astype(flat.dtype)], axis=0
    )


def splice_embeddings(
    params: dict,
    cfg: LaViDaConfig,
    input_ids: np.ndarray,
    image_features: Sequence[jax.Array],
    labels: Optional[np.ndarray] = None,
):
    """Replace each IMAGE_TOKEN_INDEX in a single sample's ids with the next
    image's feature block (llava_arch.py:716-819).

    input_ids: [T] host ints; image_features: one [n_i, D] block per -200.
    Returns (embeds [T', D], labels' [T'] or None) — unpadded; the caller
    batches/pads (ragged sample lengths are inherently host-side).
    """
    input_ids = np.asarray(input_ids)
    img_pos = np.where(input_ids == IMAGE_TOKEN_INDEX)[0]
    assert len(img_pos) == len(image_features), (
        f"{len(img_pos)} image tokens vs {len(image_features)} images"
    )
    segments = []
    lab_segments = []
    prev = 0
    for i, pos in enumerate(img_pos):
        text_ids = input_ids[prev:pos]
        if len(text_ids):
            segments.append(
                llada_model.embed_tokens(params["llada"], jnp.asarray(text_ids))
            )
            if labels is not None:
                lab_segments.append(labels[prev:pos])
        feats = image_features[i]
        segments.append(feats)
        if labels is not None:
            lab_segments.append(
                np.full((feats.shape[0],), IGNORE_INDEX, np.int64)
            )
        prev = pos + 1
    tail = input_ids[prev:]
    if len(tail):
        segments.append(
            llada_model.embed_tokens(params["llada"], jnp.asarray(tail))
        )
        if labels is not None:
            lab_segments.append(labels[prev:])
    embeds = jnp.concatenate(segments, axis=0)
    out_labels = (
        np.concatenate(lab_segments, axis=0) if labels is not None else None
    )
    return embeds, out_labels


def merge_anyres_indices(
    image_size: tuple[int, int],
    cfg: VisionConfig,
    n_views: int,
    pooled_grid: int,
    view_offset: int,
    newline_index: int,
) -> np.ndarray:
    """Index-space version of merge_anyres: the merged block expressed as
    indices into a flat table [sum_views * T_pooled vision tokens ...;
    newline at `newline_index`].  Enables splicing as ONE gather inside jit
    (see build_gather_plan) so training gradients flow through the whole
    vision stack without dynamic shapes.
    """
    g = pooled_grid
    T = g * g
    base = view_offset * T + np.arange(T, dtype=np.int64)
    if n_views == 1:
        return np.concatenate([base, [newline_index]])
    nw, nh = anyres_grid_shape(
        image_size, cfg.grid_pinpoints, cfg.siglip.image_size
    )
    assert nh * nw == n_views - 1, (nh, nw, n_views)
    rs, cs = unpad_slice(image_size, (nh * g, nw * g))
    rows = []
    for h in range(rs.start, rs.stop):
        row = []
        for w in range(cs.start, cs.stop):
            view = 1 + (h // g) * nw + (w // g)
            tok = (h % g) * g + (w % g)
            row.append((view_offset + view) * T + tok)
        row.append(newline_index)
        rows.append(row)
    grid = np.asarray(rows, np.int64).reshape(-1)
    return np.concatenate([base, grid])


def build_gather_plan(
    cfg: LaViDaConfig,
    batch_input_ids: Sequence[np.ndarray],
    batch_n_views: Sequence[Sequence[int]],
    batch_image_sizes: Sequence[Sequence[tuple[int, int]]],
    batch_labels: Optional[Sequence[np.ndarray]] = None,
    pad_to: Optional[int] = None,
    pad_front: bool = False,
):
    """Host-side splice planning for the jitted multimodal path.

    The flat embedding table inside jit is
        [ all vision tokens (N_total_views * T_pooled) ;
          image_newline (1) ;
          text-token embeds (B * T_text) ;
          zero pad (1) ]
    This returns (gather_idx [B, T], text_ids [B, T_text], valid [B, T],
    labels [B, T] or None) where gather_idx indexes that table.
    """
    g = -(-cfg.vision.siglip.num_patches_per_side // cfg.vision.spatial_pool_stride)
    T_pooled = g * g
    n_total_views = sum(v for row in batch_n_views for v in row)
    newline_index = n_total_views * T_pooled
    text_base = newline_index + 1

    B = len(batch_input_ids)
    T_text = max(len(ids) for ids in batch_input_ids)
    text_ids = np.zeros((B, T_text), np.int64)

    rows = []
    row_labels = []
    view_offset = 0
    for b, ids in enumerate(batch_input_ids):
        ids = np.asarray(ids)
        labels = (
            np.asarray(batch_labels[b]) if batch_labels is not None else None
        )
        img_pos = np.where(ids == IMAGE_TOKEN_INDEX)[0]
        assert len(img_pos) == len(batch_n_views[b])
        idx_row: list[int] = []
        lab_row: list[int] = []
        prev = 0
        # text ids (image markers replaced by 0) go into the text table
        clean = np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)
        text_ids[b, : len(ids)] = clean
        for k, pos in enumerate(img_pos):
            for t in range(prev, pos):
                idx_row.append(text_base + b * T_text + t)
                if labels is not None:
                    lab_row.append(labels[t])
            block = merge_anyres_indices(
                batch_image_sizes[b][k], cfg.vision, batch_n_views[b][k],
                g, view_offset, newline_index,
            )
            idx_row.extend(block.tolist())
            if labels is not None:
                lab_row.extend([IGNORE_INDEX] * len(block))
            view_offset += batch_n_views[b][k]
            prev = pos + 1
        for t in range(prev, len(ids)):
            idx_row.append(text_base + b * T_text + t)
            if labels is not None:
                lab_row.append(labels[t])
        if cfg.tokenizer_model_max_length:
            idx_row = idx_row[: cfg.tokenizer_model_max_length]
            lab_row = lab_row[: cfg.tokenizer_model_max_length]
        rows.append(idx_row)
        row_labels.append(lab_row)

    T = int(pad_to or max(len(r) for r in rows))
    pad_index = text_base + B * T_text
    gather_idx = np.full((B, T), pad_index, np.int64)
    valid = np.zeros((B, T), bool)
    out_labels = (
        np.full((B, T), IGNORE_INDEX, np.int64)
        if batch_labels is not None else None
    )
    for b, r in enumerate(rows):
        n = min(len(r), T)
        if pad_front:
            # serving/bucketing convention: pad at the FRONT so the gen
            # region stays position-contiguous with the real prefix tail
            # (matches LaViDa.generate's prefix_bucket padding; pad
            # positions are masked out via `valid`)
            gather_idx[b, T - n:] = r[:n]
            valid[b, T - n:] = True
            if out_labels is not None:
                out_labels[b, T - n:] = row_labels[b][:n]
        else:
            gather_idx[b, :n] = r[:n]
            valid[b, :n] = True
            if out_labels is not None:
                out_labels[b, :n] = row_labels[b][:n]
    return gather_idx, text_ids, valid, out_labels


def multimodal_embeds(
    params: dict,
    cfg: LaViDaConfig,
    pixel_values: jax.Array,     # [N_total_views, C, S, S]
    text_ids: jax.Array,         # [B, T_text]
    gather_idx: jax.Array,       # [B, T]
    remat: bool = False,
    vision_act_int8: bool = False,
    mesh=None,
    batch_axes: tuple = ("dp", "fsdp"),
) -> jax.Array:
    """The jitted splice: encode all views, build the flat table, gather.
    Differentiable end-to-end (tower -> projector -> newline -> wte).

    mesh: when given, the flat table is constrained replicated and the
    gathered output pinned to the data axes.  The gather's indices are
    global (any row may reference any view's tokens), so GSPMD cannot
    shard the table by rows; left unconstrained it picks conflicting
    layouts between the forward gather and its transpose (scatter-add)
    and falls back to "involuntary full rematerialization" — observed on
    the 8-device multimodal dryrun.  One explicit all-gather of the table
    is the intended layout."""
    B = text_ids.shape[0]
    D = params["image_newline"].shape[-1]
    if pixel_values.shape[0] > 0:
        feats = encode_views(params, cfg, pixel_values, remat,
                             act_int8=vision_act_int8)  # [N, Tp, D]
        flat = feats.reshape(-1, D)
    else:  # text-only batch (static shape decision)
        flat = jnp.zeros((0, D), params["image_newline"].dtype)
    text_emb = llada_model.embed_tokens(params["llada"], text_ids)
    table = jnp.concatenate(
        [
            flat,
            params["image_newline"][None].astype(flat.dtype),
            text_emb.reshape(-1, D).astype(flat.dtype),
            jnp.zeros((1, D), flat.dtype),
        ],
        axis=0,
    )
    B2, T2 = gather_idx.shape
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        axes = tuple(a for a in batch_axes if a in mesh.axis_names)
        table = jax.lax.with_sharding_constraint(
            table, NamedSharding(mesh, PartitionSpec()))
        # GSPMD partitions the gather: replicated table, batch-sharded
        # indices and output
        out = table[gather_idx.reshape(-1)]
        return jax.lax.with_sharding_constraint(
            out.reshape(B2, T2, D),
            NamedSharding(mesh, PartitionSpec(axes, None, None)))
    return table[gather_idx.reshape(-1)].reshape(B2, T2, D)


def prepare_multimodal_batch(
    params: dict,
    cfg: LaViDaConfig,
    batch_input_ids: Sequence[np.ndarray],
    batch_images: Sequence[Sequence[jax.Array]],
    batch_image_sizes: Sequence[Sequence[tuple[int, int]]],
    batch_labels: Optional[Sequence[np.ndarray]] = None,
    pad_to: Optional[int] = None,
    pad_side: str = "right",
):
    """Full batch path: encode each image, splice, pad to a common length.

    Returns (embeds [B, T, D], valid [B, T] bool, labels [B, T] or None,
    lengths [B]).  Truncates to cfg.tokenizer_model_max_length
    (llava_arch.py:827-829).
    """
    rows = []
    labs = []
    for b, ids in enumerate(batch_input_ids):
        feats = [
            encode_image(params, cfg, views, size)
            for views, size in zip(batch_images[b], batch_image_sizes[b])
        ]
        e, l = splice_embeddings(
            params, cfg, ids, feats,
            batch_labels[b] if batch_labels is not None else None,
        )
        if cfg.tokenizer_model_max_length:
            e = e[: cfg.tokenizer_model_max_length]
            l = l[: cfg.tokenizer_model_max_length] if l is not None else None
        rows.append(e)
        labs.append(l)

    lengths = np.array([r.shape[0] for r in rows])
    T = int(pad_to or lengths.max())
    D = rows[0].shape[-1]
    B = len(rows)
    embeds = jnp.zeros((B, T, D), rows[0].dtype)
    valid = np.zeros((B, T), bool)
    out_labels = (
        np.full((B, T), IGNORE_INDEX, np.int64)
        if batch_labels is not None else None
    )
    for b, r in enumerate(rows):
        n = r.shape[0]
        if pad_side == "right":
            embeds = embeds.at[b, :n].set(r)
            valid[b, :n] = True
            if out_labels is not None:
                out_labels[b, :n] = labs[b]
        else:
            embeds = embeds.at[b, T - n:].set(r)
            valid[b, T - n:] = True
            if out_labels is not None:
                out_labels[b, T - n:] = labs[b]
    return embeds, jnp.asarray(valid), out_labels, lengths
