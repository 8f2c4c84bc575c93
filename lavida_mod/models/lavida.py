"""LaViDa: the composed multimodal masked-diffusion model (public API).

The thin stateful facade over the functional cores — the analogue of
`LlavaLladaForMaskedDiffusion` (reference llava/model/language_model/
llava_llada.py:76-341) minus the HF mixin soup: holds (config, params),
exposes generate / log-likelihood / checkpoint loading.

Checkpoint layout of the published HF weights (module naming from
LLaDAModelLM.base_model_prefix="model", LlavaMetaModel attributes):
  model.transformer.{wte,ln_f,ff_out,blocks.N.*}      -> llada params
  model.vision_tower.vision_tower.vision_model.*      -> siglip params
  model.mm_projector.{0,2}.{weight,bias}              -> projector params
  model.image_newline                                 -> newline vector
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DreamGenerationConfig, GenerationConfig, LaViDaConfig
from ..generation import diffusion
from ..generation.dream_sampler import dream_generate
from . import llada as llada_model
from . import multimodal
from .dream import convert_dream_state_dict
from .llada_loader import convert_state_dict
from .projector import convert_projector_state_dict
from .siglip import convert_siglip_state_dict


def load_state_shards(path: str) -> dict[str, np.ndarray]:
    """Read all safetensors / torch-bin shards in a checkpoint dir."""
    state: dict[str, np.ndarray] = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        from safetensors.numpy import load_file

        for f in st_files:
            state.update(load_file(f))
        return state
    import torch

    for f in sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))):
        sd = torch.load(f, map_location="cpu", weights_only=True)
        state.update({k: v.float().numpy() for k, v in sd.items()})
    if not state:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    return state


def convert_lavida_state_dict(
    state: dict[str, np.ndarray], cfg: LaViDaConfig, dtype=jnp.bfloat16,
    lm_family: str = "llada",
) -> dict:
    """Convert a composed LaViDa checkpoint.  lm_family selects the LM
    converter: "llada" (OLMo-style names) or "dream" (Qwen2-style names,
    llava_dream.py wrapper layout)."""
    if lm_family == "dream":
        lm = convert_dream_state_dict(state, cfg.llada, dtype, prefix="model.")
    else:
        lm = convert_state_dict(state, cfg.llada, dtype)
    params = {
        "llada": lm,
        "siglip": convert_siglip_state_dict(
            state, cfg.vision.siglip, dtype,
            prefix="model.vision_tower.vision_tower.vision_model.",
        ),
        "projector": convert_projector_state_dict(
            state, cfg.vision.projector_type, dtype,
            prefix="model.mm_projector.",
        ),
    }
    nl = state.get("model.image_newline")
    params["image_newline"] = (
        jnp.asarray(nl, dtype) if nl is not None
        else jnp.zeros((cfg.llada.d_model,), dtype)
    )
    return params


def _load_torch_bin(path: str) -> dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _strip_peft_prefixes(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """non_lora_trainables key normalization (builder.py:106-108): drop
    'base_model.' then a further 'model.' when keys start 'model.model.'."""
    state = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
             for k, v in state.items()}
    if any(k.startswith("model.model.") for k in state):
        state = {(k[len("model."):] if k.startswith("model.") else k): v
                 for k, v in state.items()}
    return state


def load_lora_adapter(path: str) -> tuple[dict[str, np.ndarray], float]:
    """Read a peft adapter dir: (adapter state dict, alpha/r scale)."""
    import json

    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scale = acfg["lora_alpha"] / acfg["r"]
    st = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st):
        from safetensors.numpy import load_file

        return load_file(st), scale
    return _load_torch_bin(os.path.join(path, "adapter_model.bin")), scale


def merge_lora_state(
    state: dict[str, np.ndarray],
    adapter: dict[str, np.ndarray],
    scale: float,
) -> dict[str, np.ndarray]:
    """Merge peft LoRA pairs into the torch-name state dict (the
    merge_and_unload step of builder.py:117-121, done in numpy):
    W <- W + scale * B @ A for each `<module>.lora_{A,B}.weight` pair.
    peft names the target `base_model.model.<module>.lora_A.weight` (with
    an optional '.default' infix); the dense weight is `<module>.weight`.
    """
    out = dict(state)
    for k, a in adapter.items():
        if ".lora_A." not in k:
            continue
        b_key = k.replace(".lora_A.", ".lora_B.")
        if b_key not in adapter:
            raise KeyError(f"unpaired LoRA weight: {k}")
        mod = k.split(".lora_A.")[0]
        for pref in ("base_model.model.", "base_model.", ""):
            if mod.startswith(pref) and mod[len(pref):] + ".weight" in out:
                w_key = mod[len(pref):] + ".weight"
                break
        else:
            raise KeyError(f"no base weight for LoRA module {mod}")
        delta = np.asarray(adapter[b_key], np.float32) @ np.asarray(a, np.float32)
        out[w_key] = (np.asarray(out[w_key], np.float32)
                      + scale * delta).astype(out[w_key].dtype)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "gen_length", "temperature", "remasking",
                     "kv8", "act_int8_prefill"),
)
def _fused_predict(
    params,
    cfg: LaViDaConfig,
    pixel_values: jax.Array,
    text_ids: jax.Array,
    gather_idx: jax.Array,
    k_table: jax.Array,
    block_end: jax.Array,
    key: jax.Array,
    gen_length: int,
    temperature: float,
    remasking: str,
    prefix_valid: Optional[jax.Array] = None,
    kv8: bool = False,
    prefill_llada=None,
    act_int8_prefill: bool = False,
):
    from ..generation.diffusion import _generate_cached_fused_body
    from . import multimodal as mm

    prefix = mm.multimodal_embeds(
        params, cfg, pixel_values, text_ids, gather_idx)
    x = jnp.full((1, gen_length), cfg.llada.mask_token_id, jnp.int32)
    if prefill_llada is not None:
        # mixed-precision serving: int8 weights + A8 prefill,
        # params["llada"] (int4 layout) for the decode scan
        return _generate_cached_fused_body(
            prefill_llada, cfg.llada, x, prefix, k_table, block_end,
            prefix_valid, key, temperature, remasking,
            act_int8_prefill=act_int8_prefill,
            decode_params=params["llada"], kv8=kv8,
        )
    return _generate_cached_fused_body(
        params["llada"], cfg.llada, x, prefix, k_table, block_end,
        prefix_valid, key, temperature, remasking, kv8=kv8,
    )


class LaViDa:
    """config + params + the end-to-end inference paths.

    lm_family: "llada" (default) or "dream" — selects checkpoint naming and
    the sampler used by generate() when given a DreamGenerationConfig.
    """

    def __init__(self, cfg: LaViDaConfig, params: dict,
                 lm_family: str = "llada"):
        self.cfg = cfg
        self.params = params
        self.lm_family = lm_family
        # mixed-precision serving: optional int8 LM tree for the
        # compute-bound prefill (generate_fused uses it when set; the
        # bandwidth-bound decode keeps params["llada"]).  Populate via
        # quantize_params(bits=8) on the host-staged bf16 tree.
        self.prefill_params = None

    @classmethod
    def load(cls, path: str, cfg: Optional[LaViDaConfig] = None,
             dtype=jnp.bfloat16, lm_family: Optional[str] = None,
             base: Optional[str] = None,
             host_staging: bool = False) -> "LaViDa":
        """Load a checkpoint directory.  The reference's three load modes
        (builder.py:62-170) map onto `base`:

          - base=None: full checkpoint (all weights under `path`);
          - base given + `path` holds `mm_projector.bin`: projector-only
            delta — base weights overlaid with the projector tensors
            (builder.py:160-165, the stage-1 pretrain artifact);
          - base given + `path` holds a peft adapter
            (adapter_config.json + adapter_model.*): LoRA checkpoint —
            non_lora_trainables.bin overlaid, LoRA pairs merged into the
            base weights (builder.py:102-121 merge_and_unload).

        `host_staging=True` converts onto the CPU backend instead of the
        default device, so the full-precision tree never occupies device
        memory next to its quantized copy.  Quantize host-side, then call
        `.to_device()`.  (The reference loads through torch CPU then
        `.cuda()`, same idea: builder.py:62-123 device_map handling.)
        """
        if cfg is None or lm_family is None:
            # sniff geometry/family from config.json — the builder's
            # AutoConfig.from_pretrained step (builder.py:128-146); the
            # composed config lives with the delta, not the base, in the
            # projector/LoRA load modes (builder.py:67,128)
            from ..config import config_from_checkpoint

            scfg, sfam = config_from_checkpoint(path)
            cfg = cfg if cfg is not None else scfg
            lm_family = lm_family or sfam or "llada"
        cfg = cfg or LaViDaConfig()
        if base is None:
            state = load_state_shards(path)
        else:
            state = load_state_shards(base)
            proj_bin = os.path.join(path, "mm_projector.bin")
            if os.path.exists(os.path.join(path, "adapter_config.json")):
                nlt = os.path.join(path, "non_lora_trainables.bin")
                if os.path.exists(nlt):
                    state.update(_strip_peft_prefixes(_load_torch_bin(nlt)))
                adapter, scale = load_lora_adapter(path)
                state = merge_lora_state(state, adapter, scale)
            elif os.path.exists(proj_bin):
                state.update(_load_torch_bin(proj_bin))
            else:
                raise FileNotFoundError(
                    f"{path}: expected mm_projector.bin or a peft adapter "
                    f"when base= is given (builder.py:62-170 load modes)"
                )
        import contextlib

        ctx = (jax.default_device(jax.devices("cpu")[0]) if host_staging
               else contextlib.nullcontext())
        with ctx:
            params = convert_lavida_state_dict(state, cfg, dtype, lm_family)
        if host_staging:
            # COMMIT to CPU: arrays created under default_device(cpu) are
            # uncommitted, so any later op on them (e.g. to_fused_layout's
            # concats) would run on the default accelerator and defeat
            # the staging.  device_put pins placement so all pre-quantize
            # math stays host-side.
            params = jax.device_put(params, jax.devices("cpu")[0])
        return cls(cfg, params, lm_family)

    def to_serving_layout(self, quant: str = "int8") -> "LaViDa":
        """Quantize the LM into the serving layout and ship it to the
        device — the sequence every serving CLI runs after
        `load(host_staging=True)`:

          unstack -> block layout (llada.serving_block_layout: int4
          fuses q/k/v and gate/up, token-exact) -> (mixed: int8 prefill
          tree, quantized BEFORE the consuming pass frees the bf16
          kernels) -> consuming int4/int8 quantize -> to_device.

        quant: "int8" (near-lossless default), "int4" (grouped int4
        weights), "mixed" (int8 prefill tree + int4 decode tree),
        "none" (no-op)."""
        if quant == "none":
            return self
        from . import llada as llada_model

        bits = 4 if quant in ("int4", "mixed") else 8
        lp = llada_model.unstack_blocks(self.params["llada"])
        self.params["llada"] = None  # free the stacked tree once unstacked
        lp, lcfg = llada_model.serving_block_layout(lp, self.cfg.llada, bits)
        self.cfg = self.cfg.replace(llada=lcfg)
        if quant == "mixed":
            self.prefill_params = llada_model.quantize_params(lp, bits=8)
        self.params["llada"] = llada_model.quantize_params(
            lp, bits=bits, consume=True)
        del lp
        return self.to_device()

    def shard(self, tp: int = 1, dp: int = 1, fsdp: int = 1,
              mesh=None) -> "LaViDa":
        """Multi-chip bf16 serving: place the params on a (dp, fsdp, tp)
        mesh per parallel/sharding's col/row-paired rules — the SAME
        generate graphs then run GSPMD-sharded, XLA inserting one psum
        per block (token parity: tests/test_sharded_inference.py).

        This is the scale-out alternative to quantization, with zero
        quantization error.  Call on the bf16 stacked tree — the
        quantized/fused serving layouts have custom leaf structures the
        sharding rules do not cover (CLIs enforce quant="none" with tp>1).
        Pairs with load(host_staging=True): each device receives only its
        1/tp shard, so the full bf16 tree never sits in one chip's HBM.
        """
        from ..parallel import make_mesh, shard_params

        if mesh is None:
            # serving uses exactly dp*fsdp*tp chips (a CLI --tp 2 on an
            # 8-chip host must not demand an 8-way factorization)
            mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp,
                             devices=jax.devices()[:dp * fsdp * tp])
        self.params = shard_params(self.params, mesh)
        jax.block_until_ready(jax.tree.leaves(self.params))
        self.mesh = mesh
        return self

    def to_device(self, device=None) -> "LaViDa":
        """Move params to `device` (default: first default-backend device).
        Pairs with `load(host_staging=True)`: quantize host-side first, so
        only the serving layout ever touches device memory.  Leaves
        already on the target are no-ops."""
        device = device or jax.devices()[0]
        self.params = jax.device_put(self.params, device)
        jax.block_until_ready(jax.tree.leaves(self.params))
        if self.prefill_params is not None:
            self.prefill_params = jax.device_put(self.prefill_params,
                                                 device)
            jax.block_until_ready(jax.tree.leaves(self.prefill_params))
        return self

    @classmethod
    def random_init(cls, cfg: LaViDaConfig, seed: int = 0,
                    dtype=jnp.bfloat16) -> "LaViDa":
        params = multimodal.init_params(cfg, jax.random.PRNGKey(seed), dtype)
        return cls(cfg, params)

    @classmethod
    def zero_init(cls, cfg: LaViDaConfig, dtype=jnp.bfloat16,
                  quantized: bool | str = True) -> "LaViDa":
        """Weight-free instantiation for latency smoke runs: allocates the
        exact serving layout without materializing any transient
        full-precision tensors.  quantized: True/"int8" (per-channel
        int8), "int4" (the grouped int4 layout), False/"none" (bf16).
        Zeros materialize in ONE jitted dispatch."""
        quant = {True: "int8", False: "none"}.get(quantized, quantized)

        def build(k):
            p = multimodal.init_params(cfg, k, dtype)
            if quant in ("int8", "int4"):
                p["llada"] = llada_model.quantize_params(
                    llada_model.unstack_blocks(p["llada"]),
                    bits=4 if quant == "int4" else 8)
            return p

        shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
        params = jax.jit(lambda: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes))()
        return cls(cfg, params)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def encode_prompt(
        self,
        input_ids: np.ndarray,
        images: Sequence[np.ndarray] = (),
        image_sizes: Sequence[tuple[int, int]] = (),
        image_features: Optional[Sequence[jax.Array]] = None,
    ) -> jax.Array:
        """One sample: ids with -200 markers + per-image view stacks ->
        spliced prefix embeddings [1, P, D].  `image_features` supplies
        precomputed blocks (e.g. SHIRG's 980-token selection) instead."""
        feats = image_features if image_features is not None else [
            multimodal.encode_image(
                self.params, self.cfg, jnp.asarray(views), size)
            for views, size in zip(images, image_sizes)
        ]
        embeds, _ = multimodal.splice_embeddings(
            self.params, self.cfg, input_ids, feats
        )
        if self.cfg.tokenizer_model_max_length:
            embeds = embeds[: self.cfg.tokenizer_model_max_length]
        return embeds[None]

    def generate(
        self,
        input_ids: np.ndarray,
        images: Sequence[np.ndarray] = (),
        image_sizes: Sequence[tuple[int, int]] = (),
        gen: Optional[GenerationConfig] = None,
        draft_tokens: Optional[np.ndarray] = None,
        key: Optional[jax.Array] = None,
        image_features: Optional[Sequence[jax.Array]] = None,
        prefix_bucket: Optional[int] = None,
        kv8: bool = False,
        tokens_hook=None,
        logits_hook=None,
    ) -> np.ndarray:
        """predict.py-equivalent single-sample generation. Returns [G] ids.

        tokens_hook/logits_hook: Dream-sampler extension callables
        (generation_utils.py:308-309) — forwarded to dream_generate; only
        valid with a DreamGenerationConfig.

        prefix_bucket: pad the prefix length up to a multiple of this value
        (masked via prefix_valid) so eval sweeps with varying prompt
        lengths reuse a handful of compiled executables instead of
        recompiling per length.  The reference never needs this because
        torch is eager; under jit it is what makes large eval runs cheap.
        """
        gen = gen or GenerationConfig()
        prefix = self.encode_prompt(
            input_ids, images, image_sizes, image_features
        )
        prefix_valid = None
        if prefix_bucket:
            P = prefix.shape[1]
            Pb = -(-P // prefix_bucket) * prefix_bucket
            if Pb > P:
                # pad at the FRONT so gen positions stay contiguous with
                # the real prefix tail (RoPE positions shift uniformly,
                # which the bidirectional model is invariant to only via
                # masking — hence pad positions are masked out entirely)
                pad = jnp.zeros((1, Pb - P, prefix.shape[-1]), prefix.dtype)
                prefix = jnp.concatenate([pad, prefix], axis=1)
                prefix_valid = jnp.concatenate(
                    [jnp.zeros((1, Pb - P), bool), jnp.ones((1, P), bool)],
                    axis=1,
                )
        if isinstance(gen, DreamGenerationConfig):
            assert prefix_valid is None, (
                "prefix bucketing for the Dream sampler is not wired yet"
            )
            mixed = (self.prefill_params is not None
                     and tokens_hook is None and logits_hook is None)
            out = dream_generate(
                self.params["llada"], self.cfg.llada, prefix, gen,
                key=key,
                tokens_hook=tokens_hook, logits_hook=logits_hook,
                prefill_params=self.prefill_params if mixed else None,
                act_int8_prefill=mixed,
            )
            return np.asarray(out)[0]
        assert tokens_hook is None and logits_hook is None, (
            "generation hooks are a Dream-sampler surface "
            "(generation_utils.py:308-309); the LLaDA sampler has none "
            "in the reference either")
        mixed = self.prefill_params is not None
        out = diffusion.generate(
            self.prefill_params if mixed else self.params["llada"],
            self.cfg.llada, prefix, gen,
            draft_tokens=(
                jnp.asarray(draft_tokens)[None]
                if draft_tokens is not None else None
            ),
            prefix_valid=prefix_valid,
            key=key, kv8=kv8,
            act_int8_prefill=mixed,
            decode_params=self.params["llada"] if mixed else None,
        )
        return np.asarray(out)[0]

    def generate_fused(
        self,
        input_ids: np.ndarray,
        images: Sequence[np.ndarray] = (),
        image_sizes: Sequence[tuple[int, int]] = (),
        gen: Optional[GenerationConfig] = None,
        key: Optional[jax.Array] = None,
        prefix_bucket: Optional[int] = None,
        kv8: bool = False,
    ) -> np.ndarray:
        """Single-executable inference: vision encode + gather-splice +
        prefill + denoise scan all in one dispatch (the serving hot path —
        eliminates per-executable transport/dispatch overhead).

        prefix_bucket: front-pad the splice plan to a multiple of this
        length (masked via prefix_valid) so varying prompt lengths reuse
        O(1) compiled executables — same contract as generate()."""
        import jax.numpy as jnp

        from ..generation.diffusion import build_control_table
        from . import multimodal as mm

        gen = gen or GenerationConfig()
        assert gen.prefix_lm, "fused path implements the prefix-cache mode"
        n_views = [[v.shape[0] for v in images]] if images else [[]]
        gather_idx, text_ids, valid, _ = mm.build_gather_plan(
            self.cfg, [np.asarray(input_ids)], n_views,
            [list(image_sizes)],
        )
        prefix_valid = None
        if prefix_bucket:
            P = gather_idx.shape[1]
            Pb = -(-P // prefix_bucket) * prefix_bucket
            if Pb > P:
                gather_idx, text_ids, valid, _ = mm.build_gather_plan(
                    self.cfg, [np.asarray(input_ids)], n_views,
                    [list(image_sizes)], pad_to=Pb, pad_front=True,
                )
                prefix_valid = jnp.asarray(valid)
        G = gen.max_new_tokens
        x0 = np.full((1, G), self.cfg.llada.mask_token_id, np.int64)
        k_table, block_end = build_control_table(
            x0, 0, G, gen, self.cfg.llada.mask_token_id
        )
        pix = (
            jnp.concatenate([jnp.asarray(v) for v in images], axis=0)
            if images else jnp.zeros(
                (0, 3, self.cfg.vision.siglip.image_size,
                 self.cfg.vision.siglip.image_size), jnp.bfloat16,
            )
        )
        out = _fused_predict(
            self.params, self.cfg, pix, jnp.asarray(text_ids),
            jnp.asarray(gather_idx), jnp.asarray(k_table),
            jnp.asarray(block_end),
            key if key is not None else jax.random.PRNGKey(0),
            gen_length=G, temperature=gen.temperature,
            remasking=gen.remasking, prefix_valid=prefix_valid,
            kv8=kv8,
            prefill_llada=self.prefill_params,
            act_int8_prefill=self.prefill_params is not None,
        )
        return np.asarray(out)[0]

    def decode_output(
        self, ids: np.ndarray, tokenizer,
        stop_ids: Optional[Sequence[int]] = None,
    ) -> str:
        """Cut at eos / conversation stop ids and decode (predict.py:85
        batch_decode + the conv template's stop_token_ids, e.g. 126348 for
        llada, conversation.py:474)."""
        ids = list(np.asarray(ids))
        stops = {self.cfg.llada.eos_token_id, *(stop_ids or ())}
        cut = len(ids)
        for s in stops:
            if s in ids:
                cut = min(cut, ids.index(s))
        return tokenizer.decode(ids[:cut], skip_special_tokens=True).strip()
