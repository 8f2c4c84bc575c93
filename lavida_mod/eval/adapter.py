"""LaViDa eval-model adapter — the analogue of the reference lmms-eval model
classes (eval/lmms_eval/models/llava_llada.py:98-881, llava_dream.py).

Handles: conversation-template prompt building, anyres image processing,
gen_kwargs plumbing (incl. the reference's `schedule__*` -> schedule kwargs
convention, :598-604), block_length default min(128, max_new_tokens) (:606),
per-sample latency tracking (:646-649 — the published s/image metric), and
loglikelihood via the MC estimator (mc_num=16, :277-409).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..config import DreamGenerationConfig, GenerationConfig
from ..data import SigLIPImageProcessor, process_images
from ..data.conversation import get_conv_template
from ..data.prompts import tokenizer_image_token
from ..generation.log_likelihood import get_log_likelihood
from ..models.lavida import LaViDa


def gen_kwargs_to_config(gen_kwargs: dict, lm_family: str = "llada"):
    """Map lmms-eval-style gen_kwargs onto our config dataclasses."""
    kw = dict(gen_kwargs)
    schedule_kwargs = {
        k[len("schedule__"):]: kw.pop(k)
        for k in list(kw) if k.startswith("schedule__")
    }
    max_new = int(kw.pop("max_new_tokens", 32))
    common = dict(
        max_new_tokens=max_new,
        schedule=kw.pop("schedule", None),
        schedule_shift=float(schedule_kwargs.get("shift", 3.0)),
        step_ratio=kw.pop("step_ratio", None),
        prefix_lm=bool(kw.pop("prefix_lm", True)),
        temperature=float(kw.pop("temperature", 0.0) or 0.0),
    )
    if lm_family == "dream":
        return DreamGenerationConfig(
            steps=int(kw.pop("steps", 512)),
            alg=kw.pop("alg", "topk_margin"),
            alg_temp=kw.pop("alg_temp", None),
            top_p=kw.pop("top_p", None),
            top_k=kw.pop("top_k", None),
            **common,
        )
    block_length = int(
        kw.pop("block_length", min(128, max_new))
    )
    return GenerationConfig(
        block_length=block_length,
        steps=kw.pop("steps", None),
        step_per_block=kw.pop("step_per_block", None),
        remasking=kw.pop("remasking", "low_confidence"),
        **common,
    )


class LavidaEvalModel:
    """generate_until / loglikelihood over (doc, task) requests."""

    def __init__(
        self,
        model: LaViDa,
        tokenizer,
        conv_template: str = "llada",
        mc_num: int = 16,
        prefix_bucket: Optional[int] = 128,
        kv8: bool = False,
        loglik_act_int8: bool = False,
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.conv_template = conv_template
        self.mc_num = mc_num
        # W8A8 linears for the MC estimator's forwards — opt-in, the
        # ~0.2-0.5% activation-quant logit error can flip close
        # multiple-choice rankings
        self.loglik_act_int8 = loglik_act_int8
        # pad prompt lengths to buckets so a task sweep compiles O(1)
        # executables instead of one per prompt length
        self.prefix_bucket = prefix_bucket
        # int8 KV cache + decode attention over it (GQA-native; see
        # ops/kv8_attention.py) — the bench --kv8 serving configuration
        self.kv8 = kv8
        self.processor = SigLIPImageProcessor(
            size=model.cfg.vision.siglip.image_size
        )
        self.latencies: list[float] = []
        # opt-in per-batch stage instrumentation for generate_until_batch:
        # set to [] to collect (B, encode_s, generate_s, detok_s) tuples
        # (adds sync points — leave None in production)
        self.stage_walls: Optional[list] = None

    # ------------------------------------------------------------------

    def _build_inputs(self, text: str, images: Sequence):
        conv = get_conv_template(self.conv_template)
        if self.tokenizer is not None and getattr(
            self.tokenizer, "chat_template", None
        ):
            conv.tokenizer = self.tokenizer
        msg = ("<image>\n" * len(images)) + text if images else text
        conv.append_message(conv.roles[0], msg)
        prompt = conv.get_prompt()
        input_ids = tokenizer_image_token(prompt, self.tokenizer)
        model = self.model
        if len(images) > 1:
            # reference multi-image setting forces "pad" (eval adapter
            # llava_llada.py / llava_dream.py:289: anyres tiling per image
            # would explode the context).  The facade swap keeps the
            # processing and encode paths consistent.
            model = LaViDa(
                self.model.cfg.replace(
                    vision=self.model.cfg.vision.replace(
                        image_aspect_ratio="pad"
                    )
                ),
                self.model.params, self.model.lm_family,
            )
        views = process_images(list(images), self.processor,
                               model.cfg.vision)
        sizes = [im.size for im in images]
        return input_ids, views, sizes, model

    def generate_until(self, text: str, images: Sequence,
                       gen_kwargs: Optional[dict] = None,
                       video: bool = False) -> str:
        gen = gen_kwargs_to_config(
            gen_kwargs or {}, self.model.lm_family
        )
        if video and images:
            return self._generate_video(text, images, gen)
        input_ids, views, sizes, model = self._build_inputs(text, images)
        t0 = time.perf_counter()
        if not isinstance(gen, DreamGenerationConfig) and gen.prefix_lm:
            # single-dispatch serving path (vision+splice+prefill+denoise
            # in one executable; eager merge/splice each cost a device
            # round-trip);
            # token-exact vs generate() (tests/test_bucketing.py)
            out = model.generate_fused(
                input_ids, views, sizes, gen,
                prefix_bucket=self.prefix_bucket, kv8=self.kv8,
            )
        else:
            out = model.generate(
                input_ids, views, sizes, gen,
                prefix_bucket=(
                    self.prefix_bucket
                    if not isinstance(gen, DreamGenerationConfig) else None
                ),
            )
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        from ..data.conversation import get_conv_template

        stop_ids = get_conv_template(self.conv_template).stop_token_ids
        return model.decode_output(out, self.tokenizer, stop_ids)

    def _generate_video(self, text: str, frames: Sequence, gen) -> str:
        """Video request: all frames behind ONE <image> placeholder,
        encoded by the video path (per-frame encode + 2x2 pool, frames
        flattened, one newline token — multimodal.encode_video,
        llava_arch.py:600-610).  The reference eval model does the same
        for "video" modality visuals (llava_llada.py:327-345) instead of
        the multi-image pad mode."""
        import jax.numpy as jnp

        from ..models import multimodal

        conv = get_conv_template(self.conv_template)
        if self.tokenizer is not None and getattr(
            self.tokenizer, "chat_template", None
        ):
            conv.tokenizer = self.tokenizer
        conv.append_message(conv.roles[0], "<image>\n" + text)
        input_ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)

        # frames are plain square views (no anyres tiling per frame)
        pad_cfg = self.model.cfg.vision.replace(image_aspect_ratio="pad")
        views = np.concatenate(
            process_images(list(frames), self.processor, pad_cfg), axis=0)
        block = multimodal.encode_video(
            self.model.params, self.model.cfg, jnp.asarray(views))
        t0 = time.perf_counter()
        out = self.model.generate(
            input_ids, gen=gen, image_features=[block],
            prefix_bucket=(self.prefix_bucket
                           if not isinstance(gen, DreamGenerationConfig)
                           else None),
            kv8=self.kv8,
        )
        self.latencies.append(time.perf_counter() - t0)
        stop_ids = get_conv_template(self.conv_template).stop_token_ids
        return self.model.decode_output(out, self.tokenizer, stop_ids)

    def loglikelihood(self, text: str, images: Sequence,
                      continuation: str) -> float:
        if self.model.lm_family == "dream":
            # reference parity: Dream's AR-shifted head has no MC estimator
            # (llava_dream.py:366-376 raises NotImplementedError); the
            # LLaDA estimator would silently mis-score shifted logits
            raise NotImplementedError(
                "loglikelihood is not supported for the Dream backbone"
            )
        input_ids, views, sizes, model = self._build_inputs(text, images)
        prefix = model.encode_prompt(input_ids, views, sizes)
        ans = self.tokenizer(continuation).input_ids
        ans = np.asarray(ans[:300])  # llava_llada.py:322 answer truncation
        # MC estimation is mc_num full non-causal forwards per doc
        # (llava_llada.py:277-409) — a compute-bound prefill-shaped
        # workload, so under mixed serving it rides the int8 prefill tree
        # (int8 GEMMs), not the bandwidth-optimized int4 decode tree
        lm = self.model.prefill_params or self.model.params["llada"]
        return get_log_likelihood(
            lm, self.model.cfg.llada, prefix, ans,
            mc_num=self.mc_num, act_int8=self.loglik_act_int8,
        )

    def generate_until_batch(
        self,
        texts: Sequence[str],
        images_list: Sequence[Sequence],
        gen_kwargs: Optional[dict] = None,
    ) -> list[str]:
        """Batched decoding: prefixes bucket-padded to a common length and
        generated in ONE fused dispatch — decode is weight-bandwidth-bound,
        so batch B costs ~the same weight reads as one sample.  The
        throughput analogue of the
        reference's 8-way accelerate DP eval."""
        import jax
        import jax.numpy as jnp

        from ..generation import diffusion

        gen = gen_kwargs_to_config(gen_kwargs or {}, self.model.lm_family)
        assert not isinstance(gen, DreamGenerationConfig), (
            "batched path implements the LLaDA sampler"
        )
        t0 = time.perf_counter()
        prefixes = []
        for text, images in zip(texts, images_list):
            ids, views, sizes, model = self._build_inputs(text, images)
            prefixes.append(
                model.encode_prompt(ids, views, sizes)[0]
            )
        if self.stage_walls is not None:
            # opt-in instrumentation: the sync point stalls the
            # dispatch pipeline, so it only exists when someone is
            # reading the split
            jax.block_until_ready(prefixes)
        t_enc = time.perf_counter()
        bucket = self.prefix_bucket or 128
        Pb = max(-(-p.shape[0] // bucket) * bucket for p in prefixes)
        B = len(prefixes)
        D = prefixes[0].shape[-1]
        batch = jnp.zeros((B, Pb, D), prefixes[0].dtype)
        valid = np.zeros((B, Pb), bool)
        for b, p in enumerate(prefixes):
            n = p.shape[0]
            batch = batch.at[b, Pb - n:].set(p)   # front-pad (masked)
            valid[b, Pb - n:] = True
        mixed = getattr(self.model, "prefill_params", None) is not None
        if mixed and not gen.prefix_lm:
            # loud, not silent (repo flag convention): the mixed split
            # IS a prefill/decode split — no-cache generation has
            # neither, and falling through would serve plain int4 while
            # the operator believes --mixed is active
            raise NotImplementedError(
                "mixed decode_params needs the prefix-cache mode "
                "(prefix_lm=True) — the no-cache path has no "
                "prefill/decode split; drop --mixed or prefix_lm=False")
        if B > 4 and gen.prefix_lm:
            # large batches prefill in 2-row chunks (one compile, peak
            # prefill activations bounded by the chunk), then decode the
            # merged batch.
            out = diffusion.generate_chunked_prefill(
                self.model.params["llada"], self.model.cfg.llada, batch,
                gen, chunk=2, prefix_valid=jnp.asarray(valid),
                kv8=self.kv8,
                prefill_params=(self.model.prefill_params
                                if mixed else None),
                act_int8_prefill=mixed,
            )
        elif mixed and gen.prefix_lm:
            # mixed serving split (worker --mixed): int8 tree + A8
            # for the compute-bound prefill, int4 tree for the decode
            out = diffusion.generate(
                self.model.prefill_params, self.model.cfg.llada, batch,
                gen, prefix_valid=jnp.asarray(valid), kv8=self.kv8,
                act_int8_prefill=True,
                decode_params=self.model.params["llada"],
            )
        else:
            out = diffusion.generate(
                self.model.params["llada"], self.model.cfg.llada, batch,
                gen, prefix_valid=jnp.asarray(valid), kv8=self.kv8,
            )
        if self.stage_walls is not None:
            jax.block_until_ready(out)
        t_gen = time.perf_counter()
        res = [
            self.model.decode_output(np.asarray(out)[b], self.tokenizer)
            for b in range(B)
        ]
        dt = time.perf_counter() - t0
        self.latencies.extend([dt / B] * B)
        if self.stage_walls is not None:
            self.stage_walls.append(
                (B, round(t_enc - t0, 4), round(t_gen - t_enc, 4),
                 round(time.perf_counter() - t_gen, 4)))
        return res

    @property
    def avg_latency(self) -> float:
        return float(np.mean(self.latencies)) if self.latencies else 0.0
