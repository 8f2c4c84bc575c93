#!/usr/bin/env python
"""On-card smoke test of LaViDa-LLaDA 8B serving, in one process.

    python chip_smoke.py           # one GPU: ops, gpu tests, 8B serving
    python chip_smoke.py --four    # four GPUs: sharded stage-2 training only

One card: each translated op against a float32 jax.numpy reference, the
`gpu`-marked tests, then the LaViDa-LLaDA 8B model (d 4096, 32 layers,
SigLIP so400m, mlp2x projector) with seeded random weights serving
requests through `LaViDa.generate` (HD anyres 640x640 -> 5 views, gen 32,
16 steps, prefix cache) in the bf16 layout and in the int4 serving layout:
three B=1 requests and one B=4 batch as the eval adapter sends it.  The
prefill logits of each layout are compared with the plain f32 reference
(models/reference.py) on the same weights.

--four: stage-2 multimodal training (make_multimodal_train_step) under
(dp, fsdp, tp) = (1, 4, 1) and (1, 2, 2) meshes vs the same steps on one
card at full widths and reduced depth, then two steps of the full-depth
8B model under fsdp=4 with f32 master weights.

Weights come from --seed, images are seeded pixel views and ids are
synthetic: nothing is read from outside the repo.  Without a GPU it
exits non-zero before any phase.  A failed phase makes the run fail.
The last line is one JSON object: {"ok": ..., "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

TOL = {
    # bf16 operands, f32 accumulation: rounding of inputs, p and output
    "bf16": 3e-2,
    # int8 weights are decoded exactly to bf16; the error is bf16
    # rounding of x and of the product, vs an f32 x @ dequant(W)
    "int8": 2e-2,
    # int4 values are exact in bf16, the group scale product rounds once
    "int4": 2e-2,
    # W8A8: integer products and sums are exact; only f32 scaling and
    # the f32 accumulation order differ from the f32 reference of the
    # same quantized operands
    "w8a8": 1e-4,
    # kv8/kv4: cache decoded exactly in bf16; q and p round to bf16
    "kv": 3e-2,
    # 8B prefill logits, bf16 layout vs the f32 reference: bf16
    # activations through 32 layers
    "logits": 5e-2,
}


def rel_err(a, b):
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def report(name, err, tol):
    ok = err <= tol
    print(f"  {name:48s} max rel err {err:.3e}  tol {tol:.0e}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


# (name, B, T, S, Hq, Hkv, hd, key-padding mask)
ATTENTION_CASES = [
    ("attention LLaDA prefill T=S=1029 H32 hd128", 1, 1029, 1029, 32, 32,
     128, False),
    ("attention decode T=32 S=1061 H32 hd128 (mask)", 1, 32, 1061, 32, 32,
     128, True),
    ("attention Dream GQA 28/4 T=S=1029 hd128", 1, 1029, 1029, 28, 4, 128,
     False),
    ("attention SigLIP 5x729 H16 hd72", 5, 729, 729, 16, 16, 72, False),
    ("attention long T=S=8192 H32 hd128", 1, 8192, 8192, 32, 32, 128, False),
]
# LLaDA-8B linears (K, N): attention, MLP in/out, the vocab head
LINEAR_SHAPES = [(4096, 4096), (4096, 12288), (12288, 4096), (4096, 126464)]
# decode rows over the prefix cache: (T, S, H, hd)
KV_SHAPE = (32, 1061, 32, 128)


def phase_ops(seed, attention_cases=ATTENTION_CASES,
              linear_shapes=LINEAR_SHAPES, kv_shape=KV_SHAPE):
    """Each translated op at the serving shapes vs an f32 reference."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.ops import attention as A
    from lavida_mod.ops import kv8_attention as KV
    from lavida_mod.ops.quant import (dequantize_w4, linear,
                                      linear_act_int8, quantize_linear,
                                      quantize_linear4)

    key = jax.random.PRNGKey(seed)
    ok = True

    def qkv(B, T, S, Hq, Hkv, hd, k):
        ks = jax.random.split(k, 3)
        return (jax.random.normal(ks[0], (B, T, Hq, hd)),
                jax.random.normal(ks[1], (B, S, Hkv, hd)),
                jax.random.normal(ks[2], (B, S, Hkv, hd)))

    for i, (name, B, T, S, Hq, Hkv, hd, masked) in enumerate(
            attention_cases):
        q, k, v = qkv(B, T, S, Hq, Hkv, hd, jax.random.fold_in(key, i))
        mask = None
        if masked:
            mask = A.make_mask(kv_valid=jnp.arange(S)[None] >= 7)
        bf = [x.astype(jnp.bfloat16) for x in (q, k, v)]
        out = A.attention(*bf, mask)
        impl = A.attention_impl(bf[0], S, mask is not None)
        with jax.default_matmul_precision("highest"):
            ref = A.dense_attention(
                *[x.astype(jnp.float32) for x in bf],
                bias=A.mask_to_bias(mask))
        ok &= report(f"{name} [{impl}]", rel_err(out, ref), TOL["bf16"])
        del q, k, v, bf, out, ref

    for j, (K, N) in enumerate(linear_shapes):
        kw, kx = jax.random.split(jax.random.fold_in(key, 100 + j))
        w = jax.random.normal(kw, (K, N)) * 0.02
        for M, form in ((32, "int8"), (32, "int4"), (1029, "w8a8")):
            x = jax.random.normal(kx, (M, K))
            if form == "int4":
                p = quantize_linear4({"kernel": w})
                wd = dequantize_w4(p)
            else:
                p = quantize_linear({"kernel": w})
                wd = p["kernel_q"].astype(jnp.float32) * p["scale"]
            if form == "w8a8":
                y = linear_act_int8(x.astype(jnp.bfloat16), p,
                                    preferred=jnp.float32)
                # the activations the op quantizes are the bf16 ones
                xb = x.astype(jnp.bfloat16).astype(jnp.float32)
                sx = jnp.maximum(jnp.abs(xb).max(-1, keepdims=True) / 127.0,
                                 1e-8)
                xr = jnp.clip(jnp.round(xb / sx), -127, 127) * sx
            else:
                xr = x.astype(jnp.bfloat16).astype(jnp.float32)
                y = linear(x.astype(jnp.bfloat16), p, preferred=jnp.float32)
            with jax.default_matmul_precision("highest"):
                ref = xr @ wd
            ok &= report(f"linear {form} M={M} {K}x{N}", rel_err(y, ref),
                         TOL[form])
            del p, wd, y, ref
        del w

    T, S, H, hd = kv_shape
    for bits in (8, 4):
        q, k, v = qkv(1, T, S, H, H, hd, jax.random.fold_in(key, 7))
        k8, ks = KV.quantize_kv(k, bits)
        v8, vs = KV.quantize_kv(v, bits)
        valid = jnp.arange(S)[None] >= 7
        out = KV.kv8_decode_attention(q.astype(jnp.bfloat16), k8, ks, v8, vs,
                                      kv_valid=valid)
        with jax.default_matmul_precision("highest"):
            ref = A.dense_attention(
                q.astype(jnp.bfloat16).astype(jnp.float32),
                KV.dequantize_kv(k8, ks), KV.dequantize_kv(v8, vs),
                bias=A.mask_to_bias(A.make_mask(kv_valid=valid)))
        ok &= report(f"kv{bits} decode attention T={T} S={S} H{H}",
                     rel_err(out, ref), TOL["kv"])
    return ok


def phase_gpu_tests():
    """The `gpu`-marked tests, in this process (it holds the card)."""
    import glob

    import pytest

    class Tally:
        passed = 0
        not_passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.not_passed += 1

    files = [f for f in sorted(glob.glob("tests/test_*.py"))
             if "pytest.mark.gpu" in open(f).read()]
    tally = Tally()
    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          *files], plugins=[tally])
    finally:
        # tests/conftest.py pins JAX_PLATFORMS for the CPU suite
        os.environ.clear()
        os.environ.update(env)
    print(f"  pytest -m gpu {' '.join(files)}: exit {int(rc)}, "
          f"{tally.passed} passed, {tally.not_passed} failed or skipped",
          flush=True)
    return int(rc) == 0 and tally.passed > 0 and tally.not_passed == 0


def _requests(cfg, seed, size):
    """Seeded HD anyres requests: (ids, views, size) with prompt lengths
    48/56/64 (B=1) and a B=4 batch of 48..60."""
    import numpy as np

    from lavida_mod.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    S = cfg.vision.siglip.image_size
    hi = min(30000, cfg.llada.vocab_size - 100)     # clear of special ids

    def one(n_text):
        text = rng.integers(3, hi, size=n_text)
        ids = np.concatenate([text[:8], [IMAGE_TOKEN_INDEX], text[8:]])
        views = rng.uniform(-1, 1, size=(5, 3, S, S)).astype(np.float32)
        return ids, views, size

    return [one(n) for n in (48, 56, 64)], [one(n) for n in (48, 52, 56, 60)]


def _serve(model, cfg, reqs, batch, layout, seed):
    """Answer the requests through LaViDa.generate / the adapter's batched
    diffusion.generate; compare the prefill logits with the reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lavida_mod.config import GenerationConfig
    from lavida_mod.generation import diffusion
    from lavida_mod.models import llada as llada_model
    from lavida_mod.models.reference import llada_logits

    ok = True
    gen = GenerationConfig(max_new_tokens=32, block_length=32, steps=None,
                           step_per_block=16, prefix_lm=True,
                           remasking="low_confidence")
    mask_id = cfg.llada.mask_token_id
    dev = jax.devices()[0]
    bucket = 128

    for i, (ids, views, size) in enumerate(reqs):
        t0 = time.perf_counter()
        out = model.generate(ids, [views], [size], gen,
                             key=jax.random.PRNGKey(seed + i),
                             prefix_bucket=bucket)
        wall = time.perf_counter() - t0
        left = int((out == mask_id).sum())
        ok &= left == 0 and out.shape == (32,)
        print(f"  {layout} request {i} (B=1, {len(ids)} ids): "
              f"{'compile+run' if i == 0 else 'run'} {wall:.3f} s, "
              f"mask tokens left {left}", flush=True)

    # B=4 as eval/adapter.generate_until_batch sends it: prefixes front-
    # padded to a common bucket, masked by prefix_valid, one dispatch
    prefixes = [model.encode_prompt(ids, [views], [size])[0]
                for ids, views, size in batch]
    Pb = max(-(-p.shape[0] // bucket) * bucket for p in prefixes)
    padded = jnp.stack([jnp.pad(p, ((Pb - p.shape[0], 0), (0, 0)))
                        for p in prefixes])
    valid = jnp.asarray(np.stack([np.arange(Pb) >= Pb - p.shape[0]
                                  for p in prefixes]))
    for rep in range(2):
        t0 = time.perf_counter()
        out = np.asarray(diffusion.generate(
            model.params["llada"], model.cfg.llada, padded, gen,
            prefix_valid=valid, key=jax.random.PRNGKey(seed + 10)))
        wall = time.perf_counter() - t0
        left = int((out == mask_id).sum())
        ok &= left == 0 and out.shape == (4, 32)
        print(f"  {layout} batch B=4 (P={Pb}): "
              f"{'compile+run' if rep == 0 else 'run'} {wall:.3f} s, "
              f"mask tokens left {left}", flush=True)

    ids, views, size = reqs[0]
    prefix = model.encode_prompt(ids, [views], [size])
    fwd = jax.jit(lambda p, e: llada_model.forward(p, model.cfg.llada, e)[0])
    got = fwd(model.params["llada"], prefix)
    ref = llada_logits(model.params["llada"], model.cfg.llada, prefix)
    agree = float((jnp.argmax(got, -1) == jnp.argmax(ref, -1)).mean())
    ok &= report(f"{layout} prefill logits P={prefix.shape[1]} vs f32 "
                 f"reference ({model.cfg.llada.n_layers} layers)",
                 rel_err(got, ref), TOL["logits"])
    print(f"  {layout} prefill argmax agreement {agree:.4f}", flush=True)
    stats = dev.memory_stats() or {}
    print(f"  {layout} peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)
    return ok


def phase_serving(seed, cfg=None, size=(640, 640)):
    """cfg None = LaViDa-LLaDA 8B + SigLIP so400m; a 640x640 image is the
    base view + 2x2 tiles at the 768x768 pinpoint (5 views)."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import LaViDaConfig
    from lavida_mod.models.lavida import LaViDa

    cfg = cfg or LaViDaConfig()
    reqs, batch = _requests(cfg, seed, size)
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, seed, jnp.bfloat16)
    jax.block_until_ready(jax.tree.leaves(model.params))
    n = sum(x.size for x in jax.tree.leaves(model.params))
    print(f"  random init {n / 1e9:.3f}B params (bf16): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok = _serve(model, cfg, reqs, batch, "bf16", seed)

    t0 = time.perf_counter()
    model.to_serving_layout(quant="int4")
    jax.block_until_ready(jax.tree.leaves(model.params))
    print(f"  int4 serving layout (fused q/k/v, gate/up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok &= _serve(model, cfg, reqs, batch, "int4", seed)
    return ok


def _mm_batch(cfg, B, T, seed):
    """Stage-2 shaped rows: one 384px view + text per row, padded to T."""
    import numpy as np

    from lavida_mod.constants import IMAGE_TOKEN_INDEX
    from lavida_mod.models import multimodal as mm

    rng = np.random.default_rng(seed)
    sp = cfg.vision.siglip
    g = -(-sp.num_patches_per_side // cfg.vision.spatial_pool_stride)
    n_text = T - (g * g + 1)
    hi = min(30000, cfg.llada.vocab_size - 100)     # clear of special ids
    ids, labs = [], []
    for _ in range(B):
        row = rng.integers(3, hi, n_text).astype(np.int64)
        row[1] = IMAGE_TOKEN_INDEX
        lab = row.copy()
        lab[: n_text // 4] = -100
        ids.append(row)
        labs.append(lab)
    gather_idx, text_ids, _, labels = mm.build_gather_plan(
        cfg, ids, [[1]] * B, [[(384, 384)]] * B, labs, pad_to=T)
    pix = rng.standard_normal((B, 3, sp.image_size, sp.image_size))
    return {"pixel_values": pix.astype(np.float32), "text_ids": text_ids,
            "gather_idx": gather_idx, "labels": labels}


def _train_steps(cfg, mesh, params_fn, batch, steps, compute_dtype):
    """Run `steps` train steps; returns [(loss, grad_norm)] and peaks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lavida_mod.parallel.sharding import param_shardings
    from lavida_mod.train.step import (jit_train_step, make_optimizer,
                                       make_multimodal_train_step)

    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(params_fn, key)
    if mesh is None:
        params = jax.jit(params_fn)(key)
        put = jnp.asarray
    else:
        params = jax.jit(params_fn,
                         out_shardings=param_shardings(shapes, mesh))(key)
        axes = ("dp", "fsdp")

        def put(x):
            spec = P(axes, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
    opt = make_optimizer(lr=1e-5, total_steps=10)
    opt_state = opt.init(params)     # eager: each state follows its param
    step = jit_train_step(make_multimodal_train_step(
        cfg, opt, prefix_lm=True, remat=True, mesh=mesh,
        compute_dtype=compute_dtype))
    b = {k: put(v) for k, v in batch.items()}
    out = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b,
                                    jax.random.PRNGKey(7 + i))
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        out.append((loss, gn, time.perf_counter() - t0))
    del params, opt_state
    return out


def phase_four(seed, full=None, T=512):
    """full None = LaViDa-LLaDA 8B + SigLIP so400m; the parity runs keep
    its widths at 2 LLaDA layers and 3 SigLIP layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lavida_mod.config import LaViDaConfig
    from lavida_mod.models import multimodal as mm
    from lavida_mod.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 4, jax.devices()
    ok = True
    B = 4
    full = full or LaViDaConfig()
    small = full.replace(
        llada=full.llada.replace(n_layers=2),
        vision=full.vision.replace(siglip=full.vision.siglip.replace(
            num_hidden_layers=3)))
    batch = _mm_batch(small, B, T, seed)

    def f32_init(cfg):
        return lambda k: mm.init_params(cfg, k, jnp.float32)

    print(f"  reduced depth (LLaDA {small.llada.n_layers} layers, SigLIP "
          f"{small.vision.siglip.n_layers_used} of "
          f"{small.vision.siglip.num_hidden_layers} layers), full widths; "
          f"f32, matmul precision 'highest'", flush=True)
    # only the order of sums differs between one card and a mesh
    tol = 1e-3
    with jax.default_matmul_precision("highest"):
        one = _train_steps(small, None, f32_init(small), batch, 2, None)
        for shape in ((1, 4, 1), (1, 2, 2)):
            mesh = make_mesh(*shape, devices=jax.devices()[:4])
            got = _train_steps(small, mesh, f32_init(small), batch, 2, None)
            for s, ((l1, g1, _), (l2, g2, w)) in enumerate(zip(one, got)):
                el = abs(l2 - l1) / abs(l1)
                eg = abs(g2 - g1) / abs(g1)
                good = el <= tol and eg <= tol and np.isfinite([l2, g2]).all()
                ok &= bool(good)
                print(f"  mesh {shape} step {s}: loss {l2:.6f} (1 card "
                      f"{l1:.6f}, rel {el:.1e})  grad_norm {g2:.6f} (1 card "
                      f"{g1:.6f}, rel {eg:.1e})  tol {tol:.0e}  "
                      f"{'ok' if good else 'FAIL'}", flush=True)

    print(f"  full depth ({full.llada.n_layers} LLaDA layers, "
          f"{full.vision.siglip.n_layers_used} SigLIP layers), fsdp=4, f32 "
          f"master weights + bf16 compute", flush=True)
    mesh = make_mesh(1, 4, 1, devices=jax.devices()[:4])
    batch = _mm_batch(full, B, T, seed)
    res = _train_steps(full, mesh, f32_init(full), batch, 2, jnp.bfloat16)
    for s, (loss, gn, wall) in enumerate(res):
        good = bool(np.isfinite([loss, gn]).all())
        ok &= good
        print(f"  step {s}: loss {loss:.6f} grad_norm {gn:.6f} wall "
              f"{wall:.2f} s {'ok' if good else 'FAIL'}", flush=True)
    for d in jax.devices()[:4]:
        print(f"  {d}: peak_bytes_in_use "
              f"{(d.memory_stats() or {}).get('peak_bytes_in_use')}",
              flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="sharded stage-2 training on four GPUs only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        from lavida_mod.utils import device
        from lavida_mod.utils.compile_cache import enable as enable_cache
    except ImportError as e:
        sys.exit(f"chip_smoke: cannot import the program ({e}); run it "
                 f"from the root of the repository")
    info = device.describe()          # exits non-zero without a GPU
    enable_cache()
    import jax

    print(f"platform {info['platform']}  device_kind {info['kind']}  "
          f"count {info['count']}", flush=True)
    print(f"jax {info['jax']}  XLA_FLAGS {info['xla_flags']!r}  "
          f"compile cache {jax.config.jax_compilation_cache_dir}",
          flush=True)
    print(info["card"], flush=True)

    phases = ([("four-card stage-2 training", lambda: phase_four(args.seed))]
              if args.four else
              [("ops vs f32 reference", lambda: phase_ops(args.seed)),
               ("gpu-marked tests", phase_gpu_tests),
               ("LaViDa-LLaDA 8B serving", lambda: phase_serving(args.seed))])
    ok = True
    for name, fn in phases:
        print(f"[phase] {name}", flush=True)
        t0 = time.perf_counter()
        try:
            good = bool(fn())
        except Exception:
            traceback.print_exc()
            good = False
        ok &= good
        print(f"[phase] {name}: {'ok' if good else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok:
        sys.exit("chip_smoke: a phase failed")
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))


if __name__ == "__main__":
    main()
