#!/usr/bin/env python
"""Time the plain forms of the serving path's kernels on one GPU.

For each of the kernels this repo once hand-wrote for another chip, times
what XLA (and cuDNN, where JAX offers it) makes of the plain version at
the serving shapes, beside the alternatives the choice was made between:

  attention   cuDNN vs XLA at LLaDA prefill, decode, Dream GQA, SigLIP
              (hd 72) and S=8192; prefix-LM training fwd+bwd incl.
              blockwise
  linears     bf16 / int8 weight-only / int4 (dequant + bf16 dot) / the
              integer W4A8 form at decode rows (M=32); W8A8 vs bf16 at
              prefill rows (M=1029), with the GEMM kernels XLA chose
  kv cache    int8 / int4 cache attention vs bf16 attention
  the rest    SigLIP MLP chain, the splice gather, one decode layer in
              bf16 and int4, each in the llama and the fused layout

A time is the median over repeats of one jitted call that runs the op
R times on distinct weights (so no work is hoisted or shared) and
ends in block_until_ready, divided by --reps.  Fails without a GPU.
Writes one JSON line per measurement to --out as well as stdout.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


R = 8           # op applications per timed call, on distinct inputs
REPEATS = 10    # timed calls per measurement; the median is reported
GROUPS = ("calib", "attention", "linear", "head", "kv", "vit_mlp", "gather",
          "layer")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/time_kernels.jsonl")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma list of: " + ", ".join(GROUPS))
    args = ap.parse_args()
    groups = set(args.groups.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"unknown groups {sorted(groups - set(GROUPS))}")

    def want(*gs):
        return bool(groups & set(gs))

    from lavida_mod.utils import device
    from lavida_mod.utils.compile_cache import enable as enable_cache

    info = device.describe()
    enable_cache()
    import jax
    import jax.numpy as jnp

    from lavida_mod.ops import attention as A
    from lavida_mod.ops import kv8_attention as KV
    from lavida_mod.ops import quant as Q

    print(f"device {info['kind']} x{info['count']}; card {info['card']}",
          flush=True)
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sink = out_path.open("w")
    key = jax.random.PRNGKey(0)

    def time_call(fn, *xs):
        f = jax.jit(fn)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*xs))
        compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*xs))
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls), compile_s, f

    def record(group, name, form, seconds, **extra):
        row = {"group": group, "shape": name, "form": form,
               "us": seconds * 1e6, "device": info["kind"],
               "card": info["card"], **extra}
        print(f"  {group:10s} {name:42s} {form:18s} {seconds * 1e6:10.1f} us"
              + "".join(f"  {k}={v}" for k, v in extra.items()), flush=True)
        sink.write(json.dumps(row) + "\n")
        sink.flush()

    def kernels(f, *xs):
        """GEMM kernels and temp bytes of one compiled call."""
        c = f.lower(*xs).compile()
        txt = c.as_text()
        kinds = {k: txt.count(k) for k in ("__cublas$gemm",
                                           "__cublas$lt$matmul",
                                           "__triton_gemm", "s8[", "s4[")}
        mem = c.memory_analysis()
        return {"kinds": {k: v for k, v in kinds.items() if v},
                "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}

    def rand(k, shape, dtype=jnp.bfloat16, scale=1.0):
        return (jax.random.normal(k, shape) * scale).astype(dtype)

    # ---- calibration: what this card reaches on a big GEMM and a copy
    if want("calib"):
        a = rand(key, (8192, 8192))
        s, _, _ = time_call(lambda a: a @ a, a)
        record("calib", "bf16 gemm 8192^3", "xla", s,
               tflops=2 * 8192 ** 3 / s / 1e12)
        big = rand(key, (1024, 1024, 512))          # 1 GiB bf16
        s, _, _ = time_call(lambda x: x * 2, big)
        record("calib", "copy 1 GiB (read+write)", "xla", s,
               tb_per_s=2 * big.nbytes / s / 1e12)
        del a, big

    # ---- attention: cuDNN vs XLA
    if want("attention"):
        att = [
            ("LLaDA prefill B1 T=S=1029 H32 hd128", 1, 1029, 1029, 32, 32, 128),
            ("decode T=32 S=1061 H32 hd128", 1, 32, 1061, 32, 32, 128),
            ("Dream GQA 28/4 T=S=1029 hd128", 1, 1029, 1029, 28, 4, 128),
            ("SigLIP 5x729 H16 hd72", 5, 729, 729, 16, 16, 72),
            ("long T=S=8192 H32 hd128", 1, 8192, 8192, 32, 32, 128),
        ]
        for name, B, T, S, Hq, Hkv, hd in att:
            ks = jax.random.split(jax.random.fold_in(key, T + Hq), 3)
            q = rand(ks[0], (B, T, Hq, hd))
            k = rand(ks[1], (B, S, Hkv, hd))
            v = rand(ks[2], (B, S, Hkv, hd))
            mask = A.make_mask(kv_valid=jnp.arange(S)[None] >= 7)
            for impl in ("cudnn", "xla"):
                for masked in (False, True):
                    try:
                        s, _, _ = time_call(
                            lambda q, k, v, m: A.attention(
                                q, k, v, m if masked else None,
                                implementation=impl), q, k, v, mask)
                        record("attention", name, impl + ("+mask" if masked
                                                          else ""), s)
                    except Exception as e:    # report a refusal, keep going
                        record("attention", name,
                               impl + ("+mask" if masked else ""), float("nan"),
                               error=type(e).__name__ + ": " + str(e)[:160])
            del q, k, v

        # training: prefix-LM mask, fwd + bwd (the removed prefix-LM kernel)
        B, T, H, hd = 2, 2048, 32, 128
        ks = jax.random.split(jax.random.fold_in(key, 99), 4)
        q, k, v = (rand(ks[i], (B, T, H, hd)) for i in range(3))
        pl = jnp.asarray([T // 4, T // 2])
        pos = jnp.arange(T, dtype=jnp.int32)
        mask = A.make_mask(prefix_lengths=pl, q_positions=pos, kv_positions=pos)

        def fwd_bwd(fn):
            def loss(q, k, v):
                return jnp.sum(fn(q, k, v).astype(jnp.float32))
            return jax.grad(loss, argnums=(0, 1, 2))

        train_forms = {
            "cudnn": lambda q, k, v: A.attention(q, k, v, mask,
                                                 implementation="cudnn"),
            "xla": lambda q, k, v: A.attention(q, k, v, mask,
                                               implementation="xla"),
            "blockwise": lambda q, k, v: A.blockwise_attention(
                q, k, v, prefix_lengths=pl, q_positions=pos, kv_block=1024),
        }
        for form, fn in train_forms.items():
            try:
                s, _, _ = time_call(fwd_bwd(fn), q, k, v)
                record("attention", f"prefix-LM fwd+bwd B{B} T={T} H{H}", form, s)
            except Exception as e:
                record("attention", f"prefix-LM fwd+bwd B{B} T={T} H{H}", form,
                       float("nan"), error=type(e).__name__ + ": " + str(e)[:160])
        del q, k, v

    # ---- linears
    if want("linear", "head"):
        def w4a8_int_form(x, packed, scales):
            """The integer W4A8 form: per-token int8 activations, int4 values
            unpacked from bytes, an integer dot per scale group, group scales
            on the accumulator."""
            K2, N = packed.shape
            K, G = 2 * K2, scales.shape[0]
            p32 = packed.astype(jnp.int32)
            lo = jax.lax.shift_right_arithmetic(jax.lax.shift_left(p32, 28), 28)
            hi = jax.lax.shift_right_arithmetic(p32, 4)
            w = jnp.stack([lo, hi], axis=1).reshape(K, N)
            xf = x.astype(jnp.float32)
            sx = jnp.maximum(jnp.abs(xf).max(-1, keepdims=True), 1e-8) / 127.0
            x8 = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int32)
            acc = jnp.einsum("tgk,gkn->tgn", x8.reshape(-1, G, K // G),
                             w.reshape(G, K // G, N)).astype(jnp.float32)
            return jnp.einsum("tgn,gn->tn", acc, scales) * sx

        def pack(q4):
            """int4 [K, N] -> bytes [K/2, N], row 2k in the low nibble."""
            q = q4.astype(jnp.int32)
            return ((q[1::2] & 0xF) << 4 | (q[0::2] & 0xF)).astype(
                jnp.uint8).view(jnp.int8)

        shapes = ([(4096, 4096), (4096, 12288), (12288, 4096)]
                  if want("linear") else []) + (
                      [(4096, 126464)] if want("head") else [])
        for K, N in shapes:
            n = R if K * N <= 4096 * 12288 else 2
            ws = [rand(jax.random.fold_in(key, K + N + i), (K, N), scale=0.02)
                  for i in range(n)]
            layouts = {
                "bf16": [{"kernel": w} for w in ws],
                "int8": [Q.quantize_linear({"kernel": w}) for w in ws],
                "int4": [Q.quantize_linear4({"kernel": w}) for w in ws],
            }
            packed = [(pack(p["kernel_q4"]), p["scales4"])
                      for p in layouts["int4"]]
            del ws
            for M in (32, 1029):
                x = rand(jax.random.fold_in(key, M), (M, K))
                forms = {f: (lambda ps: lambda x, ps=ps: sum(
                    Q.linear(x, p, preferred=jnp.float32) for p in ps))(ps)
                    for f, ps in layouts.items()}
                if M == 32 and n == R:
                    # (skipped on the head: its int32 unpack alone is
                    # 2 GB per weight, and the form lost 10-30x elsewhere)
                    forms["int4 W4A8 integer"] = lambda x: sum(
                        w4a8_int_form(x, pk, sc) for pk, sc in packed)
                else:
                    forms["int8 W8A8"] = lambda x: sum(
                        Q.linear_act_int8(x, p, preferred=jnp.float32)
                        for p in layouts["int8"])
                for form, fn in forms.items():
                    s, _, f = time_call(fn, x)
                    extra = {}
                    if form in ("int4", "int8 W8A8", "int4 W4A8 integer"):
                        extra = kernels(f, x)
                    wbytes = sum(l.nbytes for p in layouts[form.split()[0]]
                                 for l in jax.tree.leaves(p))
                    record("linear", f"M={M} {K}x{N}", form, s / n,
                           weight_gb_per_s=wbytes / s / 1e9, **extra)
            del layouts, packed

    # ---- kv cache attention at decode shapes
    if want("kv"):
        T, S, H, hd = 32, 1061, 32, 128
        ks = jax.random.split(jax.random.fold_in(key, 5), 3)
        q = rand(ks[0], (1, T, H, hd))
        kf = rand(ks[1], (1, S, H, hd))
        vf = rand(ks[2], (1, S, H, hd))
        valid = jnp.arange(S)[None] >= 7
        s, _, _ = time_call(lambda q, k, v: A.attention(
            q, k, v, A.make_mask(kv_valid=valid)), q, kf, vf)
        record("kv", f"decode T={T} S={S} H{H}", "bf16 cache", s)
        for bits in (8, 4):
            k8, kscale = KV.quantize_kv(kf, bits)
            v8, vscale = KV.quantize_kv(vf, bits)
            s, _, _ = time_call(lambda q, *c: KV.kv8_decode_attention(
                q, *c, kv_valid=valid), q, k8, kscale, v8, vscale)
            record("kv", f"decode T={T} S={S} H{H}", f"int{bits} cache", s)

    # ---- SigLIP MLP chain (LN -> fc1 -> gelu -> fc2 + residual)
    if want("vit_mlp"):
        from lavida_mod.ops.norms import layer_norm

        D, I = 1152, 4304
        h = rand(key, (5, 729, D))
        mlp = [dict(w1=rand(jax.random.fold_in(key, i), (D, I), scale=0.02),
                    w2=rand(jax.random.fold_in(key, 50 + i), (I, D), scale=0.02),
                    g=jnp.ones((D,), jnp.bfloat16), b=jnp.zeros((D,),
                                                                jnp.bfloat16))
               for i in range(R)]

        def vit_mlp(h, ps):
            for p in ps:
                z = layer_norm(h, p["g"], p["b"], 1e-6)
                h = h + jax.nn.gelu(z @ p["w1"], approximate=True) @ p["w2"]
            return h

        s, _, _ = time_call(vit_mlp, h, mlp)
        record("vit_mlp", "5x729 1152->4304->1152", "xla", s / R)
        del h, mlp

    # ---- splice gather: ~1k rows out of the flat embedding table
    if want("gather"):
        table = rand(key, (5 * 196 + 1 + 48 + 1, 4096))
        idx = jax.random.randint(key, (R, 1029), 0, table.shape[0])
        s, _, _ = time_call(lambda t, i: sum(t[i[r]] for r in range(R)),
                            table, idx)
        record("gather", "1029 rows of 4096 from 1030", "xla", s / R)

    # ---- one decode layer, M=32 rows: bf16 and int4, each in the llama
    # layout (q/k/v, gate/up apart) and the fused one (to_fused_layout)
    if want("layer"):
        from lavida_mod.config import LLaDAConfig
        from lavida_mod.models import llada as L

        # LLaDA-8B layer widths; a small vocab, since only the layers run
        cfg = LLaDAConfig(n_layers=R, d_model=4096, mlp_hidden_size=12288,
                          vocab_size=256, embedding_size=256)
        llama = L.unstack_blocks(L.init_params(cfg, key, jnp.bfloat16))
        x = rand(key, (1, 32, 4096))
        for layout in ("llama", "fused"):
            params, lcfg = ((llama, cfg) if layout == "llama"
                            else L.to_fused_layout(llama, cfg))
            for form, p in (("bf16", params),
                            ("int4", L.quantize_params(params, bits=4))):
                s, _, _ = time_call(lambda p, x: L.forward(
                    p, lcfg, x, return_logits=False)[0], p, x)
                record("layer", f"LLaDA decode layer M=32 ({layout})",
                       form, s / R)
    sink.close()


if __name__ == "__main__":
    main()
