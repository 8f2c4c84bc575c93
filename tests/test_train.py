"""Training-path tests: complementary-masking loss parity vs a torch oracle
on the reference model, optimizer groups, and the sharded train step on the
8-device CPU mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import LaViDaConfig, tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.models.llada_loader import convert_state_dict
from lavida_mod.parallel import batch_spec, make_mesh, param_specs, shard_params
from lavida_mod.train.loss import diffusion_loss, forward_process, sample_t
from lavida_mod.train.step import jit_train_step, make_optimizer, make_train_step

from test_llada_parity import _make_ref_model

MASK_ID = 500


def test_forward_process_masks_at_least_one():
    key = jax.random.PRNGKey(0)
    for i in range(5):
        m, p = forward_process(jax.random.fold_in(key, i), 4, 32)
        assert (np.asarray(m).sum(axis=1) >= 1).all()
        assert p.shape == (4, 1)


def test_sample_t_policies():
    key = jax.random.PRNGKey(1)
    for policy in ("uniform", "logit_normal", "mode"):
        t = sample_t(key, 1000, policy)
        t = np.asarray(t)
        assert t.shape == (1000,)
        if policy != "mode":  # mode policy can exceed [0,1] by design
            assert (t >= 0).all() and (t <= 1).all()


def test_loss_parity_with_torch_oracle(reference_llada):
    """Same weights + same injected mask -> same loss as a literal torch
    re-execution of llava_llada.py:129-258 (complementary masking, batch
    doubling, mean-CE over supervised labels)."""
    ref_model, _ = _make_ref_model(reference_llada)
    state = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    cfg = tiny_llada_config()
    params = convert_state_dict(state, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    B, L = 2, 24
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[0, 10:] = ids[0, 10:]
    labels[1, 14:] = ids[1, 14:]
    masked = rng.random((B, L)) < 0.5

    embeds = jl.embed_tokens(params, jnp.asarray(ids))
    loss, metrics = diffusion_loss(
        params, cfg, embeds, jnp.asarray(labels), jax.random.PRNGKey(0),
        prefix_lm=False, masked_indices=jnp.asarray(masked), remat=False,
    )

    # torch oracle
    with torch.no_grad():
        t_ids = torch.from_numpy(ids)
        t_lab = torch.from_numpy(labels)
        lm = t_lab != -100
        fm = torch.from_numpy(masked) & lm
        fmi = ~torch.from_numpy(masked) & lm
        wte = ref_model.transformer.wte
        emb = wte(t_ids)
        noise = wte(torch.tensor([MASK_ID])).view(1, 1, -1)
        e1 = torch.where(fm.unsqueeze(-1), noise, emb)
        e2 = torch.where(fmi.unsqueeze(-1), noise, emb)
        lab1 = t_lab.clone(); lab1[~fm] = -100
        lab2 = t_lab.clone(); lab2[~fmi] = -100
        out = ref_model(None, input_embeddings=torch.cat([e1, e2]))
        logits = out.logits
        ref_loss = torch.nn.functional.cross_entropy(
            logits.flatten(0, 1), torch.cat([lab1, lab2]).flatten()
        )
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=2e-4)
    assert 0.0 <= float(metrics["acc_mask"]) <= 1.0
    assert int(metrics["num_supervised"]) == int(lm.sum())


def test_train_step_sharded_runs_and_learns():
    cfg = LaViDaConfig(llada=tiny_llada_config())
    params = jl.init_params(cfg.llada, jax.random.PRNGKey(0))

    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    params = shard_params(params, mesh)

    opt = make_optimizer(lr=1e-2, total_steps=10)
    opt_state = opt.init(params)

    step = jit_train_step(make_train_step(cfg, opt, prefix_lm=True, remat=True))

    rng = np.random.default_rng(0)
    B, L = 8, 16
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, 8:] = ids[:, 8:]
    batch = {
        "inputs_embeds": jl.embed_tokens(params, jnp.asarray(ids)),
        "labels": jnp.asarray(labels),
    }
    losses = []
    for i in range(5):
        # embeds recomputed each step because params change
        batch["inputs_embeds"] = jl.embed_tokens(params, jnp.asarray(ids))
        params, opt_state, metrics = step(
            params, opt_state, batch, jax.random.PRNGKey(i)
        )
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[-1] < losses[0], losses


def test_param_specs_cover_llada_and_composed():
    from lavida_mod.config import VisionConfig, tiny_siglip_config
    from lavida_mod.models import multimodal as mm

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    specs = param_specs(params)
    flat = jax.tree_util.tree_leaves_with_path(specs)
    # every QKV kernel sharded fsdp x tp; norms replicated
    import jax.sharding as shd

    def get(path_str):
        for p, s in flat:
            joined = "/".join(
                str(x.key) if hasattr(x, "key") else str(x) for x in p
            )
            if joined == path_str:
                return s
        raise KeyError(path_str)

    assert get("llada/blocks/q_proj/kernel") == shd.PartitionSpec(None, "fsdp", "tp")
    assert get("llada/blocks/attn_out/kernel") == shd.PartitionSpec(None, "tp", "fsdp")
    assert get("llada/wte") == shd.PartitionSpec("tp", "fsdp")
    assert get("llada/ln_f/weight") == shd.PartitionSpec()
    assert get("image_newline") == shd.PartitionSpec()
    assert batch_spec() == shd.PartitionSpec(("dp", "fsdp"))


def test_pos_skipping_changes_logits_not_loss_magnitude():
    cfg = tiny_llada_config()
    params = jl.init_params(cfg.llada if hasattr(cfg, "llada") else cfg,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, L = 2, 16
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, 8:] = ids[:, 8:]
    embeds = jl.embed_tokens(params, jnp.asarray(ids))
    masked = jnp.asarray(rng.random((B, L)) < 0.5)
    base, _ = diffusion_loss(
        params, cfg, embeds, jnp.asarray(labels), jax.random.PRNGKey(1),
        prefix_lm=False, masked_indices=masked, remat=False,
    )
    skipped, _ = diffusion_loss(
        params, cfg, embeds, jnp.asarray(labels), jax.random.PRNGKey(1),
        prefix_lm=False, masked_indices=masked, pos_skip_range=256,
        remat=False,
    )
    assert np.isfinite(float(skipped))
    # offset positions change the loss value but keep it in a sane band
    assert abs(float(skipped) - float(base)) < 2.0


def test_train_step_sharded_no_involuntary_reshard(capfd):
    """The batch-sharding constraint in diffusion_loss must keep GSPMD from
    'involuntary full rematerialization' on the mask selects (a real
    multi-chip perf bug: XLA replicates + repartitions inside train_step).
    Also: mesh-constrained and unconstrained steps agree numerically."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = LaViDaConfig(llada=tiny_llada_config())
    params = jl.init_params(cfg.llada, jax.random.PRNGKey(0))
    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    params = shard_params(params, mesh)
    opt = make_optimizer(lr=1e-3, total_steps=10)
    opt_state = opt.init(params)

    rng = np.random.default_rng(1)
    B, L = 8, 16
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, 8:] = ids[:, 8:]
    batch = {
        "inputs_embeds": jax.device_put(
            jl.embed_tokens(params, jnp.asarray(ids)),
            NamedSharding(mesh, P(("dp", "fsdp"), None, None)),
        ),
        "labels": jax.device_put(
            jnp.asarray(labels), NamedSharding(mesh, P(("dp", "fsdp"), None))
        ),
    }

    ref_step = make_train_step(cfg, opt, prefix_lm=True, remat=True)
    _, _, ref_metrics = ref_step(params, opt_state, batch,
                                 jax.random.PRNGKey(7))

    capfd.readouterr()  # drain
    step = jit_train_step(
        make_train_step(cfg, opt, prefix_lm=True, remat=True, mesh=mesh)
    )
    _, _, metrics = step(params, opt_state, batch, jax.random.PRNGKey(7))
    loss = float(metrics["loss"])
    err = capfd.readouterr().err
    assert "Involuntary full rematerialization" not in err
    np.testing.assert_allclose(loss, float(ref_metrics["loss"]), atol=2e-5)


@pytest.mark.parametrize(
    "strategy", ["whole_layer", "one_in_2", "one_in_4", "dots",
                 "dots_nobatch", "nested"]
)
def test_remat_strategies_exact(strategy):
    """one_in_N checkpointing (modeling_llada.py:189-203): logits and
    grads must be bit-equal to the un-rematted forward — remat changes
    memory, never math."""
    cfg = tiny_llada_config(n_layers=4)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    ids = jnp.asarray(np.arange(3, 19)[None])
    embeds = jl.embed_tokens(params, ids)

    def loss(p, remat):
        logits, _ = jl.forward(p, cfg, embeds, remat=remat)
        return (logits.astype(jnp.float32) ** 2).mean()

    base, gbase = jax.value_and_grad(lambda p: loss(p, False))(params)
    out, g = jax.value_and_grad(lambda p: loss(p, strategy))(params)
    np.testing.assert_allclose(float(out), float(base), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(gbase)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("tied", [False, True])
def test_ce_chunk_loss_and_grads_exact(tied):
    """Chunked cross-entropy head (memory-efficient LM head for the 8B
    stage-2: the f32 [2B, L, V] logits are ~8.3 GB/chip, AOT-verified
    B=16 blocker) — loss, acc, and grads must match the monolithic head;
    L deliberately not a multiple of the chunk (pad positions are
    unsupervised)."""
    cfg = tiny_llada_config(weight_tying=tied)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    B, T = 2, 100
    ids = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, 500)
    emb = jl.embed_tokens(params, ids)
    labels = np.array(ids)
    labels[:, :30] = -100
    labels = jnp.asarray(labels)
    key = jax.random.PRNGKey(3)

    def loss_with(p, ce):
        loss, m = diffusion_loss(p, cfg, emb, labels, key,
                                 prefix_lm=True, ce_chunk=ce)
        return loss, m

    (l0, m0), g0 = jax.value_and_grad(
        lambda p: loss_with(p, None), has_aux=True)(params)
    (l1, m1), g1 = jax.value_and_grad(
        lambda p: loss_with(p, 32), has_aux=True)(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(m0["acc_mask"]),
                               float(m1["acc_mask"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=1e-4)


def test_remat_policy_memory_ladder():
    """Memory-delta assertion for the activation-checkpointing knob.

    The scan-friendly intermediate points between whole_layer and no remat
    are checkpoint POLICIES on the scanned layer (models/llada.py
    _remat_group docstring: the literal one_in_N translation makes
    weight-stack layout copies under lax.scan that can exceed the
    activation saving — measured).  Assert the policy ladder:
    whole_layer < dots_nobatch < dots < none.
    """
    cfg = tiny_llada_config(n_layers=8)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    embeds = jl.embed_tokens(params, jnp.asarray(np.arange(3, 259)[None]))

    def mk(remat):
        def loss(p):
            logits, _ = jl.forward(p, cfg, embeds, remat=remat)
            return (logits.astype(jnp.float32) ** 2).mean()
        return jax.jit(jax.grad(loss)).lower(params).compile()

    temps = {}
    for r in (False, "whole_layer", "dots", "dots_nobatch"):
        m = mk(r).memory_analysis()
        if m is None:
            pytest.skip("memory_analysis unavailable on this backend")
        temps[r] = m.temp_size_in_bytes
    assert temps["whole_layer"] < temps["dots_nobatch"], temps
    assert temps["dots_nobatch"] < temps["dots"], temps
    assert temps["dots"] < temps[False], temps
