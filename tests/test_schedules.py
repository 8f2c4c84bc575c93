"""Golden tests for transfer-count schedules vs the reference semantics
(llava/model/language_model/llada/generate.py:22-114)."""

import numpy as np
import pytest

from lavida_mod.ops import schedules as S


def _reference_scheduled(mask_counts, steps, schedule, shift=3.0):
    """Literal re-execution of the reference algorithm in numpy for oracle
    comparison (generate.py:42-95)."""
    mask_counts = np.asarray(mask_counts, dtype=np.int64)
    steps = int(min(steps, mask_counts[0]))
    t = np.linspace(0, 1, steps + 1)
    if schedule == "logit_normal":
        sig = S.logit_normal_cdf_curve(t)
    elif schedule == "shift":
        sig = S.shift_curve(t, shift)
    elif schedule == "cosine":
        sig = S.cosine_curve(t)
    else:
        sig = t
    out = np.zeros((len(mask_counts), steps), dtype=np.int64)
    for i, n in enumerate(mask_counts):
        if n < steps:
            # degenerate row (reference would spin forever): our documented
            # graceful fallback — one commit per step for the last n pre-flip
            # steps (schedules.py)
            out[i] = np.array([0] * (steps - int(n)) + [1] * int(n))
            continue
        s = (sig * n).astype(np.int64)
        s[0], s[-1] = 0, n  # endpoint pin (see schedules.py)
        d = np.clip(s[1:] - s[:-1], 1, None)
        delta = d.sum() - n
        j = 0
        while delta > 0:
            j = j % len(d)
            if d[j] == 1:
                j += 1
                continue
            delta -= 1
            d[j] -= 1
            j += 1
        out[i] = d
    return out[:, ::-1]


def test_uniform_split():
    out = S.num_transfer_tokens(np.array([10, 7]), 4)
    assert out.tolist() == [[3, 3, 2, 2], [2, 2, 2, 1]]
    assert (out.sum(1) == [10, 7]).all()


@pytest.mark.parametrize("schedule", ["linear", "cosine", "logit_normal", "shift"])
@pytest.mark.parametrize("n,steps", [(64, 16), (64, 32), (32, 16), (5, 16), (128, 64)])
def test_scheduled_matches_reference(schedule, n, steps):
    counts = np.array([n, max(n - 3, 1)])
    ours = S.num_transfer_tokens_scheduled(counts, steps, schedule, shift=0.33)
    ref = _reference_scheduled(counts, steps, schedule, shift=0.33)
    np.testing.assert_array_equal(ours, ref)
    # every step commits >=1 token except in the degenerate n<steps fallback
    nondegenerate = counts >= ours.shape[1]
    assert (ours[nondegenerate] >= 1).all()
    assert (ours.sum(1) == counts).all()


def test_step_clamp_uses_row0():
    # steps reduced to min(steps, mask_counts[0]) — reference generate.py:56
    out = S.num_transfer_tokens_scheduled(np.array([4, 10]), 16, "shift")
    assert out.shape[1] == 4


def test_resolve_steps():
    # defaults: steps = max_new_tokens / num_blocks
    assert S.resolve_steps(128, 32) == (4, 32)
    # step_ratio halves NFE (run_coco.sh step_ratio=0.5)
    assert S.resolve_steps(64, 64, step_ratio=0.5) == (1, 32)
    # step_per_block clamps to block length
    assert S.resolve_steps(128, 32, step_per_block=64) == (4, 32)
