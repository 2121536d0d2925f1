"""The bound of the fp32 AdamW train-trajectory tests against JAX
(tests/test_torch_train.py, tests/test_torch_tome.py).

Three steps of grouped AdamW (eps 1e-8, clip 1.0) from one init on both
sides. Two checks:

- The step-1 gradients, each leaf within 1e-5 of its largest |g|: the
  gradient function itself, before the optimizer amplifies anything.
- The params and EMA params after the last step, each element within
  1e-5 of its leaf's max |w| where the clipped step-1 gradient is well
  above eps (|g| >= 100 eps). For the rest the bound comes from AdamW's
  update. Its first step moves a param by lr * g / (|g| + eps). Near
  |g| ~ eps that ratio swings across (-1, 1) for gradient gaps of the
  order eps, and the fp32 sums of either side leave gaps of that order
  (for instance the key bias, whose gradient is zero up to rounding, or
  a conv weight whose terms cancel to 1e-7). While the second moment
  stays within a few eps of zero the ratio keeps that range, so such an
  element's gap is bounded by the update's range, 2 lr a step (the
  moments' ratio |m| / sqrt(v) stays below 1.004 in three steps, by
  Cauchy-Schwarz over their weights): 1e-5 max|w| + 2.01 lr STEPS, lr
  the largest of the recipe's groups. Once its first gradient is 100 eps
  or more, every later step's sqrt(v) stays above 57 eps and the gap
  stays a rounding one.
"""

import numpy as np

ADAM_EPS = 1e-8
NEAR_ZERO = 100 * ADAM_EPS


def assert_step1_grads_close(got: dict, want: dict):
    """{torch name: array} gradients of the same batch from the same
    params, each leaf within 1e-5 of its largest |g|."""
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[n]), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=n)


def assert_params_close(got: dict, want: dict, step1_grads: dict,
                        grad_norm: float, clip: float, lr: float,
                        steps: int):
    """``got`` and ``want``: {torch name: array} params after ``steps``
    AdamW steps; ``step1_grads``: the reference's step-1 gradients, and
    ``grad_norm`` their global norm, which sets the clip's scale."""
    assert sorted(got) == sorted(want)
    scale = min(1.0, clip / grad_norm)
    for n, w in want.items():
        w, g = np.asarray(w), np.asarray(step1_grads[n]) * scale
        tol = np.full(w.shape, 1e-5 * float(np.abs(w).max()))
        tol[np.abs(g) < NEAR_ZERO] += 2.01 * lr * steps
        gap = np.abs(np.asarray(got[n]) - w)
        bad = gap > tol
        worst = np.argmax(gap / tol)
        assert not bad.any(), (
            f"{n}: {int(bad.sum())} of {w.size} elements out of bound, the "
            f"worst {float(gap.ravel()[worst])} against "
            f"{float(tol.ravel()[worst])} (clipped step-1 gradient "
            f"{float(g.ravel()[worst])})")
