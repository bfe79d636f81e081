"""Loss library tests, including golden checks against reference math."""

import jax.numpy as jnp
import numpy as np
from scipy import stats

from gwen import losses


def test_masked_node_l1():
    out = jnp.ones((4, 3)) * 2.0
    x = jnp.zeros((4, 3))
    mask = jnp.array([True, True, False, False])
    # only first two nodes count; |2-0| = 2 everywhere
    assert float(losses.masked_node_l1(out, x, mask)) == 2.0
    # all-false mask → 0 (no NaN)
    assert float(losses.masked_node_l1(out, x, jnp.zeros(4, bool))) == 0.0


def test_crps_surrogate_matches_reference_math():
    """mean((Phi((y-mu)/sigma) - 0.5)^2) — loss_functions.py:41-73."""
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(5, 11, 7)).astype(np.float32)  # ensemble axis 1
    target = rng.normal(size=(5, 1, 7)).astype(np.float32)
    mu = preds.mean(axis=1, keepdims=True)
    sigma = preds.std(axis=1, keepdims=True) + 1e-6
    expected = np.mean((stats.norm.cdf((target - mu) / sigma) - 0.5) ** 2)
    got = float(losses.crps_gaussian_surrogate(jnp.asarray(preds), jnp.asarray(target)))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_crps_gaussian_analytic_zero_sigma_limit():
    # As sigma -> 0, CRPS -> |mu - y|.
    mu = jnp.array([1.0])
    y = jnp.array([3.0])
    val = float(losses.crps_gaussian(mu, jnp.array([1e-8]), y))
    np.testing.assert_allclose(val, 2.0, rtol=1e-4)


def test_crps_ensemble_perfect_deterministic():
    # Single-member ensemble equal to the target → CRPS 0.
    preds = jnp.zeros((1, 5))
    target = jnp.zeros((5,))
    assert float(losses.crps_ensemble(preds, target, fair=False)) == 0.0


def test_crps_ensemble_matches_bruteforce():
    rng = np.random.default_rng(1)
    m, k = 7, 13
    preds = rng.normal(size=(m, k))
    target = rng.normal(size=(k,))
    term1 = np.mean(np.abs(preds - target[None]), axis=0)
    term2 = np.zeros(k)
    for i in range(m):
        for j in range(m):
            term2 += np.abs(preds[i] - preds[j])
    term2 /= m * (m - 1)
    expected = np.mean(term1 - 0.5 * term2)
    got = float(losses.crps_ensemble(jnp.asarray(preds), jnp.asarray(target), fair=True))
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_ensemble_var_reg():
    """L1 - alpha*mean(var) — loss_functions.py:76-123."""
    rng = np.random.default_rng(2)
    preds = rng.normal(size=(3, 6, 4)).astype(np.float32)
    target = rng.normal(size=(3, 6, 4)).astype(np.float32)
    expected = np.mean(np.abs(preds - target)) - 0.1 * np.mean(preds.var(axis=1))
    got = float(
        losses.ensemble_variance_regularized_l1(
            jnp.asarray(preds), jnp.asarray(target), alpha=0.1
        )
    )
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_masked_loss_normalization():
    """Zero constant cells, normalize by mask sum — loss_functions.py:126-180."""
    pred = jnp.ones((2, 4))
    target = jnp.zeros((2, 4))
    mask = jnp.array([[1.0, 1.0, 0.0, 0.0]])
    got = float(losses.masked_loss(pred, target, mask))
    assert got == 1.0  # 4 active cells with err 1, / 4


def test_variance_mask():
    data = np.zeros((10, 5), np.float32)
    data[:, 0] = np.arange(10)  # varying cell
    mask = losses.variance_mask(data, threshold=0.0)
    np.testing.assert_array_equal(np.asarray(mask), [1, 0, 0, 0, 0])
