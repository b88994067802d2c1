"""ops/circular: both forms of the HolE circular correlation against the
reference transcription, in values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcnbmp_tpu.ops.circular import (
    circular_correlation,
    circular_correlation_auto,
    circular_correlation_matmul,
    circular_correlation_reference,
)

FORMS = {
    "rfft": circular_correlation,
    "matmul": circular_correlation_matmul,
    "auto": circular_correlation_auto,
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_circular_forms_match_reference(form, d):
    rng = np.random.default_rng(d)
    a = jnp.asarray(rng.normal(size=(6, d)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(6, d)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(6, d)), jnp.float32)
    fn = FORMS[form]
    np.testing.assert_allclose(
        np.asarray(fn(a, b)), np.asarray(circular_correlation_reference(a, b)),
        rtol=1e-4, atol=1e-4)
    got = jax.grad(lambda x, y: jnp.sum(fn(x, y) * w), argnums=(0, 1))(a, b)
    ref = jax.grad(
        lambda x, y: jnp.sum(circular_correlation_reference(x, y) * w),
        argnums=(0, 1))(a, b)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_circular_vjp_refuses_unequal_shapes():
    a = jnp.ones((4, 16))
    b = jnp.ones((4, 8))
    with pytest.raises(ValueError, match="same shape"):
        jax.grad(lambda x: jnp.sum(circular_correlation(x, b)))(a)
