"""gcnbmp_tpu.nn: the module system behind every encoder and head.

Where flax is installed, each case builds the same modules with
flax.linen and with gcnbmp_tpu.nn and checks that the parameter trees
(names, shapes, initial values) and the outputs are identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcnbmp_tpu import nn as gnn


def _cases(nn):
    """name -> (module factory, input builder, apply kwargs)."""

    class Composite(nn.Module):
        features: int

        @nn.compact
        def __call__(self, x):
            h = nn.relu(nn.Dense(self.features)(x))      # Dense_0
            h = nn.Dense(self.features, name="named")(h)
            h = h + nn.Dense(self.features, use_bias=False)(x)  # Dense_1
            return jnp.sum(h, axis=-1)

    class Holder(nn.Module):
        inner: nn.Module

        @nn.compact
        def __call__(self, x):
            return self.inner(x) + self.inner(2.0 * x)   # one set of params

    x = lambda: jnp.asarray(np.random.default_rng(0).normal(size=(3, 5, 6)),
                            jnp.float32)
    return {
        "dense": (lambda: nn.Dense(4), x, {}),
        "dense_bf16": (lambda: nn.Dense(4, dtype=jnp.bfloat16), x, {}),
        "lstm_rnn": (lambda: nn.RNN(nn.OptimizedLSTMCell(4)), x, {}),
        "lstm_rnn_reverse": (
            lambda: nn.RNN(nn.OptimizedLSTMCell(4), reverse=True,
                           keep_order=True), x, {}),
        "gru_rnn": (lambda: nn.RNN(nn.GRUCell(3)), x, {}),
        "composite": (lambda: Composite(5), x, {}),
        "adopted_field": (lambda: Holder(Composite(2)), x, {}),
        "dropout": (lambda: nn.Dropout(0.5, deterministic=False), x,
                    {"rngs": {"dropout": jax.random.PRNGKey(7)}}),
    }


CASES = sorted(_cases(gnn))


@pytest.mark.parametrize("case", CASES)
def test_matches_flax(case):
    linen = pytest.importorskip("flax.linen")
    results = []
    for nn in (linen, gnn):
        make, inputs, kwargs = _cases(nn)[case]
        module, x = make(), inputs()
        variables = module.init(jax.random.PRNGKey(1), x)
        out = module.apply(variables, x, **kwargs)
        results.append((jax.tree_util.tree_flatten_with_path(variables)[0],
                        out))
    (flax_vars, flax_out), (ours_vars, ours_out) = results
    assert [jax.tree_util.keystr(k) for k, _ in flax_vars] == \
        [jax.tree_util.keystr(k) for k, _ in ours_vars]
    for (_, a), (_, b) in zip(flax_vars, ours_vars):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(ours_out, np.float32),
                               np.asarray(flax_out, np.float32),
                               rtol=1e-6, atol=1e-6)


def test_batchnorm_statistics():
    x = jnp.arange(12.0).reshape(4, 3)
    train = gnn.BatchNorm(use_running_average=False)
    variables = train.init(jax.random.PRNGKey(0), x)
    assert set(variables) == {"params", "batch_stats"}
    np.testing.assert_array_equal(
        np.asarray(variables["batch_stats"]["var"]), 1.0)
    # running averages: (x - 0) / sqrt(1 + eps) * scale + bias
    y = gnn.BatchNorm(use_running_average=True).apply(variables, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x) / np.sqrt(1 + 1e-5),
                               rtol=1e-6)
    # updating the statistics needs mutable variables, which apply refuses
    with pytest.raises(ValueError, match="immutable"):
        train.apply(variables, x)


def test_apply_with_missing_param_raises():
    dense = gnn.Dense(3)
    with pytest.raises(ValueError, match="missing parameter"):
        dense.apply({"params": {}}, jnp.ones((2, 4)))


def test_unbound_module_cannot_create_params():
    with pytest.raises(ValueError, match="unbound"):
        gnn.Dense(3)(jnp.ones((2, 4)))


def test_clone_replaces_fields_and_unbinds():
    d = gnn.Dense(3, use_bias=False)
    c = d.clone(features=5)
    assert (c.features, c.use_bias, c.parent) == (5, False, None)
    params = c.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))["params"]
    assert params["kernel"].shape == (4, 5) and "bias" not in params


def test_dropout_needs_its_rng():
    drop = gnn.Dropout(0.5, deterministic=False)
    with pytest.raises(ValueError, match="PRNG key"):
        drop.apply({}, jnp.ones((4,)))
