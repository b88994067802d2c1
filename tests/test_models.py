"""Model-layer tests: activation-level parity of the GGNN encoder and the
scoring heads against independent numpy transcriptions of the reference
math (SURVEY §4 golden-value strategy; reference equations cited inline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcnbmp_tpu.chem import mol_from_smiles, GGNNFeaturizer
from gcnbmp_tpu.data.dataset import PairDataset, make_batch
from gcnbmp_tpu.models import GGNN, PairPredictor, set_up_predictor
from gcnbmp_tpu.models.heads import HEADS
from gcnbmp_tpu.ops.circular import (
    circular_correlation,
    circular_correlation_matmul,
    circular_correlation_reference,
)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _dense(p, x):
    return x @ np.asarray(p["kernel"]) + np.asarray(p["bias"])


def ref_ggnn_forward(params, atoms, adj, n_layers, hidden_dim, weight_tying, mask=None):
    """Numpy transcription of reference models/ggnn.py:215-263 (update),
    :333-341 (readout), :584-654 (__call__), with chainer.links.GRU
    (StatefulGRU) semantics and zero initial GRU state."""
    emb = np.asarray(params["embed"]["embedding"])
    h = emb[atoms]  # (B, N, H)
    h0 = h.copy()
    b, n, ch = h.shape
    # ONE GRU shared across layers (reference models/ggnn.py:132); its
    # state starts from reset_state() (None -> zeros) and then chains as
    # the previous GRU output across layers.
    gru = params["gru"]
    state = np.zeros_like(h)
    for step in range(n_layers):
        upd = params[f"update_{0 if weight_tying else step}"]
        # message: GraphLinear h -> 4h, reshape (B,N,H,4) -> (B,4,N,H)
        m = _dense(upd["message"]["dense"], h)
        m = m.reshape(b, n, ch, 4).transpose(0, 3, 1, 2)
        # adjacency aggregation + sum over edge types
        m = np.einsum("beij,bejh->bih", adj, m)
        # GRU input = concat(h, m); recurrent state = previous output
        x = np.concatenate([h, m], axis=-1)
        z = _sigmoid(_dense(gru["W_z"], x) + _dense(gru["U_z"], state))
        r = _sigmoid(_dense(gru["W_r"], x) + _dense(gru["U_r"], state))
        h_bar = np.tanh(_dense(gru["W"], x) + _dense(gru["U"], r * state))
        state = z * h_bar + (1.0 - z) * state
        h = state
    ro = params["readout_0"]
    gate = _sigmoid(_dense(ro["i"]["dense"], np.concatenate([h, h0], axis=-1)))
    g = gate * _dense(ro["j"]["dense"], h)
    if mask is not None:
        g = g * mask[..., None]
    return g.sum(axis=1), h


def _batch(smiles_pairs, labels):
    f = GGNNFeaturizer()
    ds = PairDataset()
    for (s1, s2), y in zip(smiles_pairs, labels):
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)), np.float32(y))
    return make_batch(ds, list(range(len(ds))))


@pytest.mark.parametrize("weight_tying", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_ggnn_activation_parity(weight_tying, masked):
    batch = _batch([("CCO", "c1ccccc1"), ("CC(=O)O", "C=O")], [1, 0])
    model = GGNN(out_dim=12, hidden_dim=8, n_layers=3, weight_tying=weight_tying)
    mask = batch.mask1 if masked else None
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        None if mask is None else jnp.asarray(mask),
    )
    g, aux = model.apply(
        {"params": variables["params"]},
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        None if mask is None else jnp.asarray(mask),
    )
    g_ref, h_ref = ref_ggnn_forward(
        jax.device_get(variables["params"]), batch.atoms1, batch.adj1,
        n_layers=3, hidden_dim=8, weight_tying=weight_tying, mask=mask,
    )
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(aux["atoms"]), h_ref, rtol=1e-5, atol=1e-5)


def test_ggnn_padding_inertness_with_mask():
    """With masking on, a molecule's embedding must not depend on pad size."""
    f = GGNNFeaturizer()
    ds = PairDataset()
    g = f(mol_from_smiles("CC(=O)Oc1ccccc1C(=O)O"))
    ds.append(g, g, np.float32(1))
    model = GGNN(out_dim=8, hidden_dim=8, n_layers=2)
    b_small = make_batch(ds, [0], pad_to=16)
    b_large = make_batch(ds, [0], pad_to=64)
    variables = model.init(
        jax.random.PRNGKey(1), jnp.asarray(b_small.atoms1),
        jnp.asarray(b_small.adj1), jnp.asarray(b_small.mask1),
    )
    g1, _ = model.apply(
        {"params": variables["params"]}, jnp.asarray(b_small.atoms1),
        jnp.asarray(b_small.adj1), jnp.asarray(b_small.mask1),
    )
    g2, _ = model.apply(
        {"params": variables["params"]}, jnp.asarray(b_large.atoms1),
        jnp.asarray(b_large.adj1), jnp.asarray(b_large.mask1),
    )
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-6)


def test_circular_correlation_matches_reference_fft():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 16)).astype(np.float32)
    b = rng.normal(size=(5, 16)).astype(np.float32)
    got = np.asarray(circular_correlation(jnp.asarray(a), jnp.asarray(b)))
    ref = np.asarray(circular_correlation_reference(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    # numpy definition: ifft(conj(fft(a)) * fft(b)).real
    ref2 = np.real(np.fft.ifft(np.conj(np.fft.fft(a, axis=-1)) * np.fft.fft(b, axis=-1), axis=-1))
    np.testing.assert_allclose(got, ref2, rtol=1e-4, atol=1e-5)
    # time-domain (circulant matmul) form
    got_mm = np.asarray(circular_correlation_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got_mm, ref2, rtol=1e-4, atol=1e-5)
    # auto dispatch: matmul form at D<=MATMUL_MAX_D,
    # rfft above — both already proven equal to the reference math
    from gcnbmp_tpu.ops.circular import MATMUL_MAX_D, circular_correlation_auto

    got_auto = np.asarray(
        circular_correlation_auto(jnp.asarray(a), jnp.asarray(b))
    )
    np.testing.assert_allclose(got_auto, ref2, rtol=1e-4, atol=1e-5)
    assert a.shape[-1] <= MATMUL_MAX_D  # this case takes the matmul branch
    a2 = rng.normal(size=(5, 32)).astype(np.float32)
    b2 = rng.normal(size=(5, 32)).astype(np.float32)
    ref32 = np.real(np.fft.ifft(
        np.conj(np.fft.fft(a2, axis=-1)) * np.fft.fft(b2, axis=-1), axis=-1))
    np.testing.assert_allclose(
        np.asarray(circular_correlation_auto(jnp.asarray(a2), jnp.asarray(b2))),
        ref32, rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("name", sorted(HEADS))
def test_heads_shapes_and_grads(name):
    head = HEADS[name](out_dim=1)
    rng = jax.random.PRNGKey(0)
    left = jax.random.normal(rng, (4, 16))
    right = jax.random.normal(jax.random.PRNGKey(1), (4, 16))
    variables = head.init(rng, left, right)
    out = head.apply(variables, left, right)
    assert out.shape == (4, 1)
    params = variables.get("params", {})  # cosine head is parameter-free

    def loss(p):
        return jnp.sum(head.apply({"params": p}, left, right) ** 2)

    grads = jax.grad(loss)(params)
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in flat)


def test_symmlp_is_symmetric():
    head = HEADS["symmlp"](out_dim=3)
    rng = jax.random.PRNGKey(0)
    left = jax.random.normal(rng, (4, 16))
    right = jax.random.normal(jax.random.PRNGKey(1), (4, 16))
    variables = head.init(rng, left, right)
    np.testing.assert_allclose(
        np.asarray(head.apply(variables, left, right)),
        np.asarray(head.apply(variables, right, left)),
        rtol=1e-6, atol=1e-6,
    )


def test_pair_predictor_symmetric_or():
    batch = _batch([("CCO", "c1ccccc1"), ("CC", "C=O")], [1, 0])
    pred = set_up_predictor(
        method="ggnn", fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
        sim_method="hole", symmetric="or",
    )
    variables = pred.init(
        jax.random.PRNGKey(0),
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
    )
    fwd = pred.apply(
        variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
    )
    rev = pred.apply(
        variables, jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.mask2), jnp.asarray(batch.mask1),
    )
    np.testing.assert_allclose(np.asarray(fwd), np.asarray(rev), rtol=1e-5, atol=1e-6)


def test_siamese_weight_sharing():
    """Siamese predictor: same molecule on both sides -> g1 == g2."""
    batch = _batch([("CCO", "CCO")], [1])
    pred = set_up_predictor(
        method="ggnn", fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
        sim_method="mlp",
    )
    variables = pred.init(
        jax.random.PRNGKey(0),
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
    )
    _, aux = pred.apply(
        variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
        return_aux=True,
    )
    np.testing.assert_allclose(
        np.asarray(aux["g1"]), np.asarray(aux["g2"]), rtol=1e-6
    )
