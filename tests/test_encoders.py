"""Encoder family tests: RelGCN / GIN / MPNN / NFP shapes + parity with
numpy transcriptions of the reference math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset, make_batch
from gcnbmp_tpu.models import ENCODERS, GIN, MPNN, NFP, RelGCN, set_up_predictor


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def _dense(p, x):
    out = x @ np.asarray(p["kernel"])
    if "bias" in p:
        out = out + np.asarray(p["bias"])
    return out


def _batch():
    f = GGNNFeaturizer()
    ds = PairDataset()
    for s1, s2, y in [("CCO", "c1ccccc1", 1), ("CC(=O)O", "C=O", 0)]:
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)), np.float32(y))
    return make_batch(ds, [0, 1])


@pytest.mark.parametrize("method", sorted(ENCODERS))
def test_encoder_uniform_interface(method):
    batch = _batch()
    enc = ENCODERS[method](
        name="enc", out_dim=12, hidden_dim=8, n_layers=2, concat_hidden=False,
        layer_aggregator=None, dropout_rate=0.0, batch_normalization=False,
        weight_tying=True,
    )
    variables = enc.init(
        jax.random.PRNGKey(0), jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.mask1),
    )
    g, aux = enc.apply(
        variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.mask1),
    )
    assert g.shape[0] == 2 and np.all(np.isfinite(np.asarray(g)))
    assert aux["atoms"].shape[:2] == batch.atoms1.shape


@pytest.mark.parametrize("method", sorted(ENCODERS))
def test_encoder_in_pair_predictor(method):
    batch = _batch()
    pred = set_up_predictor(
        method=method, fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
        sim_method="mlp",
    )
    variables = pred.init(
        jax.random.PRNGKey(0),
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
    )
    out = pred.apply(
        variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
    )
    assert out.shape == (2, 1) and np.all(np.isfinite(np.asarray(out)))


def test_relgcn_parity():
    """RelGCN vs transcription of models/relgcn.py:62-72 +
    relgcn_update.py:25-44 + readout/ggnn_readout.py:42-59."""
    batch = _batch()
    model = RelGCN(out_dim=10, ch_list=(8, 12, 6))
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1)
    )
    g, aux = model.apply(
        {"params": variables["params"]},
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
    )
    p = jax.device_get(variables["params"])
    h = np.asarray(p["embed"]["embedding"])[batch.atoms1]
    adj = batch.adj1
    for i, out_ch in enumerate([12, 6]):
        conv = p[f"conv_{i}"]
        hs = _dense(conv["self"]["dense"], h)
        m = _dense(conv["edge"]["dense"], h)
        b, n, _ = h.shape
        m = m.reshape(b, n, out_ch, 4).transpose(0, 3, 1, 2)
        m = np.einsum("beij,bejh->bih", adj, m)
        h = np.tanh(hs + m)
    ro = p["readout"]
    g_ref = _sigmoid(h @ ro["i"]["dense"]["kernel"]) * np.tanh(
        h @ ro["j"]["dense"]["kernel"]
    )
    g_ref = g_ref.sum(axis=1)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-4, atol=1e-5)


def test_gin_parity():
    """GIN vs transcription of models/gin.py:58-128 (dropout off) with
    the n_layers loop (see module quirk note)."""
    batch = _batch()
    model = GIN(out_dim=10, hidden_dim=8, n_layers=3, dropout_ratio=0.0)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1)
    )
    g, _ = model.apply(
        {"params": variables["params"]},
        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
    )
    p = jax.device_get(variables["params"])
    h = np.asarray(p["embed"]["embedding"])[batch.atoms1]
    h0 = h.copy()
    a = batch.adj1.sum(axis=1)
    for _ in range(3):
        fv = np.einsum("bij,bjc->bic", a, h) + h
        u = p["update_0"]
        h = np.maximum(_dense(u["linear_g2"]["dense"],
                              np.maximum(_dense(u["linear_g1"]["dense"], fv), 0)), 0)
    ro = p["readout_0"]
    h1 = np.concatenate([h, h0], axis=-1)
    g_ref = (_sigmoid(_dense(ro["i"]["dense"], h1)) * _dense(ro["j"]["dense"], h1)).sum(1)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-4, atol=1e-5)


def test_edgenet_background_equivalence():
    """The factored EdgeNet must equal the direct per-pair formulation:
    in_i = sum_j M(e_ij) h_j including the M(0) non-edge background."""
    from gcnbmp_tpu.models import EdgeNet

    rng = np.random.default_rng(0)
    b, n, ch = 2, 5, 6
    h = rng.normal(size=(b, n, ch)).astype(np.float32)
    adj = np.zeros((b, 4, n, n), np.float32)
    adj[0, 0, 0, 1] = adj[0, 0, 1, 0] = 1
    adj[0, 2, 1, 2] = adj[0, 2, 2, 1] = 1
    adj[1, 1, 3, 4] = adj[1, 1, 4, 3] = 1
    net = EdgeNet(out_channels=ch)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(adj))
    out = np.asarray(net.apply(variables, jnp.asarray(h), jnp.asarray(adj)))
    p = jax.device_get(variables["params"])
    basis = np.concatenate([np.zeros((1, 4)), np.eye(4)], axis=0).astype(np.float32)
    z = np.maximum(basis @ p["nn1"]["kernel"] + p["nn1"]["bias"], 0)
    mats = (z @ p["nn2"]["kernel"] + p["nn2"]["bias"]).reshape(5, ch, ch)

    ref = np.zeros((b, n, 2 * ch), np.float32)
    for bi in range(b):
        for i in range(n):
            m_in = np.zeros(ch)
            m_out = np.zeros(ch)
            for j in range(n):
                e_in = adj[bi, :, i, j]
                e_out = adj[bi, :, j, i]
                t_in = int(np.argmax(e_in)) + 1 if e_in.any() else 0
                t_out = int(np.argmax(e_out)) + 1 if e_out.any() else 0
                m_in += mats[t_in] @ h[bi, j]
                m_out += mats[t_out] @ h[bi, j]
            ref[bi, i, :ch] = m_in
            ref[bi, i, ch:] = m_out
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_mpnn_variants():
    batch = _batch()
    for mf in ["edgenet", "ggnn"]:
        for rf in ["set2set", "ggnn"]:
            model = MPNN(out_dim=6, hidden_dim=8, n_layers=2,
                         message_func=mf, readout_func=rf)
            variables = model.init(
                jax.random.PRNGKey(0), jnp.asarray(batch.atoms1),
                jnp.asarray(batch.adj1), jnp.asarray(batch.mask1),
            )
            g, _ = model.apply(
                variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
                jnp.asarray(batch.mask1),
            )
            assert g.shape == (2, 6) and np.all(np.isfinite(np.asarray(g))), (mf, rf)


def test_nfp_readout_accumulates():
    batch = _batch()
    model = NFP(out_dim=7, hidden_dim=8, n_layers=3)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.mask1),
    )
    g, aux = model.apply(
        variables, jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
        jnp.asarray(batch.mask1),
    )
    assert g.shape == (2, 7)
    # softmax readout of masked rows excluded: each layer's dg sums to
    # (#real atoms) over channels, so total g sums to n_layers * n_atoms
    sums = np.asarray(g).sum(axis=1)
    np.testing.assert_allclose(sums, 3 * batch.mask1.sum(axis=1), rtol=1e-4)


def test_set2set_dense_matches_segment():
    """PackedSet2Set dense mode (round 4: slot-table gather + dense
    masked softmax, zero segment ops in the loop) reproduces the
    segment-op form's outputs and gradients from identical weights."""
    import numpy as np
    from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu.data.dataset import PairDataset
    from gcnbmp_tpu.data.packing import pack_pair_dataset_batch
    from gcnbmp_tpu.models import packed as packed_mod
    from gcnbmp_tpu.models.packed import PackedSet2Set

    rng = np.random.default_rng(0)
    f = GGNNFeaturizer()
    ds = PairDataset()
    smis = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O",
            "Cn1cnc2c1c(=O)n(C)c(=O)n2C"]
    for _ in range(6):
        ds.append(f(mol_from_smiles(smis[int(rng.integers(5))])),
                  f(mol_from_smiles(smis[int(rng.integers(5))])),
                  np.float32(rng.integers(0, 2)))
    packed = pack_pair_dataset_batch(ds, list(range(6)))
    num_mols = 12
    h = jnp.asarray(rng.normal(size=packed.atom_ids.shape + (16,))
                    .astype(np.float32))
    h = h * jnp.asarray(packed.node_mask)[..., None]
    mol_id = jnp.asarray(packed.mol_id)
    mask = jnp.asarray(packed.node_mask)
    mod = PackedSet2Set(16, 3, name="s2s")
    variables = mod.init(jax.random.PRNGKey(0), h, mol_id, mask, num_mols)

    def run(flag, hh):
        saved = packed_mod.SET2SET_DENSE
        packed_mod.SET2SET_DENSE = flag
        try:
            return mod.apply(variables, hh, mol_id, mask, num_mols)
        finally:
            packed_mod.SET2SET_DENSE = saved

    out_seg = run(False, h)
    out_dense = run(True, h)
    np.testing.assert_allclose(np.asarray(out_dense), np.asarray(out_seg),
                               rtol=1e-5, atol=1e-6)

    g_seg = jax.grad(lambda hh: jnp.sum(run(False, hh) ** 2))(h)
    g_dense = jax.grad(lambda hh: jnp.sum(run(True, hh) ** 2))(h)
    np.testing.assert_allclose(np.asarray(g_dense), np.asarray(g_seg),
                               rtol=1e-4, atol=1e-6)


def test_edgenet_dotgen_matches_flat():
    """Round 5: the contraction-side-transpose EdgeNet (dotgen mode —
    two dot_generals on the RAW adjacency, no (P, 2T, 4T) ``both``
    copy) reproduces the flat form's outputs and gradients through a
    full PackedMPNN forward."""
    import numpy as np
    from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu.data.dataset import PairDataset
    from gcnbmp_tpu.data.packing import pack_pair_dataset_batch
    from gcnbmp_tpu.models import packed as packed_mod
    from gcnbmp_tpu.models.packed import PackedMPNN

    rng = np.random.default_rng(1)
    f = GGNNFeaturizer()
    ds = PairDataset()
    smis = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O", "CCN"]
    for _ in range(5):
        ds.append(f(mol_from_smiles(smis[int(rng.integers(5))])),
                  f(mol_from_smiles(smis[int(rng.integers(5))])),
                  np.float32(rng.integers(0, 2)))
    b = pack_pair_dataset_batch(ds, list(range(5)))
    mod = PackedMPNN(out_dim=8, hidden_dim=8, n_layers=2, s2s_n_max=32)
    args = (jnp.asarray(b.atom_ids), jnp.asarray(b.adj),
            jnp.asarray(b.mol_id), jnp.asarray(b.node_mask), b.num_mols)
    variables = mod.init(jax.random.PRNGKey(0), *args)

    def run(dotgen, params):
        saved = packed_mod.EDGENET_DOTGEN
        packed_mod.EDGENET_DOTGEN = dotgen
        try:
            g, _ = mod.apply({"params": params}, *args)
            return g
        finally:
            packed_mod.EDGENET_DOTGEN = saved

    p0 = variables["params"]
    g_flat = run(False, p0)
    g_dot = run(True, p0)
    np.testing.assert_allclose(np.asarray(g_dot), np.asarray(g_flat),
                               rtol=1e-5, atol=1e-5)
    gr_flat = jax.grad(lambda p: jnp.sum(run(False, p)[0] ** 2))(p0)
    gr_dot = jax.grad(lambda p: jnp.sum(run(True, p)[0] ** 2))(p0)
    for (ka, a), (kb, bb) in zip(
        jax.tree_util.tree_leaves_with_path(gr_flat),
        jax.tree_util.tree_leaves_with_path(gr_dot),
    ):
        np.testing.assert_allclose(
            np.asarray(bb), np.asarray(a), rtol=1e-4, atol=1e-5,
            err_msg=jax.tree_util.keystr(ka),
        )


@pytest.mark.parametrize("module", ["mpnn", "set2set"])
def test_packed_mpnn_is_plain_xla_on_gpu_backend(monkeypatch, module):
    """No backend switch picks a kernel: with jax.default_backend()
    reporting "gpu", PackedMPNN and its dense Set2Set readout trace to the
    same XLA program as on the CPU, with no custom kernel call in it."""
    from gcnbmp_tpu.data.packing import pack_pair_dataset_batch
    from gcnbmp_tpu.models.packed import PackedMPNN, PackedSet2Set

    rng = np.random.default_rng(5)
    f = GGNNFeaturizer()
    ds = PairDataset()
    smis = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O", "CCN"]
    for _ in range(4):
        ds.append(f(mol_from_smiles(smis[int(rng.integers(5))])),
                  f(mol_from_smiles(smis[int(rng.integers(5))])),
                  np.float32(rng.integers(0, 2)))
    b = pack_pair_dataset_batch(ds, list(range(4)))
    mol_id, mask = jnp.asarray(b.mol_id), jnp.asarray(b.node_mask)
    if module == "mpnn":
        mod = PackedMPNN(out_dim=8, hidden_dim=8, n_layers=2, s2s_n_max=32)
        args = (jnp.asarray(b.atom_ids), jnp.asarray(b.adj), mol_id, mask,
                b.num_mols)
    else:
        mod = PackedSet2Set(8, 3, dense_n_max=32)
        h = jnp.asarray(rng.normal(size=b.atom_ids.shape + (8,)), jnp.float32)
        args = (h, mol_id, mask, b.num_mols)
    params = mod.init(jax.random.PRNGKey(0), *args)["params"]

    def program():
        fn = lambda p: jax.tree_util.tree_leaves(
            mod.apply({"params": p}, *args))[0]
        return str(jax.make_jaxpr(jax.grad(lambda p: jnp.sum(fn(p))))(params))

    on_cpu = program()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    on_gpu = program()
    assert on_gpu == on_cpu
    assert "pallas_call" not in on_gpu and "custom_call" not in on_gpu
