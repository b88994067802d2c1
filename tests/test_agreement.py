"""eval/agreement: the packed COO path against the padded float32
reference on one parameter tree (chip_smoke.py phase c), at small size."""

import jax.numpy as jnp
import numpy as np
import pytest

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset
from gcnbmp_tpu.eval.agreement import packed_and_reference_logits
from gcnbmp_tpu.train import TrainConfig, Trainer

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O", "CCN",
          "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "OCC(O)CO"]


def _ds(n=24):
    rng = np.random.default_rng(0)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n):
        ds.append(f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  np.float32(rng.integers(0, 2)))
    return ds


@pytest.mark.parametrize("dtype,bound", [(None, 1e-5), (jnp.bfloat16, 5e-2)])
def test_packed_path_agrees_with_padded_reference(tmp_path, dtype, bound):
    cfg = TrainConfig(method="ggnn", sim_method="hole", fp_hidden_dim=8,
                      fp_out_dim=8, conv_layers=3, weight_tying=False,
                      compute_path="coo", out_dir=str(tmp_path))
    ds = _ds()
    trainer = Trainer(cfg, ds, None)
    params = trainer._init_state().params
    path, ref, labels = packed_and_reference_logits(
        cfg, params, ds, trainer.predictor, batch_size=10,
        compute_dtype=dtype, path_precision="highest" if dtype is None else None)
    assert path.shape == ref.shape == labels.shape == (len(ds),)
    np.testing.assert_array_equal(labels, np.asarray(ds.labels))
    assert np.max(np.abs(path - ref)) <= bound
