"""gcnbmp_tpu — a JAX graph message-passing framework for drug-drug
interaction prediction.

A from-scratch JAX/XLA framework providing the model families and
pipelines of the GCN-BMP drug-drug-interaction codebase (reference:
Minys233/GCN-BMP), redesigned around static shapes and packed batches:

- ``chem``     SMILES -> molecular graph featurization (no RDKit dependency;
               pure-Python reference parser + native C++ fast path).
- ``data``     pair-CSV parsing, pad/bucket batching, packed supergraph
               layout, dataset splitting tools.
- ``ops``      XLA ops for the hot paths: edge-type message aggregation,
               the on-device COO adjacency build, slot-table gathers,
               circular correlation.
- ``nn``       the small flax.linen-style module system the models use.
- ``models``   modules: GGNN/RelGCN/GIN/MPNN/NFP encoders,
               co-attention family, link-prediction heads, pair predictor.
- ``train``    typed configs, training loop, metrics, checkpoints, LR
               schedules (exponential-shift + cyclical).
- ``parallel`` jax.sharding meshes, data-parallel and edge-partitioned
               train steps.
- ``eval``     offline evaluation, embedding export, saliency, similarity.
"""

__version__ = "0.1.0"
