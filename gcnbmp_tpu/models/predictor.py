"""Pair predictor: Siamese encoder composition + optional co-attention +
scoring head.

Reference: GraphConvPredictorForPair (train_ddi_modify_eval2.py:53-127),
co-attention variant (train_binary.py:59-141), research options
(train_ddi_modify_eval3.py:59-165 ``siamese=False``), and the
``set_up_predictor`` factory (train_ddi_modify_eval2.py:246-314).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.heads import HEADS


class PairPredictor(nn.Module):
    """predictor(atoms_1, adj_1, atoms_2, adj_2) -> logits.

    Attributes:
        encoder/encoder2: graph encoders; encoder2 is created only when
            ``siamese=False`` (separate weights for the second molecule,
            reference train_ddi_modify_eval3.py:59-165).
        coattention: optional pair-interaction module applied between
            encoding and scoring (reference train_binary.py:91-96).
        symmetric: None | 'or' | 'and' — max/min over both pair orderings
            (reference train_ddi_modify_eval2.py:106-127).
        mask_padding: if True, padded atoms are masked out of readout and
            co-attention (corrected behavior); False reproduces the
            reference's live-padding quirk for parity testing.
    """

    encoder: nn.Module
    head: nn.Module
    encoder2: Optional[nn.Module] = None
    coattention: Optional[nn.Module] = None
    symmetric: Optional[str] = None
    mask_padding: bool = True

    @property
    def siamese(self) -> bool:
        return self.encoder2 is None

    def _score(
        self, atoms1, adj1, mask1, atoms2, adj2, mask2, deterministic
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        m1 = mask1 if self.mask_padding else None
        m2 = mask2 if self.mask_padding else None
        enc2 = self.encoder if self.encoder2 is None else self.encoder2
        g1, aux1 = self.encoder(atoms1, adj1, m1, deterministic=deterministic)
        g2, aux2 = enc2(atoms2, adj2, m2, deterministic=deterministic)
        if self.coattention is not None:
            g1, g2 = self.coattention(aux1["atoms"], g1, aux2["atoms"], g2, m1, m2)
        logits = self.head(g1, g2)
        return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}

    @nn.compact
    def __call__(
        self,
        atoms1: jnp.ndarray,
        adj1: jnp.ndarray,
        atoms2: jnp.ndarray,
        adj2: jnp.ndarray,
        mask1: Optional[jnp.ndarray] = None,
        mask2: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        return_aux: bool = False,
    ):
        logits, aux = self._score(
            atoms1, adj1, mask1, atoms2, adj2, mask2, deterministic
        )
        if self.symmetric is not None:
            logits_rev, _ = self._score(
                atoms2, adj2, mask2, atoms1, adj1, mask1, deterministic
            )
            if self.symmetric == "or":
                logits = jnp.maximum(logits, logits_rev)
            elif self.symmetric == "and":
                logits = jnp.minimum(logits, logits_rev)
            else:
                raise ValueError(f"symmetric={self.symmetric!r}")
        if return_aux:
            return logits, aux
        return logits


class ResearchPairPredictor(nn.Module):
    """The eval3 research predictor (reference train_ddi_modify_eval3.py:
    59-165): encoder must expose per-layer atom states and per-layer
    readouts (the GGNNDev family); co-attention consumes
    concat(first-layer, last-layer) atom states; optional LSTMs over the
    per-layer readout sequences:

    - use_s_lstm: one LSTM per molecule side over [g_layer1..g_layerL],
      last output appended to the pair representation;
    - use_i_lstm: one LSTM over the concatenated per-layer readout pairs.

    Quirk note: in the reference the aggregated vector is overwritten by
    ``g = F.concat((g1, g2))`` immediately before the MLP
    (train_ddi_modify_eval3.py:158-160), silently discarding the LSTM
    outputs; and non-MLP heads never see them.  Here the documented
    intent is implemented: MLP heads consume the full concatenation.
    """

    encoder: nn.Module
    head: nn.Module
    coattention: Optional[nn.Module] = None
    encoder2: Optional[nn.Module] = None
    use_s_lstm: bool = False
    use_i_lstm: bool = False

    def _lstm_last(self, cell, seq):
        b = seq[0].shape[0]
        carry = jax.tree.map(
            jnp.zeros_like,
            cell.initialize_carry(jax.random.PRNGKey(0), (b, seq[0].shape[-1])),
        )
        y = None
        for x in seq:
            carry, y = cell(carry, x)
        return y

    @nn.compact
    def __call__(self, atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
                 deterministic=True, return_aux=False):
        enc2 = self.encoder if self.encoder2 is None else self.encoder2
        g1, aux1 = self.encoder(atoms1, adj1, mask1, deterministic=deterministic)
        g2, aux2 = enc2(atoms2, adj2, mask2, deterministic=deterministic)
        a1 = jnp.concatenate([aux1["h_list"][0], aux1["h_list"][-1]], axis=-1)
        a2 = jnp.concatenate([aux2["h_list"][0], aux2["h_list"][-1]], axis=-1)
        extras_left, extras_right = [], []
        if self.use_s_lstm:
            d = aux1["g_list"][0].shape[-1]
            s1 = self._lstm_last(
                nn.OptimizedLSTMCell(d, name="s_lstm_1"), aux1["g_list"]
            )
            s2 = self._lstm_last(
                nn.OptimizedLSTMCell(d, name="s_lstm_2"), aux2["g_list"]
            )
            extras_left.append(s1)
            extras_right.append(s2)
        if self.use_i_lstm:
            seq = [
                jnp.concatenate([ga, gb], axis=-1)
                for ga, gb in zip(aux1["g_list"], aux2["g_list"])
            ]
            mid = self._lstm_last(
                nn.OptimizedLSTMCell(seq[0].shape[-1], name="i_lstm"), seq
            )
            extras_right.insert(0, mid)
        if self.coattention is not None:
            g1, g2 = self.coattention(a1, g1, a2, g2, mask1, mask2)
        from gcnbmp_tpu.models.heads import MLPHead

        if isinstance(self.head, MLPHead) and (extras_left or extras_right):
            left = jnp.concatenate([g1] + extras_left, axis=-1)
            right = jnp.concatenate(extras_right + [g2], axis=-1)
            logits = self.head(left, right)
        else:
            logits = self.head(g1, g2)
        if return_aux:
            return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}
        return logits


class FixedEmbeddingPredictor(nn.Module):
    """Scoring heads over fixed precomputed drug embeddings —
    the reference's DDIPredictor for mol2vec / autoencoder / SSP features
    (mol2vec_based_model.py:23-77, unsupervised_feature.py:41-95)."""

    head: nn.Module
    symmetric: Optional[str] = None

    @nn.compact
    def __call__(self, e1: jnp.ndarray, e2: jnp.ndarray):
        logits = self.head(e1, e2)
        if self.symmetric is not None:
            rev = self.head(e2, e1)
            logits = (
                jnp.maximum(logits, rev)
                if self.symmetric == "or"
                else jnp.minimum(logits, rev)
            )
        return logits


def predict_proba(predictor, params, atoms1, adj1, atoms2, adj2,
                  mask1=None, mask2=None):
    """sigmoid probabilities + pair embeddings — the reference
    ``predictor.predict`` contract (train_ddi_modify_eval2.py:106-127,
    consumed by eval_coattention's MyEvaluator)."""
    logits, aux = predictor.apply(
        {"params": params}, atoms1, adj1, atoms2, adj2, mask1, mask2,
        deterministic=True, return_aux=True,
    )
    return jax.nn.sigmoid(logits), (aux["g1"], aux["g2"])


def set_up_predictor(
    method: str = "ggnn",
    fp_hidden_dim: int = 16,
    fp_out_dim: int = 16,
    conv_layers: int = 4,
    concat_hidden: bool = False,
    layer_aggregator: Optional[str] = None,
    fp_dropout_rate: float = 0.0,
    fp_batch_normalization: bool = False,
    weight_tying: bool = True,
    attention: Optional[str] = None,
    update_attention: bool = False,
    context: bool = False,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims: Tuple[int, ...] = (),
    attn_model: Optional[str] = None,
    siamese: bool = True,
    symmetric: Optional[str] = None,
    mask_padding: bool = True,
) -> PairPredictor:
    """Factory mapping --method x --sim-method (x --attn) strings to a
    composed PairPredictor (reference: train_ddi_modify_eval2.py:246-314,
    train_binary.py:144-282)."""
    from gcnbmp_tpu.models import ENCODERS
    from gcnbmp_tpu.models.coattention import build_coattention

    if method == "ggnn-gwm":
        # GGNN + Graph Warp Module (reference train_ggnn_hole_with_gwm.py)
        from gcnbmp_tpu.models.gwm import GGNN_GWM, GWMPairPredictor

        if sim_method not in HEADS:
            raise ValueError(f"unknown sim_method {sim_method!r}")
        head_kwargs: Dict[str, Any] = {"out_dim": class_num}
        if sim_method in ("hole", "mlp", "symmlp", "ntn", "dist-mult"):
            head_kwargs["hidden_dims"] = tuple(net_hidden_dims)
        return GWMPairPredictor(
            encoder=GGNN_GWM(
                out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
                hidden_dim_super=fp_hidden_dim, n_layers=conv_layers,
                dropout_ratio=fp_dropout_rate, concat_hidden=concat_hidden,
                weight_tying=weight_tying, name="encoder",
            ),
            head=HEADS[sim_method](name="head", **head_kwargs),
            symmetric=symmetric,
        )

    if method not in ENCODERS:
        raise ValueError(f"unknown encoder method {method!r}")

    def make_encoder(name: str) -> nn.Module:
        return ENCODERS[method](
            name=name,
            out_dim=fp_out_dim,
            hidden_dim=fp_hidden_dim,
            n_layers=conv_layers,
            concat_hidden=concat_hidden,
            layer_aggregator=layer_aggregator,
            dropout_rate=fp_dropout_rate,
            batch_normalization=fp_batch_normalization,
            weight_tying=weight_tying,
            # GGNN-only research options (reference --attention /
            # --update-attention / --context flags); non-GGNN encoders
            # raise instead of silently ignoring them
            attention=attention,
            update_attention=update_attention,
            context=context,
        )

    if sim_method not in HEADS:
        raise ValueError(f"unknown sim_method {sim_method!r}")
    head_kwargs: Dict[str, Any] = {"out_dim": class_num}
    if sim_method in ("hole", "mlp", "symmlp", "ntn", "dist-mult"):
        head_kwargs["hidden_dims"] = tuple(net_hidden_dims)
    head = HEADS[sim_method](name="head", **head_kwargs)

    coattention = None
    if attn_model is not None:
        coattention = build_coattention(
            attn_model, hidden_dim=fp_hidden_dim, out_dim=fp_out_dim
        )

    return PairPredictor(
        encoder=make_encoder("encoder"),
        encoder2=None if siamese else make_encoder("encoder2"),
        head=head,
        coattention=coattention,
        symmetric=symmetric,
        mask_padding=mask_padding,
    )
