"""Co-attention family over drug-pair atom representations.

All 14 reference variants (models/coattention/, selected by --attn at
train_binary.py:190-259 and eval3's global/dual-global/neural), with the
shared signature

    attn(atoms_1 [B,N1,H], g_1 [B,D], atoms_2 [B,N2,H], g_2 [B,D],
         mask1=None, mask2=None) -> (compact_1 [B,D'], compact_2 [B,D'])

Re-design: the reference materializes (mb*N1*N2, hidden) tiles to feed
chainer Bilinear row-wise (e.g. nie_coattention.py:372-396 — its
"pairwise hot loop"); here every pairwise energy is an einsum
(SDDMM-style) that XLA lowers to batched matmuls with no data blow-up.

Masking: the reference runs on pad-to-max batches with no atom masking.
Pass mask1/mask2 (1 = real atom) for corrected padded behavior; None
reproduces the reference exactly (for parity tests).

Quirk triage (SURVEY §7 hard part 5):
- AlternatingCoattention with weight_tying=False indexes a 1-element
  ChainList out of range in the reference (alternating_coattention.py:
  26-28,76); here untied weights are simply implemented correctly.
- LinearTransformFineCoattention re-creates persistent (untrainable,
  zero-on-CPU) projections every forward (lt_fine_coattention.py:44-55);
  here they are ordinary trainable params sized by the padded N.
- BiMPM's matching function computes cos(W_k*v1, W_0*v2) (bimpm.py:80
  ``sim[:, :, :, 0]``) where the cited paper uses the diagonal
  cos(W_k*v1, W_k*v2); here the diagonal is used.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import GraphLinear, LecunNormal
from gcnbmp_tpu.ops.circular import circular_correlation_auto

COATTENTION_REGISTRY: Dict[str, Type[nn.Module]] = {}

NEG_INF = -1e9


def register(name: str):
    def deco(cls):
        COATTENTION_REGISTRY[name] = cls
        return cls

    return deco


def masked_softmax(x: jnp.ndarray, mask: Optional[jnp.ndarray], axis: int) -> jnp.ndarray:
    """softmax with optional mask (mask broadcastable to x; 1 = keep)."""
    if mask is not None:
        x = jnp.where(mask > 0, x, NEG_INF)
    out = jax.nn.softmax(x, axis=axis)
    if mask is not None:
        out = out * (mask > 0)
    return out


def masked_mean(x: jnp.ndarray, mask: Optional[jnp.ndarray], axis: int) -> jnp.ndarray:
    if mask is None:
        return jnp.mean(x, axis=axis)
    m = mask[..., None] if mask.ndim == x.ndim - 1 else mask
    s = jnp.sum(x * m, axis=axis)
    return s / jnp.maximum(jnp.sum(m, axis=axis), 1.0)


class PairBilinear(nn.Module):
    """Pairwise bilinear energy E[b,i,j] = act(key_i^T W query_j + V1 key_i
    + V2 query_j + b) — chainer links.Bilinear(hidden, hidden, 1) applied
    to every (i, j) pair, without the reference's N1*N2 tiling."""

    activation: Callable = jnp.tanh

    @nn.compact
    def __call__(
        self, key: jnp.ndarray, query: jnp.ndarray
    ) -> jnp.ndarray:  # (B, Nq, Nk) per reference orientation
        h_k, h_q = key.shape[-1], query.shape[-1]
        w = self.param("W", LecunNormal(), (h_k, h_q))
        v1 = self.param("V1", LecunNormal(), (h_k, 1))
        v2 = self.param("V2", LecunNormal(), (h_q, 1))
        b = self.param("b", nn.initializers.zeros, ())
        # E[b, q, k] = key_k W . query_q  (reference reshapes to
        # (mb, N_query, N_key) — query index is the middle axis)
        e = jnp.einsum("bkh,hg,bqg->bqk", key, w, query)
        e = e + jnp.swapaxes(key @ v1, -1, -2)  # (B, 1, Nk)
        e = e + (query @ v2)  # (B, Nq, 1)
        return self.activation(e + b)


@register("alter")
class AlternatingCoattention(nn.Module):
    """Sequential: attend mol1 with query g2, then mol2 with query
    compact_1 (reference: alternating_coattention.py:11-86)."""

    hidden_dim: int
    out_dim: int
    head: int = 8
    weight_tying: bool = True

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n_ent = 1 if self.weight_tying else 2
        e1 = [GraphLinear(self.head, name=f"energy1_{i}") for i in range(n_ent)]
        e2 = [GraphLinear(1, name=f"energy2_{i}") for i in range(n_ent)]
        j_layer = GraphLinear(self.out_dim, name="j")

        def attend(query, key, mask, idx):
            n = key.shape[1]
            q = jnp.broadcast_to(query[:, None, :], (key.shape[0], n, query.shape[-1]))
            energy = e2[idx](jnp.tanh(e1[idx](jnp.concatenate([q, key], axis=-1))))
            return masked_softmax(energy, None if mask is None else mask[..., None], axis=1)

        a1 = attend(g2, atoms1, mask1, 0)
        z1 = a1 * j_layer(atoms1)
        if mask1 is not None:
            z1 = z1 * mask1[..., None]
        compact1 = jnp.sum(z1, axis=1)
        a2 = attend(compact1, atoms2, mask2, 0 if self.weight_tying else 1)
        z2 = a2 * j_layer(atoms2)
        if mask2 is not None:
            z2 = z2 * mask2[..., None]
        return compact1, jnp.sum(z2, axis=1)


@register("para")
class ParallelCoattention(nn.Module):
    """Bilinear gate energy(atom, other-mol g), tanh, both sides
    independently; NOT normalized (no softmax) — reference:
    parallel_coattention.py:12-84 (head=1 at the call site)."""

    hidden_dim: int
    out_dim: int
    head: int = 1
    weight_tying: bool = True

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n_ent = 1 if self.weight_tying else 2
        j_layer = GraphLinear(self.out_dim, name="j")

        def bilin(idx):
            w = self.param(f"W_{idx}", LecunNormal(), (self.hidden_dim, g1.shape[-1], self.head))
            v1 = self.param(f"V1_{idx}", LecunNormal(), (self.hidden_dim, self.head))
            v2 = self.param(f"V2_{idx}", LecunNormal(), (g1.shape[-1], self.head))
            b = self.param(f"b_{idx}", nn.initializers.zeros, (self.head,))
            return w, v1, v2, b

        params = [bilin(i) for i in range(n_ent)]

        def attend(query, key, idx):
            w, v1, v2, b = params[idx]
            e = jnp.einsum("bnh,hdk,bd->bnk", key, w, query)
            e = e + key @ v1 + (query @ v2)[:, None, :] + b
            return jnp.tanh(e)

        a1 = attend(g2, atoms1, 0)
        z1 = a1 * j_layer(atoms1)
        if mask1 is not None:
            z1 = z1 * mask1[..., None]
        a2 = attend(g1, atoms2, 0 if self.weight_tying else 1)
        z2 = a2 * j_layer(atoms2)
        if mask2 is not None:
            z2 = z2 * mask2[..., None]
        return jnp.sum(z1, axis=1), jnp.sum(z2, axis=1)


@register("circ")
class CircularParallelCoattention(nn.Module):
    """Gate = tanh(circular_correlation_auto(j(atom), other g)) — reference:
    parallel_coattention.py:87-184."""

    hidden_dim: int
    out_dim: int

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        j_layer = GraphLinear(self.out_dim, name="j")

        def side(atoms, g_other, mask):
            a = j_layer(atoms)
            gate = jnp.tanh(
                circular_correlation_auto(a, jnp.broadcast_to(g_other[:, None, :], a.shape))
            )
            z = gate * a
            if mask is not None:
                z = z * mask[..., None]
            return jnp.sum(z, axis=1)

        return side(atoms1, g2, mask1), side(atoms2, g1, mask2)


class _AffinityCoattentionBase(nn.Module):
    """Shared VQA/Nie skeleton: full affinity C (B, N2, N1) via pairwise
    bilinear; row/col softmax; H = tanh(lt + L @ lt_other); per-atom attn
    -> weighted sum of j(atoms) (reference: vqa_parallel_coattention.py:
    42-103 and nie_coattention.py)."""

    hidden_dim: int = 16
    out_dim: int = 16
    head: int = 8
    n_prev_layers: int = 0  # 0=vqa/nie, 1=deep, 2=very-deep, 3=extreme-deep
    affinity_activation: Callable = jnp.tanh

    def _tail(self, c, atoms1, atoms2, mask1, mask2):
        """From affinity C (B, N2, N1) to (compact_1, compact_2)."""
        # L_2: softmax over N2 (axis=1 of C); L_1: softmax over N1 of C^T
        l2 = masked_softmax(c, None if mask2 is None else mask2[..., None], axis=1)
        l1 = masked_softmax(
            jnp.swapaxes(c, 1, 2),
            None if mask1 is None else mask1[..., None],
            axis=1,
        )
        # zero out columns belonging to padded atoms of the summed-over side
        if mask2 is not None:
            l1 = l1 * mask2[:, None, :]
        if mask1 is not None:
            l2 = l2 * mask1[:, None, :]
        for i in range(self.n_prev_layers):
            atoms1 = GraphLinear(self.hidden_dim, name=f"prev1_{i}")(atoms1)
            atoms2 = GraphLinear(self.hidden_dim, name=f"prev2_{i}")(atoms2)
        lt1 = GraphLinear(self.head, use_bias=False, name="lt1")(atoms1)
        lt2 = GraphLinear(self.head, use_bias=False, name="lt2")(atoms2)
        h1 = jnp.tanh(lt1 + jnp.einsum("bij,bjh->bih", l1, lt2))
        h2 = jnp.tanh(lt2 + jnp.einsum("bij,bjh->bih", l2, lt1))
        a1 = masked_softmax(
            GraphLinear(1, use_bias=False, name="attn1")(h1),
            None if mask1 is None else mask1[..., None], axis=1,
        )
        a2 = masked_softmax(
            GraphLinear(1, use_bias=False, name="attn2")(h2),
            None if mask2 is None else mask2[..., None], axis=1,
        )
        j_layer = GraphLinear(self.out_dim, name="j")
        z1 = a1 * j_layer(atoms1)
        z2 = a2 * j_layer(atoms2)
        if mask1 is not None:
            z1 = z1 * mask1[..., None]
        if mask2 is not None:
            z2 = z2 * mask2[..., None]
        return jnp.sum(z1, axis=1), jnp.sum(z2, axis=1)

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        # C[b, i in mol2, j in mol1]
        c = PairBilinear(self.affinity_activation, name="energy")(atoms1, atoms2)
        return self._tail(c, atoms1, atoms2, mask1, mask2)


@register("vqa")
class VQAParallelCoattention(_AffinityCoattentionBase):
    """Lu et al. VQA-style parallel co-attention
    (reference: vqa_parallel_coattention.py:13-103)."""

    affinity_activation: Callable = jnp.tanh


@register("nie")
class NieFineCoattention(_AffinityCoattentionBase):
    """Nie-style fine-grained co-attention; the call site passes
    activation=tanh (reference: nie_coattention.py:312-396,
    train_binary.py:225-228)."""


@register("deep")
class DeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers: int = 1


@register("very-deep")
class VeryDeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers: int = 2


@register("extreme-deep")
class ExtremeDeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers: int = 3


@register("fourier")
class FourierFineCoattention(_AffinityCoattentionBase):
    """Affinity computed on FFT(real)+FFT(imag) parts of atom features
    with a shared bilinear (reference: nie_coattention.py:399-515)."""

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        f1 = jnp.fft.fft(atoms1.astype(jnp.complex64), axis=-1)
        f2 = jnp.fft.fft(atoms2.astype(jnp.complex64), axis=-1)
        # one shared bilinear applied to real and imaginary parts
        # (reference sums energy_layer(real) + energy_layer(imag) then tanh)
        bilinear = PairBilinear(lambda x: x, name="energy")
        c = jnp.tanh(
            bilinear(jnp.real(f1), jnp.real(f2))
            + bilinear(jnp.imag(f1), jnp.imag(f2))
        )
        return self._tail(c, atoms1, atoms2, mask1, mask2)


@register("pool")
class PoolingFineCoattention(nn.Module):
    """Affinity matrix -> mean over rows/cols -> per-atom softmax
    (reference: PoolingFineCoattention.py:13-83)."""

    hidden_dim: int
    out_dim: int

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        c = PairBilinear(jnp.tanh, name="energy")(atoms1, atoms2)  # (B, N2, N1)
        e1 = masked_mean(c, None if mask2 is None else mask2[..., None], axis=1)  # (B, N1)
        e2 = masked_mean(
            jnp.swapaxes(c, 1, 2), None if mask1 is None else mask1[..., None], axis=1
        )  # (B, N2)
        a1 = masked_softmax(e1, mask1, axis=1)[..., None]
        a2 = masked_softmax(e2, mask2, axis=1)[..., None]
        j_layer = GraphLinear(self.out_dim, name="j")
        return (
            jnp.sum(a1 * j_layer(atoms1), axis=1),
            jnp.sum(a2 * j_layer(atoms2), axis=1),
        )


@register("lt")
class LinearTransformFineCoattention(nn.Module):
    """attn_1 = C^T W1, attn_2 = C W2 with position-indexed projections
    (reference: lt_fine_coattention.py:14-90; see module quirk notes)."""

    hidden_dim: int
    out_dim: int

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n1, n2 = atoms1.shape[1], atoms2.shape[1]
        c = PairBilinear(jnp.tanh, name="energy")(atoms1, atoms2)  # (B, N2, N1)
        w1 = self.param("W1", nn.initializers.glorot_normal(), (n2, self.out_dim))
        w2 = self.param("W2", nn.initializers.glorot_normal(), (n1, self.out_dim))
        a1 = jnp.einsum("bji,jd->bid", c, w1)  # C^T @ W1: (B, N1, D), sum over N2
        a2 = jnp.einsum("bij,jd->bid", c, w2)  # C @ W2:   (B, N2, D), sum over N1
        j_layer = GraphLinear(self.out_dim, name="j")
        z1 = a1 * j_layer(atoms1)
        z2 = a2 * j_layer(atoms2)
        if mask1 is not None:
            z1 = z1 * mask1[..., None]
        if mask2 is not None:
            z2 = z2 * mask2[..., None]
        return jnp.sum(z1, axis=1), jnp.sum(z2, axis=1)


@register("global")
class GlobalCoattention(nn.Module):
    """Per-dim sigmoid gate from [atom ‖ other-mol mean]
    (reference: global_coattention.py:12-74)."""

    hidden_dim: int
    out_dim: int
    weight_tying: bool = True

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n_ent = 1 if self.weight_tying else 2
        att = [nn.Dense(self.out_dim, kernel_init=LecunNormal(), name=f"att_{i}")
               for i in range(n_ent)]
        lt = GraphLinear(self.out_dim, name="lt")
        ig1 = masked_mean(atoms1, mask1, axis=1)
        ig2 = masked_mean(atoms2, mask2, axis=1)

        def side(atoms, q, mask, idx):
            n = atoms.shape[1]
            qq = jnp.broadcast_to(q[:, None, :], (atoms.shape[0], n, q.shape[-1]))
            gate = jax.nn.sigmoid(att[idx](jnp.concatenate([atoms, qq], axis=-1)))
            z = gate * lt(atoms)
            if mask is not None:
                z = z * mask[..., None]
            return jnp.sum(z, axis=1)

        return (
            side(atoms1, ig2, mask1, 0),
            side(atoms2, ig1, mask2, 0 if self.weight_tying else 1),
        )


@register("dual-global")
class DualGlobalCoattention(nn.Module):
    """Gate from [atom ‖ other-mol mean ‖ own-mol mean].  The reference
    file's __call__/compute_attention signatures are inconsistent (it
    would raise TypeError as written, dual_global_coattention.py:40-80);
    implemented per its documented intent (query = initial + other-entity
    global)."""

    hidden_dim: int
    out_dim: int
    weight_tying: bool = True

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n_ent = 1 if self.weight_tying else 2
        att = [nn.Dense(self.out_dim, kernel_init=LecunNormal(), name=f"att_{i}")
               for i in range(n_ent)]
        lt = GraphLinear(self.out_dim, name="lt")
        ig1 = masked_mean(atoms1, mask1, axis=1)
        ig2 = masked_mean(atoms2, mask2, axis=1)

        def side(atoms, other_g, own_g, mask, idx):
            n = atoms.shape[1]
            o = jnp.broadcast_to(other_g[:, None, :], (atoms.shape[0], n, other_g.shape[-1]))
            s = jnp.broadcast_to(own_g[:, None, :], (atoms.shape[0], n, own_g.shape[-1]))
            gate = jax.nn.sigmoid(att[idx](jnp.concatenate([atoms, o, s], axis=-1)))
            z = gate * lt(atoms)
            if mask is not None:
                z = z * mask[..., None]
            return jnp.sum(z, axis=1)

        return (
            side(atoms1, ig2, ig1, mask1, 0),
            side(atoms2, ig1, ig2, mask2, 0 if self.weight_tying else 1),
        )


@register("neural")
class NeuralCoattention(nn.Module):
    """doc/context transform + sigmoid(doc . context) gate
    (reference: neural_coattention.py:11-72)."""

    hidden_dim: int
    out_dim: int
    weight_tying: bool = True
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n_ent = 1 if self.weight_tying else 2
        att = [GraphLinear(self.out_dim, name=f"att_{i}") for i in range(n_ent)]
        ig1 = masked_mean(atoms1, mask1, axis=1)
        ig2 = masked_mean(atoms2, mask2, axis=1)

        def side(atoms, q, mask, idx):
            context = self.activation(att[idx](q[:, None, :]))  # (B, 1, D)
            doc = self.activation(att[idx](atoms))  # (B, N, D)
            energy = jax.nn.sigmoid(
                jnp.einsum("bnd,bod->bno", doc, context)
            )  # (B, N, 1)
            z = energy * doc
            if mask is not None:
                z = z * mask[..., None]
            return jnp.sum(z, axis=1)

        return (
            side(atoms1, ig2, mask1, 0),
            side(atoms2, ig1, mask2, 0 if self.weight_tying else 1),
        )


@register("bimpm")
class BiMPM(nn.Module):
    """Bilateral multi-perspective matching (reference: bimpm.py:17-197).

    Output dim = num_enabled_matchers * head (the reference's out_layer is
    commented out; downstream heads infer input width)."""

    hidden_dim: int
    out_dim: int  # used as head count, matching the call site head=fp_out_dim
    with_max_pool: bool = True
    with_att_mean: bool = True
    with_att_max: bool = True
    eps: float = 1e-4

    @nn.compact
    def __call__(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        head = self.out_dim

        def norm(v, axis):
            # eps inside the sqrt keeps gradients finite at v == 0
            # (zero vectors occur for masked/padded atoms)
            return v * jax.lax.rsqrt(
                jnp.sum(v * v, axis=axis, keepdims=True) + 1e-12
            )

        def match(v1, v2, w):
            """m[b,n,k] = cos(w_k * v1[b,n], w_k * v2[b,n]) (diagonal; see
            module quirk notes re: reference's column-0 indexing)."""
            a = v1[..., None, :] * w  # (B, N, head, H)
            b = v2[..., None, :] * w
            return jnp.sum(norm(a, -1) * norm(b, -1), axis=-1)

        def match_pairwise(v1, v2, w):
            a = norm(v1[:, :, None, :] * w[None, None], -1)  # (B, N1, head, H)
            b = norm(v2[:, :, None, :] * w[None, None], -1)  # (B, N2, head, H)
            return jnp.einsum("bikh,bjkh->bijk", a, b)  # (B, N1, N2, head)

        mv1, mv2 = [], []
        pair_mask = None
        if mask1 is not None and mask2 is not None:
            pair_mask = mask1[:, :, None] * mask2[:, None, :]  # (B, N1, N2)

        if self.with_max_pool:
            w = self.param("max_pooling_W", nn.initializers.he_normal(), (head, self.hidden_dim))
            mv = match_pairwise(atoms1, atoms2, w)
            if pair_mask is not None:
                mv = jnp.where(pair_mask[..., None] > 0, mv, NEG_INF)
            mv1.append(jnp.max(mv, axis=2))
            mv2.append(jnp.max(mv, axis=1))

        if self.with_att_mean or self.with_att_max:
            att = jnp.einsum(
                "bih,bjh->bij", norm(atoms1, -1), norm(atoms2, -1)
            )  # (B, N1, N2)
            if pair_mask is not None:
                att = att * pair_mask
            att_atoms2 = atoms2[:, None, :, :] * att[..., None]  # (B, N1, N2, H)
            att_atoms1 = atoms1[:, :, None, :] * att[..., None]  # (B, N1, N2, H)
            if self.with_att_mean:
                w = self.param("att_mean_W", nn.initializers.he_normal(), (head, self.hidden_dim))
                mean2 = jnp.sum(att_atoms2, axis=2) / jnp.maximum(
                    jnp.sum(att, axis=2, keepdims=True), self.eps
                )
                mean1 = jnp.sum(att_atoms1, axis=1) / jnp.maximum(
                    jnp.swapaxes(jnp.sum(att, axis=1, keepdims=True), 1, 2), self.eps
                )
                mv1.append(match(atoms1, mean2, w))
                mv2.append(match(atoms2, mean1, w))
            if self.with_att_max:
                w = self.param("att_max_W", nn.initializers.he_normal(), (head, self.hidden_dim))
                mv1.append(match(atoms1, jnp.max(att_atoms2, axis=2), w))
                mv2.append(match(atoms2, jnp.max(att_atoms1, axis=1), w))

        m1 = jnp.concatenate(mv1, axis=-1)
        m2 = jnp.concatenate(mv2, axis=-1)
        if mask1 is not None:
            m1 = m1 * mask1[..., None]
        if mask2 is not None:
            m2 = m2 * mask2[..., None]
        return jnp.sum(m1, axis=1), jnp.sum(m2, axis=1)


def build_coattention(name: str, hidden_dim: int, out_dim: int) -> nn.Module:
    """Factory mirroring the --attn dispatch (train_binary.py:190-259)."""
    if name not in COATTENTION_REGISTRY:
        raise ValueError(
            f"unknown co-attention {name!r}; available: "
            f"{sorted(COATTENTION_REGISTRY)}"
        )
    return COATTENTION_REGISTRY[name](
        hidden_dim=hidden_dim, out_dim=out_dim, name=f"coattn_{name.replace('-', '_')}"
    )
