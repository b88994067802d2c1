"""Circular correlation (the HolE pair scorer hot op).

Semantics (reference: models/link_prediction/hole.py:69-91):
``ifft(conj(fft(a)) * fft(b)).real`` — the reference implements it with
explicit real/imag FFT pairs because Chainer lacked complex support.

Real-input FFTs via ``jnp.fft.rfft`` halve the spectrum work and XLA
lowers them natively.  A time-domain formulation is also provided: for
dim D the correlation equals ``corr[k] = sum_d a[d] * b[(d + k) mod D]``
— a (D, D) matmul against a rolled copy of ``b`` that avoids FFT
entirely.  ``circular_correlation_auto`` picks the form by D
(MATMUL_MAX_D).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# time-domain matmul form up to this D, rfft above.  Device time of one
# fwd+bwd at B=2048 on an NVIDIA H100 80GB HBM3 (400 W limit;
# chip_smoke.py phase d, chained in one jitted scan): D=16 matmul 12.3 us
# vs rfft 36.4 us; D=32 matmul 32.1 vs rfft 45.5 us; D=64 rfft 48.6 vs
# matmul 115.6 us.
MATMUL_MAX_D = 32


def _check_shapes(a, b):
    if a.shape != b.shape:
        raise ValueError(
            "circular correlation needs operands of the same shape, got "
            f"{a.shape} and {b.shape}")


def _corr_raw(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    fa = jnp.fft.rfft(a.astype(jnp.float32), axis=-1)
    fb = jnp.fft.rfft(b.astype(jnp.float32), axis=-1)
    return jnp.fft.irfft(jnp.conj(fa) * fb, n=a.shape[-1], axis=-1)


def _conv_raw(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Circular convolution conv(a, b)[..., j] = sum_k a[k] b[(j-k)%D]."""
    fa = jnp.fft.rfft(a.astype(jnp.float32), axis=-1)
    fb = jnp.fft.rfft(b.astype(jnp.float32), axis=-1)
    return jnp.fft.irfft(fa * fb, n=a.shape[-1], axis=-1)


@jax.custom_vjp
def circular_correlation(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """corr(a, b)[..., k] = sum_d a[..., d] * b[..., (d + k) % D].

    Ships a closed-form REAL-valued VJP: the adjoints of circular
    correlation are themselves circular ops —
    ``grad_a = corr(g, b)`` and ``grad_b = conv(g, a)`` — so the
    backward never transposes an FFT (complex cotangents through
    rfft/irfft break shard_map's varying-axis checking, and the
    forward-mode-only FFTs here are also cheaper than AD's complex
    intermediate chain)."""
    _check_shapes(a, b)
    return _corr_raw(a, b)


def _corr_fwd(a, b):
    # the closed-form adjoints below assume equal operand shapes
    _check_shapes(a, b)
    return _corr_raw(a, b), (a, b)


def _corr_bwd(res, g):
    a, b = res
    # corr(a,b)[k] = sum_d a[d] b[(d+k)];  dL/da[d] = sum_k g[k] b[(d+k)]
    # = corr(g, b)[d];  dL/db[j] = sum_k g[k] a[(j-k)] = conv(g, a)[j]
    return (_corr_raw(g, b).astype(a.dtype),
            _conv_raw(g, a).astype(b.dtype))


circular_correlation.defvjp(_corr_fwd, _corr_bwd)


def circular_correlation_matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Time-domain form (identical math, O(D^2) flops).

    Builds the circulant matrix of ``b`` once per row:
    ``C[d, k] = b[(d + k) % D]``; then ``corr = a @ C`` — for small D
    (16-128 as used by the DDI heads) the flops are negligible and the
    matmul batches over the leading dimensions.
    """
    d = a.shape[-1]
    idx = (jnp.arange(d)[:, None] + jnp.arange(d)[None, :]) % d
    circ = b[..., idx]  # (..., D, D)
    return jnp.einsum("...d,...dk->...k", a, circ)


def circular_correlation_auto(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Form dispatch on D: the circulant matmul for D <= MATMUL_MAX_D,
    rfft otherwise.  Static shape -> the branch resolves at trace time."""
    if a.shape[-1] <= MATMUL_MAX_D:
        return circular_correlation_matmul(a, b)
    return circular_correlation(a, b)


def circular_correlation_reference(a, b):
    """numpy-style transcription of the reference real/imag FFT math."""
    fa_r, fa_i = jnp.real(jnp.fft.fft(a)), jnp.imag(jnp.fft.fft(a))
    fb_r, fb_i = jnp.real(jnp.fft.fft(b)), jnp.imag(jnp.fft.fft(b))
    prod_r = fa_r * fb_r + fa_i * fb_i
    prod_i = fa_r * fb_i - fa_i * fb_r
    return jnp.real(jnp.fft.ifft(prod_r + 1j * prod_i))
