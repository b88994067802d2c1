"""A small module system with the ``flax.linen`` interface this package uses.

Every encoder, readout and head is written against this interface:
dataclass modules whose ``@compact`` methods create submodules inline,
``init``/``apply`` over a ``{"params": ...}`` variable dict, ``make_rng``
streams, and the handful of layers below.  It keeps the package to jax,
numpy and optax at run time.

Parameter trees, auto-generated names ("Dense_0", ...) and initial values
follow flax.linen 0.12 exactly — the per-scope PRNG keys are derived by
the same SHA-1 fold-in of the scope path — so a seed gives the same
parameters under either implementation (tests/test_nn.py checks this
against flax where it is installed).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from typing import Any, Callable, Optional

import jax.numpy as jnp
from jax import lax, random
from jax.nn import elu, initializers, leaky_relu, one_hot, relu, sigmoid, softmax

__all__ = [
    "BatchNorm", "Dense", "Dropout", "GRUCell", "Module", "OptimizedLSTMCell",
    "RNN", "compact", "elu", "initializers", "leaky_relu", "nowrap", "one_hot",
    "relu", "sigmoid", "softmax",
]

_MISSING = object()


class _Unspecified:
    def __repr__(self):
        return "<unspecified parent>"


_UNSPECIFIED = _Unspecified()
_context = threading.local()


def _module_stack() -> list:
    stack = getattr(_context, "stack", None)
    if stack is None:
        stack = _context.stack = []
    return stack


def _fold_in_static(key, data):
    """flax's static fold-in: SHA-1 over the path items, one fold_in."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Root:
    """State shared by every scope of one init/apply call."""

    def __init__(self, variables, rngs, initializing):
        self.variables = variables
        self.rngs = rngs
        self.initializing = initializing
        self.rng_counters: dict = {}
        self.adopted: dict = {}


class _Scope:
    def __init__(self, root: _Root, path: tuple = ()):
        self.root = root
        self.path = path

    def push(self, name: str) -> "_Scope":
        return _Scope(self.root, self.path + (name,))

    def _collection_dict(self, col: str, create: bool):
        d = self.root.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.root.variables[col] = {}
        for p in self.path:
            nxt = d.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = d[p] = {}
            d = nxt
        return d

    def get(self, col: str, name: str):
        d = self._collection_dict(col, create=False)
        return _MISSING if d is None else d.get(name, _MISSING)

    def put(self, col: str, name: str, value) -> None:
        if not self.root.initializing:
            raise ValueError(
                f"variables are immutable outside init; cannot set "
                f"{col}/{'/'.join(self.path + (name,))}")
        self._collection_dict(col, create=True)[name] = value

    def make_rng(self, name: str):
        rngs = self.root.rngs
        if name not in rngs:
            if "params" not in rngs:
                raise ValueError(
                    f"{'/'.join(self.path) or '<root>'} needs a PRNG key for "
                    f"{name!r}; pass rngs={{{name!r}: key}}")
            name = "params"
        counters = self.root.rng_counters.setdefault(self.path, {})
        counters[name] = counters.get(name, 0) + 1
        return _fold_in_static(rngs[name], self.path + (counters[name],))


class _Variable:
    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


def compact(fn: Callable) -> Callable:
    """Marks a method that may define submodules and parameters inline."""
    fn.compact = True
    return fn


def nowrap(fn: Callable) -> Callable:
    """Marks a helper method that runs outside the module's scope."""
    fn.nowrap = True
    return fn


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            return fn(self, *args, **kwargs)
        if self._depth == 0:
            self._autoname.clear()  # a fresh call re-derives the same names
        object.__setattr__(self, "_depth", self._depth + 1)
        stack = _module_stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            object.__setattr__(self, "_depth", self._depth - 1)

    return wrapped


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class: subclasses are dataclasses whose fields are hyper-
    parameters.  A module created inside another module's method becomes
    its child (named by ``name=`` or ``<Class>_<n>``); a module held in a
    field is adopted under the field's name when its owner is bound."""

    parent: Any = dataclasses.field(
        default=_UNSPECIFIED, kw_only=True, repr=False, compare=False)
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, val in list(cls.__dict__.items()):
            if (inspect.isfunction(val) and attr not in fields
                    and (attr == "__call__" or not attr.startswith("__"))
                    and not getattr(val, "nowrap", False)):
                setattr(cls, attr, _wrap_method(val))
        dataclasses.dataclass(
            cls, unsafe_hash="__hash__" not in cls.__dict__, repr=True)

    def __post_init__(self) -> None:
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_autoname", {})
        object.__setattr__(self, "_depth", 0)
        if self.parent is _UNSPECIFIED:
            stack = _module_stack()
            object.__setattr__(self, "parent", stack[-1] if stack else None)
        if self.parent is None:
            return
        if self.name is None:
            prefix = type(self).__name__
            n = self.parent._autoname.get(prefix, 0)
            self.parent._autoname[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")
        self._bind(self.parent._scope.push(self.name))

    # ---- binding ---------------------------------------------------------

    def _bind(self, scope: _Scope) -> None:
        object.__setattr__(self, "_scope", scope)
        for f in dataclasses.fields(self):
            if f.name in ("parent", "name"):
                continue
            value = getattr(self, f.name)
            adopted = self._adopt(f.name, value)
            if adopted is not value:
                object.__setattr__(self, f.name, adopted)

    def _adopt(self, name: str, value):
        """A top-level module held in a field becomes this module's child
        under the field's name (one adopted copy per instance)."""
        if not isinstance(value, Module) or value.parent is not None:
            return value
        cache = self._scope.root.adopted
        if id(value) in cache:
            return cache[id(value)][1]
        child = dataclasses.replace(value, parent=None)
        cache[id(value)] = (value, child)
        object.__setattr__(child, "parent", self)
        object.__setattr__(child, "name", name)
        child._bind(self._scope.push(name))
        return child

    def clone(self, **updates) -> "Module":
        """An unbound copy with some fields replaced."""
        return dataclasses.replace(self, parent=None, **updates)

    # ---- variables -------------------------------------------------------

    def _require_scope(self) -> _Scope:
        if self._scope is None:
            raise ValueError(
                f"{type(self).__name__} is unbound: call it through "
                ".init/.apply or from inside a bound module")
        return self._scope

    def param(self, name: str, init_fn: Callable, *init_args):
        scope = self._require_scope()
        value = scope.get("params", name)
        if value is _MISSING:
            if not scope.root.initializing:
                raise ValueError(
                    "missing parameter "
                    f"{'/'.join(scope.path + (name,))!r} in the given params")
            value = init_fn(scope.make_rng("params"), *init_args)
            scope.put("params", name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        scope = self._require_scope()
        if scope.get(col, name) is _MISSING:
            if not scope.root.initializing:
                raise ValueError(
                    f"missing variable {'/'.join(scope.path + (name,))!r} "
                    f"in collection {col!r}")
            scope.put(col, name, init_fn(*init_args))
        return _Variable(scope, col, name)

    def make_rng(self, name: str = "params"):
        return self._require_scope().make_rng(name)

    def is_initializing(self) -> bool:
        return self._require_scope().root.initializing

    # ---- entry points ----------------------------------------------------

    def _run(self, variables, rngs, initializing, args, kwargs):
        if rngs is None:
            rngs = {}
        elif not isinstance(rngs, dict):
            rngs = {"params": rngs}
        root = _Root(variables, dict(rngs), initializing)
        bound = dataclasses.replace(self, parent=None)
        bound._bind(_Scope(root))
        return bound(*args, **kwargs), root.variables

    def init(self, rngs, *args, **kwargs) -> dict:
        """Create the variables: returns ``{"params": ...}`` (plus any
        other collection the module defines, e.g. ``"batch_stats"``)."""
        return self._run({}, rngs, True, args, kwargs)[1]

    def apply(self, variables, *args, rngs=None, **kwargs):
        """Run ``__call__`` with ``variables``; they are read-only here."""
        return self._run(variables, rngs, False, args, kwargs)[0]


def _promote_dtype(*args, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[jnp.asarray(x) for x in args if x is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [jnp.asarray(x, dtype) if x is not None else None for x in args]


class Dense(Module):
    """y = x @ kernel + bias over the last axis; ``dtype`` is the compute
    dtype (parameters stay ``param_dtype``)."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote_dtype(inputs, kernel, bias,
                                              dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class _DenseParams(Module):
    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        k = self.param("kernel", self.kernel_init,
                       (inputs.shape[-1], self.features), jnp.float32)
        b = (self.param("bias", self.bias_init, (self.features,), jnp.float32)
             if self.use_bias else None)
        return k, b


class OptimizedLSTMCell(Module):
    """LSTM cell with the gate matmuls concatenated: parameters
    ``i{i,f,g,o}/kernel`` (input) and ``h{i,f,g,o}/{kernel,bias}``
    (recurrent, orthogonal init).  Carry is ``(c, h)``."""

    features: int
    dtype: Any = None

    @compact
    def __call__(self, carry, inputs):
        c, h = carry
        hidden = h.shape[-1]
        p_i, p_h = {}, {}
        for g in "ifgo":
            p_i[g] = _DenseParams(hidden, use_bias=False, name=f"i{g}")(inputs)
            p_h[g] = _DenseParams(hidden, kernel_init=initializers.orthogonal(),
                                  name=f"h{g}")(h)

        def concat_dense(x, params, use_bias):
            kernels = [k for k, _ in params.values()]
            kernel = jnp.concatenate(kernels, axis=-1)
            bias = (jnp.concatenate([b for _, b in params.values()], axis=-1)
                    if use_bias else None)
            x, kernel, bias = _promote_dtype(x, kernel, bias, dtype=self.dtype)
            y = jnp.dot(x, kernel)
            if use_bias:
                y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
            return dict(zip(params, jnp.split(y, len(kernels), axis=-1)))

        dh = concat_dense(h, p_h, True)
        di = concat_dense(inputs, p_i, False)
        i = sigmoid(dh["i"] + di["i"])
        f = sigmoid(dh["f"] + di["f"])
        g = jnp.tanh(dh["g"] + di["g"])
        o = sigmoid(dh["o"] + di["o"])
        new_c = f * c + i * g
        new_h = o * jnp.tanh(new_c)
        return (new_c, new_h), new_h

    @nowrap
    def initialize_carry(self, rng, input_shape):
        shape = tuple(input_shape[:-1]) + (self.features,)
        return jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)


class GRUCell(Module):
    """GRU cell: ``i{r,z,n}`` input Dense (with bias) and ``h{r,z,n}``
    recurrent Dense (orthogonal init; only ``hn`` has a bias)."""

    features: int
    dtype: Any = None

    @compact
    def __call__(self, carry, inputs):
        h = carry
        hidden = h.shape[-1]
        dense_h = functools.partial(
            Dense, hidden, use_bias=False, dtype=self.dtype,
            kernel_init=initializers.orthogonal())
        dense_i = functools.partial(Dense, hidden, use_bias=True,
                                    dtype=self.dtype)
        r = sigmoid(dense_i(name="ir")(inputs) + dense_h(name="hr")(h))
        z = sigmoid(dense_i(name="iz")(inputs) + dense_h(name="hz")(h))
        n = jnp.tanh(dense_i(name="in")(inputs)
                     + r * dense_h(name="hn", use_bias=True)(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    @nowrap
    def initialize_carry(self, rng, input_shape):
        return jnp.zeros(tuple(input_shape[:-1]) + (self.features,),
                         jnp.float32)


class RNN(Module):
    """Runs ``cell`` over axis 1 of a (batch, time, features) input with
    ``lax.scan``; ``reverse`` walks time backwards and ``keep_order``
    returns the outputs in input order."""

    cell: Module
    reverse: bool = False
    keep_order: bool = False

    @compact
    def __call__(self, inputs):
        xs = jnp.swapaxes(inputs, 0, 1)
        if self.reverse:
            xs = xs[::-1]
        carry = self.cell.initialize_carry(random.PRNGKey(0), xs.shape[1:])
        if self.is_initializing():
            self.cell(carry, xs[0])  # create the parameters outside scan
        _, ys = lax.scan(lambda c, x: self.cell(c, x), carry, xs)
        if self.reverse and self.keep_order:
            ys = ys[::-1]
        return jnp.swapaxes(ys, 0, 1)


class Dropout(Module):
    """Inverted dropout drawing from the ``"dropout"`` PRNG stream."""

    rate: float
    deterministic: Optional[bool] = None

    @compact
    def __call__(self, inputs, deterministic: Optional[bool] = None):
        if deterministic is None:
            deterministic = self.deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = random.bernoulli(self.make_rng("dropout"), p=keep,
                                shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


class BatchNorm(Module):
    """Batch normalization over every axis but the last, with running
    statistics in the ``"batch_stats"`` collection.  ``apply`` keeps
    variables read-only, so training mode (which updates the statistics)
    runs only under ``init``; evaluation uses the running averages."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5

    @compact
    def __call__(self, x, use_running_average: Optional[bool] = None):
        if use_running_average is None:
            use_running_average = self.use_running_average
        feat = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean", jnp.zeros, feat,
                                jnp.float32)
        ra_var = self.variable("batch_stats", "var", jnp.ones, feat,
                               jnp.float32)
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            xf = jnp.asarray(x, jnp.float32)
            mean = jnp.mean(xf, axes)
            var = jnp.maximum(jnp.mean(jnp.square(xf), axes)
                              - jnp.square(mean), 0.0)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        scale = self.param("scale", initializers.ones, feat, jnp.float32)
        bias = self.param("bias", initializers.zeros, feat, jnp.float32)
        y = (x - mean) * lax.rsqrt(var + self.epsilon) * scale + bias
        return jnp.asarray(y, x.dtype)
