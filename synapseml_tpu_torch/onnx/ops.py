"""ONNX op → PyTorch implementations.

The port's counterpart of the JAX package's ``onnx/ops.py``: the same 135
names in ``REGISTRY``, each taking ``(node, *inputs)`` and returning one
value or a tuple, with the JAX package's semantics (its documented
deviations from the ONNX spec included: static ``-1``-padded
``NonMaxSuppression``, the ``max_loop_trips`` bound, deterministic
``Random*`` ops keyed by the ``seed`` attribute or the node's name).

Values are of two kinds, as in the JAX package under ``jit``:

* **host values** — numpy arrays: initializers of at most ``HOST_MAX``
  elements, ``Constant`` outputs, every ``Shape`` result and whatever an op
  computes from host values alone. Shape-carrying inputs (a ``Reshape``
  target, ``Slice`` bounds, ``Pad`` widths, ...) must be host values
  (``_static``), as the JAX package requires compile-time constants there:
  nothing reads a device tensor back to the host, so a graph scores inside
  a captured CUDA graph.
* **device tensors** — torch tensors on the function's device: graph
  inputs, larger weights and every op output computed from one of them.

An op reads a data input through ``_t``, which returns a device tensor; a
host value is copied to the device once and kept in the executing
function's cache (a copy made during a CUDA graph capture would fail the
capture, so the runner's warm-up run fills the cache first). The executor
(``importer.py``) runs an op with only host inputs on the CPU and keeps its
result on the host.
"""

from __future__ import annotations

import math
import threading
import zlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..ops import image as _image

REGISTRY: Dict[str, Callable] = {}

#: Initializers and ``Constant`` values of at most this many elements stay
#: host values (shapes, axes, pads, scalars); larger ones live on the device.
HOST_MAX = 64

# ONNX TensorProto.DataType -> torch dtype. The JAX package runs with 64-bit
# floats off, so a float64 tensor computes as float32 there; the unsigned
# types torch lacks arithmetic for widen to a signed type holding them.
TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                4: torch.int32, 5: torch.int16, 6: torch.int32,
                7: torch.int64, 9: torch.bool, 10: torch.float16,
                11: torch.float32, 12: torch.int64, 13: torch.int64,
                16: torch.bfloat16}
_HOST_WIDEN = {np.dtype(np.float64): np.float32,
               np.dtype(np.uint16): np.int32,
               np.dtype(np.uint32): np.int64,
               np.dtype(np.uint64): np.int64}


def op(*names):
    def deco(fn):
        for n in names:
            REGISTRY[n] = fn
        return fn

    return deco


# ---------------------------------------------------------------------------
# execution context: where ``_t`` puts a host value
# ---------------------------------------------------------------------------

class Context:
    """Where ops run: ``device``, the cache of host values copied there and
    whether float32 host values go over as bfloat16 (the bf16 precision
    mode). The host context (``host=True``) runs ops on CPU tensors made
    from numpy, uncached."""

    def __init__(self, device, bf16: bool = False, host: bool = False):
        self.device = torch.device(device)
        self.cache = {}
        self.bf16 = bf16
        self.host = host

    def tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        a = np.asarray(x)
        if self.host:
            return _from_host(a)
        key = (a.dtype.str, a.shape, a.tobytes())
        t = self.cache.get(key)
        if t is None:
            t = self.cache[key] = self.upload(a)
        return t

    def upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` copied to the device, uncached (weights go over once)."""
        t = _from_host(a).to(self.device)
        if self.bf16 and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        return t

    def cached(self, key, build: Callable[[], np.ndarray]) -> torch.Tensor:
        """A device tensor made once from ``build()`` for a hashable
        ``key`` (weight matrices, tree tables): no bytes hashed per call.
        The host context builds it each time (its keys would outlive the
        objects they name)."""
        if self.host:
            return torch.from_numpy(np.ascontiguousarray(build()))
        full = ("built",) + tuple(key)
        t = self.cache.get(full)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(build())).to(
                self.device)
            self.cache[full] = t
        return t


def _from_host(a) -> torch.Tensor:
    """A CPU tensor holding a copy of host value ``a``, widened to a type
    torch computes in."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=_HOST_WIDEN.get(a.dtype,
                                                              a.dtype)))


_HOST_CONTEXT = Context("cpu", host=True)
_local = threading.local()


class using:
    """``with using(ctx):`` makes ``ctx`` the context of ops this thread
    runs (nested uses restore the outer one)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _local.stack.pop()
        return False


def context() -> Context:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else _HOST_CONTEXT


def is_host(x) -> bool:
    return x is None or isinstance(x, (np.ndarray, np.generic))


def host_call(impl, node, *args):
    """``impl`` on host values (numpy in, numpy out): constant folding and
    host evaluation."""
    with using(_HOST_CONTEXT):
        out = impl(node, *args)
    if isinstance(out, tuple):
        return tuple(to_numpy(o) for o in out)
    return to_numpy(out)


def to_numpy(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _t(x) -> torch.Tensor:
    return context().tensor(x)


def _dev():
    return context().device


def _static(x, name, node):
    """Shape-carrying inputs must be host values (compile-time constants in
    the JAX package)."""
    if isinstance(x, torch.Tensor):
        raise ValueError(
            f"{node.op_type} '{node.name}': input {name} must be a constant "
            "(initializer / Constant node / Shape result) so the graph keeps "
            "static shapes and never reads the device back")
    return np.asarray(x)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a host value of numpy ``dtype`` becomes."""
    return _from_host(np.zeros(0, dtype)).dtype


def _torch_dtype_of(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch_dtype(np.asarray(x).dtype)


def _str(v) -> str:
    return v if isinstance(v, str) else v.decode()


def _f32_compute(*ts):
    """bfloat16 operands of a product on the CPU go through float32 (their
    products are exact there), as the JAX package's
    ``preferred_element_type=float32`` does; on the card the library's
    bf16 product accumulates in float32 itself."""
    if ts[0].dtype == torch.bfloat16 and ts[0].device.type == "cpu":
        return [t.float() if t is not None else None for t in ts]
    return list(ts)


# --- elementwise -----------------------------------------------------------

@op("Add")
def _add(node, a, b):
    return _t(a) + _t(b)


@op("Sub")
def _sub(node, a, b):
    return _t(a) - _t(b)


@op("Mul")
def _mul(node, a, b):
    return _t(a) * _t(b)


@op("Div")
def _div(node, a, b):
    # true division, as the JAX package's ``a / b`` (integers give floats)
    return torch.true_divide(_t(a), _t(b))


@op("Pow")
def _pow(node, a, b):
    return torch.pow(_t(a), _t(b))


@op("Neg")
def _neg(node, a):
    return -_t(a)


@op("Sqrt")
def _sqrt(node, a):
    return torch.sqrt(_t(a))


@op("Exp")
def _exp(node, a):
    return torch.exp(_t(a))


@op("Log")
def _log(node, a):
    return torch.log(_t(a))


@op("Abs")
def _abs(node, a):
    return torch.abs(_t(a))


@op("Erf")
def _erf(node, a):
    return torch.erf(_t(a))


@op("Relu")
def _relu(node, a):
    return torch.clamp_min(_t(a), 0)


@op("LeakyRelu")
def _leaky(node, a):
    a = _t(a)
    alpha = node.attr("alpha", 0.01)
    return torch.where(a >= 0, a, alpha * a)


@op("Sigmoid")
def _sigmoid(node, a):
    return torch.sigmoid(_t(a))


@op("Tanh")
def _tanh(node, a):
    return torch.tanh(_t(a))


@op("Gelu")
def _gelu(node, a):
    approx = node.attr("approximate", "none") != "none"
    return F.gelu(_t(a), approximate="tanh" if approx else "none")


@op("Clip")
def _clip(node, a, *mm):
    out = _t(a)
    lo = mm[0] if len(mm) > 0 else node.attr("min")
    hi = mm[1] if len(mm) > 1 else node.attr("max")
    if lo is not None:
        out = torch.maximum(out, _t(lo).to(out.dtype))
    if hi is not None:
        out = torch.minimum(out, _t(hi).to(out.dtype))
    return out


@op("Min")
def _min(node, *xs):
    out = _t(xs[0])
    for x in xs[1:]:
        out = torch.minimum(out, _t(x))
    return out


@op("Max")
def _max(node, *xs):
    out = _t(xs[0])
    for x in xs[1:]:
        out = torch.maximum(out, _t(x))
    return out


@op("Sum")
def _sum(node, *xs):
    out = _t(xs[0])
    for x in xs[1:]:
        out = out + _t(x)
    return out


@op("Where")
def _where(node, c, a, b):
    return torch.where(_t(c).to(torch.bool), _t(a), _t(b))


@op("Equal")
def _equal(node, a, b):
    return _t(a) == _t(b)


@op("Greater")
def _greater(node, a, b):
    return _t(a) > _t(b)


@op("Less")
def _less(node, a, b):
    return _t(a) < _t(b)


@op("Not")
def _not(node, a):
    return ~_t(a)


@op("Cast")
def _cast(node, a):
    return _t(a).to(TORCH_DTYPES[int(node.attr("to"))])


@op("Identity", "Dropout")
def _identity(node, a, *rest):
    return a


# --- reductions / normalization -------------------------------------------

def _axes(node, extra_inputs, rank):
    axes = node.attr("axes")
    if axes is None and extra_inputs and extra_inputs[0] is not None:
        axes = [int(v) for v in _static(extra_inputs[0], "axes",
                                        node).ravel()]
    if axes is None:
        axes = list(range(rank))
    return tuple(sorted(set(int(a) % rank for a in axes))) if rank else ()


def _reduce(node, a, rest, fn):
    a = _t(a)
    keep = bool(node.attr("keepdims", 1))
    axes = _axes(node, rest, a.dim())
    if not axes:
        return a
    return fn(a, axes, keep)


@op("ReduceMean")
def _rmean(node, a, *rest):
    def mean(a, axes, keep):
        if not a.is_floating_point():
            a = a.to(torch.float32)
        return torch.mean(a, dim=axes, keepdim=keep)
    return _reduce(node, a, rest, mean)


@op("ReduceSum")
def _rsum(node, a, *rest):
    return _reduce(node, a, rest,
                   lambda a, axes, keep: torch.sum(a, dim=axes, keepdim=keep))


@op("ReduceMax")
def _rmax(node, a, *rest):
    return _reduce(node, a, rest,
                   lambda a, axes, keep: torch.amax(a, dim=axes,
                                                    keepdim=keep))


@op("ReduceMin")
def _reduce_min(node, x, *rest):
    return _reduce(node, x, rest,
                   lambda a, axes, keep: torch.amin(a, dim=axes,
                                                    keepdim=keep))


@op("ReduceProd")
def _reduce_prod(node, x, *rest):
    def prod(a, axes, keep):
        for ax in sorted(axes, reverse=True):
            a = torch.prod(a, dim=ax, keepdim=True)
        return a if keep else a.squeeze(axes)
    return _reduce(node, x, rest, prod)


@op("ReduceL2")
def _reduce_l2(node, x, *rest):
    return _reduce(node, x, rest, lambda a, axes, keep: torch.sqrt(
        torch.sum(a * a, dim=axes, keepdim=keep)))


@op("ReduceLogSumExp")
def _rlogsumexp(node, x, *rest):
    return _reduce(node, x, rest, lambda a, axes, keep: torch.logsumexp(
        a, dim=axes, keepdim=keep))


@op("Softmax")
def _softmax(node, a):
    return torch.softmax(_t(a), dim=node.attr("axis", -1))


@op("LogSoftmax")
def _logsoftmax(node, a):
    return torch.log_softmax(_t(a), dim=node.attr("axis", -1))


@op("ArgMax")
def _argmax(node, a):
    return torch.argmax(_t(a), dim=node.attr("axis", 0),
                        keepdim=bool(node.attr("keepdims", 1)))


@op("ArgMin")
def _argmin(node, x):
    if node.attr("select_last_index", 0):
        raise ValueError("ArgMin: select_last_index not supported")
    return torch.argmin(_t(x), dim=node.attr("axis", 0),
                        keepdim=bool(node.attr("keepdims", 1)))


def _norm_over(x, axes, eps):
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


@op("LayerNormalization")
def _layernorm(node, x, scale, bias=None):
    # ONNX: normalization runs over axes [axis .. rank-1], not just `axis`
    x, scale = _t(x), _t(scale)
    bias = _t(bias) if bias is not None else None
    axis = node.attr("axis", -1) % x.dim()
    eps = node.attr("epsilon", 1e-5)
    tail = tuple(x.shape[axis:])
    if tuple(scale.shape) == tail and (bias is None
                                       or tuple(bias.shape) == tail) \
            and scale.dtype == x.dtype:
        return F.layer_norm(x, tail, scale, bias, eps)
    out = _norm_over(x, tuple(range(axis, x.dim())), eps) * scale
    return out + bias if bias is not None else out


@op("BatchNormalization")
def _batchnorm(node, x, scale, bias, mean, var):
    x = _t(x)
    eps = node.attr("epsilon", 1e-5)
    shape = [1, -1] + [1] * (x.dim() - 2)  # params along channel dim (NCHW)
    mul = _t(scale).reshape(shape) / torch.sqrt(_t(var).reshape(shape) + eps)
    return torch.addcmul(_t(bias).reshape(shape), x - _t(mean).reshape(shape),
                         mul)


@op("InstanceNormalization")
def _instance_norm(node, x, scale, bias):
    x = _t(x)
    eps = node.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return _norm_over(x, tuple(range(2, x.dim())), eps) \
        * _t(scale).reshape(shape) + _t(bias).reshape(shape)


@op("GroupNormalization")
def _group_norm(node, x, scale, bias):
    x, scale, bias = _t(x), _t(scale), _t(bias)
    eps = node.attr("epsilon", 1e-5)
    g = node.attr("num_groups")
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    t = x.reshape((n, g, c // g) + spatial)
    t = _norm_over(t, tuple(range(2, t.dim())), eps).reshape((n, c) + spatial)
    if scale.shape[0] == g and g != c:
        # opset 18-20: per-GROUP scale/bias, broadcast over the group's channels
        scale = torch.repeat_interleave(scale, c // g)
        bias = torch.repeat_interleave(bias, c // g)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return t * scale.reshape(shape) + bias.reshape(shape)


# --- matmul / linear -------------------------------------------------------

def _matmul_t(a, b):
    a, b = _f32_compute(a, b)
    return torch.matmul(a, b)


@op("MatMul")
def _matmul(node, a, b):
    return _matmul_t(_t(a), _t(b))


@op("Gemm")
def _gemm(node, a, b, c=None):
    a, b = _t(a), _t(b)
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    out = _matmul_t(a, b)
    if alpha != 1.0:
        out = alpha * out
    if c is not None:
        c = _t(c)
        out = out + (beta * c if beta != 1.0 else c)
    return out


@op("Einsum")
def _einsum(node, *xs):
    ts = _f32_compute(*[_t(x) for x in xs])
    return torch.einsum(_str(node.attr("equation")), *ts)


# --- conv / pool (NCHW, matching ONNX layout) ------------------------------

def _conv_pads(node, spatial):
    pads = node.attr("pads")
    auto = node.attr("auto_pad", "NOTSET")
    if pads is not None:
        half = len(pads) // 2
        return [(pads[i], pads[i + half]) for i in range(half)], auto
    return [(0, 0)] * spatial, auto


def _same_pads(in_sizes, kernel, strides, dils, lower: bool):
    """Explicit SAME padding; SAME_LOWER puts the odd element at the start."""
    out = []
    for size, k, s, d in zip(in_sizes, kernel, strides, dils):
        eff = (k - 1) * d + 1
        total = max((int(np.ceil(size / s)) - 1) * s + eff - size, 0)
        small, big = total // 2, total - total // 2
        out.append((big, small) if lower else (small, big))
    return out


def _pad_flat(pads):
    """[(lo, hi) per spatial dim] -> ``F.pad``'s last-dim-first list."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return flat


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_t(node, x, w, b=None):
    """The convolution on tensors: explicit asymmetric pads go through
    ``F.pad`` first (never torch's symmetric ``padding=``)."""
    spatial = x.dim() - 2
    strides = node.attr("strides", [1] * spatial)
    dil = node.attr("dilations", [1] * spatial)
    groups = node.attr("group", 1)
    pads, auto = _conv_pads(node, spatial)
    if _str(auto) in ("SAME_UPPER", "SAME_LOWER"):
        pads = _same_pads(x.shape[2:], w.shape[2:], strides, dil,
                          lower=(_str(auto) == "SAME_LOWER"))
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, _pad_flat(pads))
        padding = 0
    return _CONV[spatial](x, w, b, stride=strides, padding=padding,
                          dilation=dil, groups=groups)


@op("Conv")
def _conv(node, x, w, b=None):
    x, w = _t(x), _t(w)
    b = _t(b) if b is not None else None
    x, w, b = _f32_compute(x, w, b)
    return _conv_t(node, x, w, b)


def _pool(node, x, kind):
    x = _t(x)
    spatial = x.dim() - 2
    k = list(node.attr("kernel_shape"))
    strides = node.attr("strides", [1] * spatial)
    pads, auto = _conv_pads(node, spatial)
    if _str(auto) in ("SAME_UPPER", "SAME_LOWER"):
        pads = _same_pads(x.shape[2:], k, strides, [1] * spatial,
                          lower=(_str(auto) == "SAME_LOWER"))
    padded = any(lo or hi for lo, hi in pads)
    name = {1: "1d", 2: "2d", 3: "3d"}[spatial]
    if kind == "max":
        if padded:
            x = F.pad(x, _pad_flat(pads), value=-math.inf)
        return getattr(F, "max_pool" + name)(x, k, strides)
    avg = getattr(F, "avg_pool" + name)
    if not padded:
        return avg(x, k, strides)
    s = avg(F.pad(x, _pad_flat(pads)), k, strides)
    if node.attr("count_include_pad", 0):
        return s
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), _pad_flat(pads))
    return s / avg(ones, k, strides)


@op("MaxPool")
def _maxpool(node, x):
    return _pool(node, x, "max")


@op("AveragePool")
def _avgpool(node, x):
    return _pool(node, x, "avg")


@op("GlobalAveragePool")
def _gap(node, x):
    x = _t(x)
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("GlobalMaxPool")
def _gmp(node, x):
    x = _t(x)
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("ConvTranspose")
def _conv_transpose(node, x, w, b=None):
    x, w = _t(x), _t(w)
    spatial = x.dim() - 2
    strides = node.attr("strides", [1] * spatial)
    dil = node.attr("dilations", [1] * spatial)
    groups = node.attr("group", 1)
    pads = node.attr("pads", [0] * (2 * spatial))
    out_pad = node.attr("output_padding", [0] * spatial)
    if groups != 1:
        raise ValueError("ConvTranspose: group > 1 not supported")
    if _str(node.attr("auto_pad", "NOTSET")) not in ("NOTSET", "VALID"):
        raise ValueError("ConvTranspose: auto_pad SAME_* not supported "
                         "(export with explicit pads)")
    if node.attr("output_shape") is not None:
        raise ValueError("ConvTranspose: output_shape attribute not supported "
                         "(use pads/output_padding)")
    x, w = _f32_compute(x, w)
    # the unpadded transposed convolution, then each spatial dim cropped by
    # its pads and extended by output_padding (zeros: no input reaches it)
    full = _CONV_T[spatial](x, w, None, stride=strides, dilation=dil)
    half = len(pads) // 2
    out = F.pad(full, _pad_flat([(-pads[i], -pads[i + half] + out_pad[i])
                                 for i in range(spatial)]))
    if b is not None:
        out = out + _t(b).to(out.dtype).reshape((1, -1) + (1,) * spatial)
    return out


# --- shape plumbing --------------------------------------------------------

@op("Reshape")
def _reshape(node, x, shape):
    shape = [int(v) for v in _static(shape, "shape", node).ravel()]
    x = _t(x)
    # ONNX: 0 means copy input dim
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


@op("Flatten")
def _flatten(node, x):
    x = _t(x)
    axis = node.attr("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


@op("Transpose")
def _transpose(node, x):
    x = _t(x)
    perm = node.attr("perm", list(range(x.dim()))[::-1])
    return x.permute(*perm)


@op("Concat")
def _concat(node, *xs):
    return torch.cat([_t(x) for x in xs], dim=node.attr("axis", 0))


@op("Split")
def _split(node, x, *rest):
    x = _t(x)
    axis = node.attr("axis", 0)
    splits = node.attr("split")
    if splits is None and rest and rest[0] is not None:
        splits = [int(v) for v in _static(rest[0], "split", node).ravel()]
    if splits is None:
        n_out = len(node.outputs)
        if x.shape[axis] % n_out:
            raise ValueError(f"Split: axis {axis} of size {x.shape[axis]} "
                             f"does not divide into {n_out} outputs")
        return tuple(torch.tensor_split(x, n_out, dim=axis))
    idx = np.cumsum(splits)[:-1].tolist()
    return tuple(torch.tensor_split(x, idx, dim=axis))


@op("Squeeze")
def _squeeze(node, x, *rest):
    x = _t(x)
    axes = node.attr("axes")
    if axes is None and rest and rest[0] is not None:
        axes = [int(v) for v in _static(rest[0], "axes", node).ravel()]
    if axes is None:
        return x.squeeze()
    dims = tuple(int(a) % x.dim() for a in axes)
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"Squeeze: axis {d} has size {x.shape[d]}")
    return x.squeeze(dims)


@op("Unsqueeze")
def _unsqueeze(node, x, *rest):
    out = _t(x)
    axes = node.attr("axes")
    if axes is None and rest:
        axes = [int(v) for v in _static(rest[0], "axes", node).ravel()]
    for a in sorted(int(a) for a in axes):
        out = out.unsqueeze(a)
    return out


def _take(x, idx, axis):
    """``jnp.take`` along ``axis`` with negative indices wrapped once."""
    axis = axis % x.dim()
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    flat = torch.index_select(x, axis, idx.reshape(-1))
    return flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                        + tuple(x.shape[axis + 1:]))


@op("Gather")
def _gather(node, x, idx):
    return _take(_t(x), _t(idx), node.attr("axis", 0))


def _slice_dim(x, dim, start, stop, step):
    start, stop, step = slice(start, stop, step).indices(x.shape[dim])
    if step > 0:
        sl = [slice(None)] * x.dim()
        sl[dim] = slice(start, stop, step)
        return x[tuple(sl)]
    idx = np.arange(start, stop, step, dtype=np.int64)
    return torch.index_select(x, dim, _t(idx))


@op("Slice")
def _slice(node, x, *rest):
    if rest:  # opset >= 10: starts/ends/axes/steps as inputs
        starts = [int(v) for v in _static(rest[0], "starts", node).ravel()]
        ends = [int(v) for v in _static(rest[1], "ends", node).ravel()]
        axes = ([int(v) for v in _static(rest[2], "axes", node).ravel()]
                if len(rest) > 2 and rest[2] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _static(rest[3], "steps", node).ravel()]
                 if len(rest) > 3 and rest[3] is not None
                 else [1] * len(starts))
    else:
        starts = node.attr("starts")
        ends = node.attr("ends")
        axes = node.attr("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    out = _t(x)
    for s, e, a, st in zip(starts, ends, axes, steps):
        out = _slice_dim(out, int(a) % out.dim(), s,
                         None if e >= 2 ** 31 - 1 else e, st)
    return out


@op("Expand")
def _expand(node, x, shape):
    shape = [int(v) for v in _static(shape, "shape", node).ravel()]
    x = _t(x)
    # ONNX Expand = broadcast with 1s allowed on either side
    target = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
    return torch.broadcast_to(x, target)


@op("Shape")
def _shape(node, x):
    return np.asarray(x.shape, dtype=np.int64)


@op("Constant")
def _constant(node):
    t = node.attr("value")
    if t is not None:
        return t.array()
    for k in ("value_float", "value_int"):
        v = node.attr(k)
        if v is not None:
            return np.asarray(v)
    raise ValueError(f"Constant node {node.name}: no value attribute")


@op("ConstantOfShape")
def _const_of_shape(node, shape):
    shape = [int(v) for v in _static(shape, "shape", node).ravel()]
    t = node.attr("value")
    fill = t.array().ravel()[0] if t is not None else np.float32(0)
    dtype = torch_dtype(np.asarray(fill).dtype)
    return torch.full(shape, fill.item(), dtype=dtype, device=_dev())


@op("Pad")
def _pad(node, x, *rest):
    x = _t(x)
    pads = node.attr("pads")
    if pads is None and rest:
        pads = [int(v) for v in _static(rest[0], "pads", node).ravel()]
    value = node.attr("value", 0.0)
    if len(rest) > 1 and rest[1] is not None:  # '' input name -> None (skipped)
        value = float(_static(rest[1], "constant_value", node).ravel()[0])
    half = len(pads) // 2
    if len(rest) > 2 and rest[2] is not None:  # opset-18 axes input
        axes = [int(a) % x.dim()
                for a in _static(rest[2], "axes", node).ravel()]
        widths = [(0, 0)] * x.dim()
        for j, a in enumerate(axes):
            widths[a] = (pads[j], pads[j + half])
    else:
        widths = [(pads[i], pads[i + half]) for i in range(half)]
    mode = _str(node.attr("mode", "constant"))
    if mode == "constant":
        return F.pad(x, _pad_flat(widths), value=value)
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            src = np.pad(np.arange(x.shape[d], dtype=np.int64), (lo, hi),
                         mode=np_mode)
            x = torch.index_select(x, d, _t(src))
    return x


@op("Tile")
def _tile(node, x, reps):
    reps = [int(v) for v in _static(reps, "repeats", node).ravel()]
    return torch.tile(_t(x), reps)


@op("Range")
def _range(node, start, limit, delta):
    s = float(_static(start, "start", node).ravel()[0])
    lim = float(_static(limit, "limit", node).ravel()[0])
    d = float(_static(delta, "delta", node).ravel()[0])
    return np.arange(s, lim, d).astype(np.asarray(start).dtype)


@op("Resize")
def _resize(node, x, *rest):
    """``jax.image.resize`` semantics (antialiased linear / cubic weight
    matrices, half-pixel nearest), every axis whose size changes."""
    x = _t(x)
    # inputs: roi (ignored), scales, sizes
    sizes = None
    if len(rest) >= 3 and rest[2] is not None:
        sizes = [int(v) for v in _static(rest[2], "sizes", node).ravel()]
    elif len(rest) >= 2 and rest[1] is not None and np.asarray(
            _static(rest[1], "scales", node)).size:
        scales = np.asarray(_static(rest[1], "scales", node)).ravel()
        sizes = [int(round(s * d)) for s, d in zip(scales, x.shape)]
    if sizes is None:
        raise ValueError("Resize: needs scales or sizes")
    method = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}[
        _str(node.attr("mode", "nearest"))]
    ctx = context()
    out = x
    if method != "nearest" and not out.is_floating_point():
        out = out.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, sizes)):
        if m == n:
            continue
        if method == "nearest":
            idx = ctx.cached(("resize_nearest", m, n),
                             lambda: _image.nearest_indices(m, n))
            out = torch.index_select(out, d, idx)
            continue
        build = (_image.linear_weight_matrix if method == "linear"
                 else _image.cubic_weight_matrix)
        w = ctx.cached(("resize", method, m, n),
                       lambda: build(m, n)).to(out.dtype)
        a, w = _f32_compute(out, w)
        out = torch.movedim(torch.tensordot(a, w, dims=([d], [0])), -1, d)
    return out


# --- extended coverage -------------------------------------------------------

@op("Reciprocal")
def _reciprocal(node, x):
    return 1.0 / _t(x)


@op("Floor")
def _floor(node, x):
    return torch.floor(_t(x))


@op("Ceil")
def _ceil(node, x):
    return torch.ceil(_t(x))


@op("Round")
def _round(node, x):
    return torch.round(_t(x))


@op("Sin")
def _sin(node, x):
    return torch.sin(_t(x))


@op("Cos")
def _cos(node, x):
    return torch.cos(_t(x))


@op("Mod")
def _mod(node, a, b):
    if node.attr("fmod", 0):
        return torch.fmod(_t(a), _t(b))
    return torch.remainder(_t(a), _t(b))


@op("And")
def _and(node, a, b):
    return _t(a) & _t(b)


@op("Or")
def _or(node, a, b):
    return _t(a) | _t(b)


@op("Xor")
def _xor(node, a, b):
    return _t(a) ^ _t(b)


@op("PRelu")
def _prelu(node, x, slope):
    x = _t(x)
    return torch.where(x >= 0, x, _t(slope) * x)


@op("Elu")
def _elu(node, x):
    x = _t(x)
    alpha = node.attr("alpha", 1.0)
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@op("Selu")
def _selu(node, x):
    x = _t(x)
    alpha = node.attr("alpha", 1.67326319217681884765625)
    gamma = node.attr("gamma", 1.05070102214813232421875)
    return gamma * torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@op("HardSigmoid")
def _hardsigmoid(node, x):
    alpha = node.attr("alpha", 0.2)
    beta = node.attr("beta", 0.5)
    return torch.clamp(alpha * _t(x) + beta, 0.0, 1.0)


@op("HardSwish")
def _hardswish(node, x):
    # onnx HardSwish: x * HardSigmoid(x; 1/6, 0.5)
    x = _t(x)
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def _softplus_t(x):
    return torch.logaddexp(x, torch.zeros_like(x))


@op("Softplus")
def _softplus(node, x):
    return _softplus_t(_t(x))


@op("CumSum")
def _cumsum(node, x, axis):
    ax = int(np.asarray(_static(axis, "axis", node)).ravel()[0])
    x = _t(x)
    if node.attr("reverse", 0):
        x = torch.flip(x, (ax,))
    out = torch.cumsum(x, dim=ax, dtype=x.dtype)
    if node.attr("exclusive", 0):
        out = torch.roll(out, 1, ax)
        idx = [slice(None)] * out.dim()
        idx[ax] = slice(0, 1)
        out = torch.cat([torch.zeros_like(out[tuple(idx)]),
                         out.narrow(ax, 1, out.shape[ax] - 1)], dim=ax)
    if node.attr("reverse", 0):
        out = torch.flip(out, (ax,))
    return out


def _one_hot(idx, depth: int, axis: int, dtype=torch.float32):
    """One-hot of ``idx`` at ``axis`` of the result, by comparison (no
    host read of the index range)."""
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
          ).to(dtype)
    if axis != -1 and axis != oh.dim() - 1:
        oh = torch.movedim(oh, -1, axis if axis >= 0 else axis + oh.dim())
    return oh


@op("OneHot")
def _onehot(node, indices, depth, values):
    d = int(np.asarray(_static(depth, "depth", node)).ravel()[0])
    axis = node.attr("axis", -1)
    vals = _t(values)
    raw = _t(indices).to(torch.int64)
    idx = torch.where(raw < 0, raw + d, raw)     # negatives wrap once (spec)
    # out-of-range indices compare equal to no position: an all-off row
    oh = _one_hot(idx, d, axis)
    off, on = vals[0].to(torch.float32), vals[1].to(torch.float32)
    # output dtype follows the values tensor (spec)
    return (oh * (on - off) + off).to(vals.dtype)


@op("TopK")
def _topk(node, x, k):
    x = _t(x)
    kk = int(np.asarray(_static(k, "k", node)).ravel()[0])
    axis = node.attr("axis", -1)
    largest = bool(node.attr("largest", 1))
    vals, idx = torch.topk(x if largest else -x, kk, dim=axis, sorted=True)
    if not largest:
        vals = -vals
    return vals, idx


@op("Trilu")
def _trilu(node, x, k=None):
    kk = int(np.asarray(_static(k, "k", node)).ravel()[0]) \
        if k is not None else 0
    if node.attr("upper", 1):
        return torch.triu(_t(x), kk)
    return torch.tril(_t(x), kk)


@op("DepthToSpace")
def _depth_to_space(node, x):
    x = _t(x)
    b = node.attr("blocksize")
    n, c, h, w = x.shape
    if _str(node.attr("mode", "DCR")) == "DCR":
        t = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        t = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return t.reshape(n, c // (b * b), h * b, w * b)


@op("SpaceToDepth")
def _space_to_depth(node, x):
    x = _t(x)
    b = node.attr("blocksize")
    n, c, h, w = x.shape
    t = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return t.reshape(n, c * b * b, h // b, w // b)


# --- recurrent (RNN / GRU / LSTM) ------------------------------------------
# Layouts follow the ONNX spec: X (seq, batch, input); W (dirs, G*hidden,
# input); R (dirs, G*hidden, hidden); B (dirs, 2*G*hidden);
# Y (seq, dirs, batch, hidden); Y_h (dirs, batch, hidden). The sequence
# length is static, so each direction is a Python loop of per-step
# products; the input products of all steps are one product up front.

def _rnn_directions(node, seq_lens):
    if seq_lens is not None:
        raise ValueError(f"{node.op_type} '{node.name}': sequence_lens is "
                         "not supported (pad to a static length)")
    if node.attr("layout", 0) != 0:
        raise ValueError(f"{node.op_type} '{node.name}': layout=1 is not "
                         "supported")
    direction = _str(node.attr("direction", b"forward"))
    return {"forward": [False], "reverse": [True],
            "bidirectional": [False, True]}[direction]


def _rnn_act(name, default, node, clip=None, alpha=None, beta=None):
    """Activation by ONNX name; ``clip`` clamps the pre-activation."""
    name = _str(name) if name is not None else default
    a = 0.2 if alpha is None else float(alpha)
    b = 0.5 if beta is None else float(beta)
    lk = 0.01 if alpha is None else float(alpha)
    table = {"Sigmoid": torch.sigmoid,
             "Tanh": torch.tanh,
             "Relu": lambda v: torch.clamp_min(v, 0.0),
             "LeakyRelu": lambda v: torch.where(v >= 0, v, lk * v),
             "HardSigmoid": lambda v: torch.clamp(a * v + b, 0.0, 1.0)}
    if name not in table:
        raise ValueError(
            f"{node.op_type} '{node.name}': activation {name!r} is not "
            f"supported (supported: {sorted(table)})")
    act = table[name]
    if clip is not None:
        c = float(clip)
        return lambda v: act(torch.clamp(v, -c, c))
    return act


def _act(node, acts, i, default, clip):
    vals_a = node.attr("activation_alpha") or []
    vals_b = node.attr("activation_beta") or []
    return _rnn_act(acts[i] if i < len(acts) else None, default, node, clip,
                    vals_a[i] if i < len(vals_a) else None,
                    vals_b[i] if i < len(vals_b) else None)


def _steps(x, reverse):
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    return list(order)


@op("RNN")
def _rnn(node, x, w, r, b=None, seq_lens=None, initial_h=None):
    x, w, r = _t(x), _t(w), _t(r)
    dirs = _rnn_directions(node, seq_lens)
    hidden = node.attr("hidden_size", r.shape[-1])
    acts = node.attr("activations") or []
    clip = node.attr("clip")
    batch = x.shape[1]
    ys_all, hT_all = [], []
    for d, reverse in enumerate(dirs):
        bias = (_t(b)[d][:hidden] + _t(b)[d][hidden:]) if b is not None \
            else 0.0
        f = _act(node, acts, d, "Tanh", clip)
        h = (_t(initial_h)[d] if initial_h is not None
             else torch.zeros((batch, hidden), dtype=x.dtype,
                              device=x.device))
        gx = torch.matmul(x, w[d].T)
        ys = [None] * x.shape[0]
        for t in _steps(x, reverse):
            h = f(gx[t] + h @ r[d].T + bias)
            ys[t] = h
        ys_all.append(torch.stack(ys, 0))
        hT_all.append(h)
    return torch.stack(ys_all, dim=1), torch.stack(hT_all, dim=0)


@op("GRU")
def _gru(node, x, w, r, b=None, seq_lens=None, initial_h=None):
    x, w, r = _t(x), _t(w), _t(r)
    dirs = _rnn_directions(node, seq_lens)
    H = node.attr("hidden_size", r.shape[-1])
    lbr = node.attr("linear_before_reset", 0)
    acts = node.attr("activations") or []
    clip = node.attr("clip")
    batch = x.shape[1]
    ys_all, hT_all = [], []
    for d, reverse in enumerate(dirs):
        Rd = r[d]                                # (3H, H); z, r, h
        zeros = torch.zeros(3 * H, dtype=x.dtype, device=x.device)
        Wb = _t(b)[d][: 3 * H] if b is not None else zeros
        Rb = _t(b)[d][3 * H:] if b is not None else zeros
        f = _act(node, acts, 2 * d, "Sigmoid", clip)
        g = _act(node, acts, 2 * d + 1, "Tanh", clip)
        h = (_t(initial_h)[d] if initial_h is not None
             else torch.zeros((batch, H), dtype=x.dtype, device=x.device))
        gxs = torch.matmul(x, w[d].T) + Wb       # (seq, batch, 3H)
        ys = [None] * x.shape[0]
        for t in _steps(x, reverse):
            gx = gxs[t]
            gr = h @ Rd.T
            z = f(gx[:, :H] + gr[:, :H] + Rb[:H])
            rt = f(gx[:, H:2 * H] + gr[:, H:2 * H] + Rb[H:2 * H])
            if lbr:   # torch exports linear_before_reset=1
                hh = g(gx[:, 2 * H:] + rt * (gr[:, 2 * H:] + Rb[2 * H:]))
            else:
                hh = g(gx[:, 2 * H:] + (rt * h) @ Rd[2 * H:].T + Rb[2 * H:])
            h = (1.0 - z) * hh + z * h
            ys[t] = h
        ys_all.append(torch.stack(ys, 0))
        hT_all.append(h)
    return torch.stack(ys_all, dim=1), torch.stack(hT_all, dim=0)


@op("LSTM")
def _lstm(node, x, w, r, b=None, seq_lens=None, initial_h=None,
          initial_c=None, p=None):
    x, w, r = _t(x), _t(w), _t(r)
    dirs = _rnn_directions(node, seq_lens)
    H = node.attr("hidden_size", r.shape[-1])
    acts = node.attr("activations") or []
    clip = node.attr("clip")
    if node.attr("input_forget", 0):
        raise ValueError(f"LSTM '{node.name}': input_forget=1 is not "
                         "supported")
    batch = x.shape[1]
    ys_all, hT_all, cT_all = [], [], []
    for d, reverse in enumerate(dirs):
        bias = ((_t(b)[d][: 4 * H] + _t(b)[d][4 * H:])
                if b is not None else 0.0)
        pe = _t(p)[d] if p is not None else torch.zeros(
            3 * H, dtype=x.dtype, device=x.device)
        f_ = _act(node, acts, 3 * d, "Sigmoid", clip)
        g_ = _act(node, acts, 3 * d + 1, "Tanh", clip)
        h_ = _act(node, acts, 3 * d + 2, "Tanh", clip)
        zeros = torch.zeros((batch, H), dtype=x.dtype, device=x.device)
        h = _t(initial_h)[d] if initial_h is not None else zeros
        c = _t(initial_c)[d] if initial_c is not None else zeros
        gxs = torch.matmul(x, w[d].T)
        ys = [None] * x.shape[0]
        for t in _steps(x, reverse):
            gates = gxs[t] + h @ r[d].T + bias   # (batch, 4H) i,o,f,c
            # peephole tensor P is concatenated [Pi, Po, Pf] (ONNX spec)
            i = f_(gates[:, :H] + pe[:H] * c)
            o_pre = gates[:, H:2 * H]
            fg = f_(gates[:, 2 * H:3 * H] + pe[2 * H:] * c)
            ct = g_(gates[:, 3 * H:])
            c = fg * c + i * ct
            o = f_(o_pre + pe[H:2 * H] * c)
            h = o * h_(c)
            ys[t] = h
        ys_all.append(torch.stack(ys, 0))
        hT_all.append(h)
        cT_all.append(c)
    return (torch.stack(ys_all, dim=1), torch.stack(hT_all, dim=0),
            torch.stack(cT_all, dim=0))


# --- ai.onnx.ml tree ensembles ---------------------------------------------
# The static node tables are flattened once per node on the host, then
# traversal is a depth-bounded gather loop over (batch, tree) on the device:
# no data-dependent Python control flow, so the ensemble captures whole.

_TREE_MODES = {"LEAF": 0, "BRANCH_LEQ": 1, "BRANCH_LT": 2, "BRANCH_GTE": 3,
               "BRANCH_GT": 4, "BRANCH_EQ": 5, "BRANCH_NEQ": 6}


def _tree_tables(node):
    """(feat, value, mode, true_g, false_g, miss_true, roots, depth, gidx)
    as numpy, computed once per node and kept on it."""
    hit = getattr(node, "_tree_tables", None)
    if hit is not None:
        return hit
    tids = np.asarray(node.attr("nodes_treeids"), np.int64)
    nids = np.asarray(node.attr("nodes_nodeids"), np.int64)
    feat = np.asarray(node.attr("nodes_featureids"), np.int64)
    vals = np.asarray(node.attr("nodes_values"), np.float32)
    true_ids = np.asarray(node.attr("nodes_truenodeids"), np.int64)
    false_ids = np.asarray(node.attr("nodes_falsenodeids"), np.int64)
    modes = [_str(m) for m in node.attr("nodes_modes")]
    miss = np.asarray(node.attr("nodes_missing_value_tracks_true",
                                [0] * len(tids)), np.int64)
    mode_i = np.asarray([_TREE_MODES[m] for m in modes], np.int64)

    gidx = {(int(t), int(n)): i for i, (t, n) in enumerate(zip(tids, nids))}
    trees = sorted(set(int(t) for t in tids))
    roots = np.asarray([gidx[(t, 0)] if (t, 0) in gidx
                        else min(i for i, tt in enumerate(tids) if tt == t)
                        for t in trees], np.int64)
    # child pointers -> global indices (leaves self-loop so the fixed-depth
    # walk is idempotent past a leaf)
    tg = np.arange(len(tids), dtype=np.int64)
    fg = np.arange(len(tids), dtype=np.int64)
    for i in range(len(tids)):
        if mode_i[i] != 0:
            tg[i] = gidx[(int(tids[i]), int(true_ids[i]))]
            fg[i] = gidx[(int(tids[i]), int(false_ids[i]))]
    depth = 0
    for rt in roots:
        d, frontier, seen = 0, [int(rt)], set()
        while frontier:
            d += 1
            nxt = []
            for i in frontier:
                if i in seen or mode_i[i] == 0:
                    continue
                seen.add(i)
                nxt += [int(tg[i]), int(fg[i])]
            frontier = nxt
            if d > 512:
                raise ValueError("TreeEnsemble: node graph too deep/cyclic")
        depth = max(depth, d)
    tables = (feat, vals, mode_i, tg, fg, miss, roots, depth, gidx)
    node._tree_tables = tables
    return tables


def _tree_walk(X, node, tables):
    """(N, T) final (leaf) global node index per sample per tree."""
    ctx = context()
    feat, vals, mode_i, tg, fg, miss, roots, depth, _ = tables
    key = ("tree", id(node))
    feat_j, vals_j, mode_j, tg_j, fg_j, miss_j, roots_j = (
        ctx.cached(key + (k,), lambda a=a: a) for k, a in enumerate(
            (feat, vals, mode_i, tg, fg, miss, roots)))
    X = X.to(torch.float32)
    pos = roots_j[None, :].expand(X.shape[0], len(roots))
    for _ in range(depth):
        f = feat_j[pos]                        # (N, T)
        v = vals_j[pos]
        m = mode_j[pos]
        x = torch.gather(X, 1, f)
        go = torch.where(m == 1, x <= v, x < v)
        go = torch.where(m == 3, x >= v, go)
        go = torch.where(m == 4, x > v, go)
        go = torch.where(m == 5, x == v, go)
        go = torch.where(m == 6, x != v, go)
        go = torch.where(torch.isnan(x), miss_j[pos] == 1, go)
        nxt = torch.where(go, tg_j[pos], fg_j[pos])
        pos = torch.where(m == 0, pos, nxt)
    return pos


def _leaf_weight_table(tables, treeids, nodeids, out_ids, weights, n_out):
    """(G, n_out) accumulated leaf weights keyed by global node index."""
    gidx = tables[8]
    table = np.zeros((len(tables[0]), n_out), np.float32)
    for t, n, c, w in zip(treeids, nodeids, out_ids, weights):
        table[gidx[(int(t), int(n))], int(c)] += np.float32(w)
    return table


def _post_transform(node, scores):
    pt = _str(node.attr("post_transform", "NONE"))
    if pt == "NONE":
        return scores
    if pt == "LOGISTIC":
        return torch.sigmoid(scores)
    if pt == "SOFTMAX":
        return torch.softmax(scores, dim=-1)
    if pt == "SOFTMAX_ZERO":
        # spec: softmax over the NON-ZERO score entries only; exact-zero
        # entries keep probability 0 (all-zero rows degrade to uniform)
        nz = scores != 0
        top = torch.amax(torch.where(nz, scores, -math.inf), dim=-1,
                         keepdim=True)
        e = torch.where(nz, torch.exp(scores - top), 0.0)
        denom = e.sum(dim=-1, keepdim=True)
        uniform = torch.full_like(scores, 1.0 / scores.shape[-1])
        return torch.where(denom > 0, e / torch.clamp_min(denom, 1e-30),
                           uniform)
    raise ValueError(f"TreeEnsemble post_transform {pt!r} not supported")


@op("TreeEnsembleClassifier")
def _tree_classifier(node, X):
    ctx = context()
    tables = _tree_tables(node)
    labels = node.attr("classlabels_int64s")
    if labels is None:
        raise ValueError("TreeEnsembleClassifier: only int64 class labels "
                         "are supported (classlabels_strings absent)")
    labels = np.asarray(labels, np.int64)
    cls_ids = np.asarray(node.attr("class_ids"), np.int64)
    ncols = int(cls_ids.max()) + 1 if len(cls_ids) else 1
    base_attr = node.attr("base_values")
    if base_attr is not None:
        nb = len(np.asarray(base_attr).ravel())
        if nb != ncols and not (nb == len(labels) and nb >= ncols):
            raise ValueError(
                f"TreeEnsembleClassifier: base_values has {nb} entries; "
                f"expected {ncols} (weight columns) or {len(labels)} "
                "(class labels, when that covers every weight column)")
        # ORT semantics: a base value per LABEL widens the score matrix
        ncols = max(ncols, nb)
    key = ("tree", id(node))
    table = ctx.cached(key + ("weights",), lambda: _leaf_weight_table(
        tables, node.attr("class_treeids"), node.attr("class_nodeids"),
        cls_ids, node.attr("class_weights"), ncols))
    base = ctx.cached(key + ("base",), lambda: np.asarray(
        base_attr if base_attr is not None else [0.0] * ncols, np.float32))
    pos = _tree_walk(_t(X), node, tables)
    scores = table[pos].sum(dim=1) + base
    # onnxmltools-style binary emission: one weight column for two labels.
    # ONNX Runtime expands BEFORE a softmax-family transform ([-s, s]) and
    # AFTER logistic/none ([1-p, p])
    binary_one_col = len(labels) == 2 and ncols == 1
    pt = _str(node.attr("post_transform", "NONE"))
    if binary_one_col and pt in ("SOFTMAX", "SOFTMAX_ZERO"):
        scores = torch.cat([-scores, scores], dim=1)
        binary_one_col = False
    z = _post_transform(node, scores)
    if binary_one_col:
        z = torch.cat([1.0 - z, z], dim=1)
    lab = ctx.cached(key + ("labels",), lambda: labels)
    return lab[torch.argmax(z, dim=1)], z


@op("TreeEnsembleRegressor")
def _tree_regressor(node, X):
    ctx = context()
    tables = _tree_tables(node)
    n_targets = int(node.attr("n_targets", 1))
    key = ("tree", id(node))
    table = ctx.cached(key + ("weights",), lambda: _leaf_weight_table(
        tables, node.attr("target_treeids"), node.attr("target_nodeids"),
        node.attr("target_ids"), node.attr("target_weights"), n_targets))
    base = ctx.cached(key + ("base",), lambda: np.asarray(
        node.attr("base_values", [0.0] * n_targets), np.float32))
    agg = _str(node.attr("aggregate_function", "SUM"))
    per_tree = table[_tree_walk(_t(X), node, tables)]   # (N, T, n_targets)
    if agg == "SUM":
        scores = per_tree.sum(dim=1)
    elif agg == "AVERAGE":
        scores = per_tree.mean(dim=1)
    elif agg == "MIN":
        scores = per_tree.amin(dim=1)
    elif agg == "MAX":
        scores = per_tree.amax(dim=1)
    else:
        raise ValueError(f"TreeEnsembleRegressor aggregate {agg!r}")
    return _post_transform(node, scores + base)


# --- quantized inference (QDQ + QLinear + integer ops) ----------------------
# dequantize -> float op -> requantize, the standard QDQ reference semantics
# (the spec defines QLinear* ops by that decomposition); integer products
# run in float64, exact for every sum below 2^53, and come back as int32.

_INT_RANGE = {torch.uint8: (0, 255), torch.int8: (-128, 127),
              torch.int16: (-32768, 32767), torch.int32: (-2 ** 31,
                                                          2 ** 31 - 1)}


def _axis_shape(v, ndim, axis):
    if v.dim() == 1 and v.shape[0] > 1:
        shape = [1] * ndim
        shape[axis] = v.shape[0]
        return v.reshape(shape)
    return v


def _dequant(x, scale, zp, axis, ndim=None):
    x = _t(x)
    s = _t(scale).to(torch.float32)
    z = _t(zp).to(torch.float32)
    ndim = ndim if ndim is not None else x.dim()
    return (x.to(torch.float32) - _axis_shape(z, ndim, axis)) \
        * _axis_shape(s, ndim, axis)


def _quant(x, scale, zp, axis, dtype):
    s = _axis_shape(_t(scale).to(torch.float32), x.dim(), axis)
    z = _axis_shape(_t(zp).to(torch.float32), x.dim(), axis)
    lo, hi = _INT_RANGE[dtype]
    q = torch.clamp(torch.round(x / s) + z, lo, hi)
    return q.to(dtype)


def _zp_dtype(zp):
    return _torch_dtype_of(zp) if zp is not None else torch.uint8


@op("DequantizeLinear")
def _dequantize_linear(node, x, scale, zp=None):
    if zp is None:
        zp = np.zeros((), np.int32)
    return _dequant(x, scale, zp, node.attr("axis", 1))


@op("QuantizeLinear")
def _quantize_linear(node, x, scale, zp=None):
    dtype = _zp_dtype(zp)
    if zp is None:
        zp = np.zeros((), np.uint8)
    return _quant(_t(x).to(torch.float32), scale, zp, node.attr("axis", 1),
                  dtype)


@op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(node, x):
    """uint8 dynamic quantization (spec formula: range always spans 0)."""
    x = _t(x).to(torch.float32)
    xmin = torch.clamp_max(x.min(), 0.0)
    xmax = torch.clamp_min(x.max(), 0.0)
    scale = (xmax - xmin) / 255.0
    scale = torch.where(scale == 0, 1.0, scale)
    zp = torch.clamp(torch.round(-xmin / scale), 0, 255)
    q = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return q, scale, zp.to(torch.uint8)


@op("QLinearConv")
def _qlinear_conv(node, x, xs, xzp, w, ws, wzp, ys, yzp, b=None):
    xf = _dequant(x, xs, xzp, 1)
    wf = _dequant(w, ws, wzp, 0)          # weight quant axis = output chan
    out = _conv_t(node, xf, wf)
    if b is not None:
        # bias is int32 with scale xs*ws (spec), zero_point 0
        bs = _t(xs).to(torch.float32) * _t(ws).to(torch.float32).reshape(-1)
        bf = _t(b).to(torch.float32) * bs
        out = out + bf.reshape((1, -1) + (1,) * (out.dim() - 2))
    return _quant(out, ys, yzp, 1, _zp_dtype(yzp))


@op("QLinearMatMul")
def _qlinear_matmul(node, a, as_, azp, b, bs, bzp, ys, yzp):
    # 1-D a-side params are per-ROW (axis ndim-2); b-side per-COLUMN
    a_, b_ = _t(a), _t(b)
    af = _dequant(a_, as_, azp, a_.dim() - 2)
    bf = _dequant(b_, bs, bzp, b_.dim() - 1)
    out = af @ bf
    return _quant(out, ys, yzp, out.dim() - 1, _zp_dtype(yzp))


def _int_shift(v, zp, axis):
    """v - zero_point, exact (float64 holds every 8/16-bit difference); a
    1-D zero point broadcasts along ``axis``."""
    out = v.to(torch.float64)
    if zp is None:
        return out
    return out - _axis_shape(_t(zp).to(torch.float64), v.dim(), axis)


@op("MatMulInteger")
def _matmul_integer(node, a, b, azp=None, bzp=None):
    # a-side 1-D zero point is per-ROW, b-side per-COLUMN (spec)
    a, b = _t(a), _t(b)
    ai = _int_shift(a, azp, a.dim() - 2)
    bi = _int_shift(b, bzp, b.dim() - 1)
    return torch.round(ai @ bi).to(torch.int32)


@op("ConvInteger")
def _conv_integer(node, x, w, xzp=None, wzp=None):
    x, w = _t(x), _t(w)
    xi = _int_shift(x, xzp, 1)             # per-input-channel
    wi = _int_shift(w, wzp, 0)             # per-output-channel
    return torch.round(_conv_t(node, xi, wi)).to(torch.int32)


# --- scatter/gather family + detection ops ---------------------------------

@op("IsNaN")
def _isnan(node, x):
    return torch.isnan(_t(x))


@op("IsInf")
def _isinf(node, x):
    x = _t(x)
    pos = bool(node.attr("detect_positive", 1))
    neg = bool(node.attr("detect_negative", 1))
    return (torch.isposinf(x) & pos) | (torch.isneginf(x) & neg)


@op("Sign")
def _sign(node, x):
    return torch.sign(_t(x))


@op("GatherElements")
def _gather_elements(node, x, idx):
    x, idx = _t(x), _t(idx).to(torch.int64)
    axis = node.attr("axis", 0) % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis, idx)


_REDUCE = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}


@op("ScatterElements")
def _scatter_elements(node, x, idx, updates):
    x, idx, upd = _t(x), _t(idx).to(torch.int64), _t(updates)
    axis = node.attr("axis", 0) % x.dim()
    red = _str(node.attr("reduction", "none"))
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    upd = upd.to(x.dtype)
    if red == "none":
        return x.scatter(axis, idx, upd)
    if red not in _REDUCE:
        raise ValueError(f"ScatterElements reduction {red!r}")
    return x.scatter_reduce(axis, idx, upd, _REDUCE[red], include_self=True)


@op("GatherND")
def _gather_nd(node, x, idx):
    if int(node.attr("batch_dims", 0)):
        raise ValueError("GatherND: batch_dims > 0 not supported yet")
    x, idx = _t(x), _t(idx).to(torch.int64)
    k = idx.shape[-1]
    return x[tuple(idx[..., i] for i in range(k))]


@op("ScatterND")
def _scatter_nd(node, x, idx, updates):
    x, idx, upd = _t(x), _t(idx).to(torch.int64), _t(updates)
    red = _str(node.attr("reduction", "none"))
    k = idx.shape[-1]
    lead = tuple(x.shape[:k])
    # the k leading dims as one linear index into a (prod(lead), ...) view
    lin = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=x.device)
    for i, size in enumerate(lead):
        v = idx[..., i]
        lin = lin * size + torch.where(v < 0, v + size, v)
    rest = tuple(x.shape[k:])
    flat = x.reshape((-1,) + rest)
    src = upd.to(x.dtype).reshape((-1,) + rest)
    lin = lin.reshape(-1)
    if red == "none":
        out = flat.index_copy(0, lin, src)
    elif red == "add":
        out = flat.index_add(0, lin, src)
    elif red in _REDUCE:
        out = flat.index_reduce(0, lin, src, {"mul": "prod", "max": "amax",
                                              "min": "amin"}[red],
                                include_self=True)
    else:
        raise ValueError(f"ScatterND reduction {red!r}")
    return out.reshape(x.shape)


@op("RoiAlign")
def _roi_align(node, x, rois, batch_indices):
    """(num_rois, C, oh, ow) bilinear ROI pooling, with the JAX package's
    documented deviation: sampling_ratio=0 uses the static bound
    ceil(map_size/output_size) samples per bin."""
    oh = int(node.attr("output_height", 1))
    ow = int(node.attr("output_width", 1))
    scale = float(node.attr("spatial_scale", 1.0))
    sr = int(node.attr("sampling_ratio", 0))
    mode = _str(node.attr("mode", "avg"))
    ctm = _str(node.attr("coordinate_transformation_mode", "half_pixel"))
    offset = 0.5 if ctm == "half_pixel" else 0.0
    x = _t(x).to(torch.float32)
    N, C, H, W = x.shape
    roi = _t(rois).to(torch.float32) * scale - offset       # (R, 4)
    bi = _t(batch_indices).to(torch.int64)
    R = roi.shape[0]
    x1, y1, x2, y2 = roi[:, 0], roi[:, 1], roi[:, 2], roi[:, 3]
    rh, rw = y2 - y1, x2 - x1
    if ctm != "half_pixel":
        # the min-size-1 clamp is the LEGACY (output_half_pixel) rule
        rh = torch.clamp_min(rh, 1.0)
        rw = torch.clamp_min(rw, 1.0)
    bh, bw = rh / oh, rw / ow
    s_h = sr if sr > 0 else int(np.ceil(H / oh))
    s_w = sr if sr > 0 else int(np.ceil(W / ow))
    dev = x.device
    grid_h = (torch.arange(oh, device=dev, dtype=torch.float32)[:, None]
              + (torch.arange(s_h, device=dev, dtype=torch.float32)[None, :]
                 + 0.5) / s_h).reshape(-1)                   # (oh*s_h,)
    grid_w = (torch.arange(ow, device=dev, dtype=torch.float32)[:, None]
              + (torch.arange(s_w, device=dev, dtype=torch.float32)[None, :]
                 + 0.5) / s_w).reshape(-1)                   # (ow*s_w,)
    iy = y1[:, None] + grid_h[None, :] * bh[:, None]         # (R, Ly)
    ix = x1[:, None] + grid_w[None, :] * bw[:, None]         # (R, Lx)
    yy = torch.clamp(iy, 0.0, H - 1)
    xx = torch.clamp(ix, 0.0, W - 1)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    y1_ = torch.clamp_max(y0 + 1, H - 1)
    x1_ = torch.clamp_max(x0 + 1, W - 1)
    wy = yy - y0
    wx = xx - x0
    img = x[bi]                                              # (R, C, H, W)
    r_ix = torch.arange(R, device=dev)[:, None, None]

    def at(yi, xi):                                          # (R, C, Ly, Lx)
        return img[r_ix, :, yi[:, :, None], xi[:, None, :]].permute(
            0, 3, 1, 2)

    def wgt(a, b):
        return (a[:, :, None] * b[:, None, :])[:, None]
    g = at(y0, x0) * wgt(1 - wy, 1 - wx)
    g = g + at(y0, x1_) * wgt(1 - wy, wx)
    g = g + at(y1_, x0) * wgt(wy, 1 - wx)
    g = g + at(y1_, x1_) * wgt(wy, wx)
    samples = g.reshape(R, C, oh, s_h, ow, s_w)
    if mode == "max":
        return samples.amax(dim=(3, 5))
    return samples.mean(dim=(3, 5))


@op("NonMaxSuppression")
def _nms(node, boxes, scores, max_out=None, iou_thr=None, score_thr=None):
    """selected_indices (S, 3) of [batch, class, box], S = batch * classes
    * max_output_boxes_per_class, unused slots -1 (the JAX package's static
    form; max_output_boxes_per_class must be a constant). Greedy
    suppression runs for every (batch, class) at once."""
    if max_out is None:
        raise ValueError("NonMaxSuppression: max_output_boxes_per_class "
                         "input is required (static bound)")
    M = int(np.asarray(_static(max_out, "max_output_boxes_per_class",
                               node)).ravel()[0])
    boxes, scores = _t(boxes).to(torch.float32), _t(scores).to(torch.float32)
    iou_t = (_t(iou_thr).to(torch.float32).reshape(-1)[0]
             if iou_thr is not None else 0.0)
    score_t = (_t(score_thr).to(torch.float32).reshape(-1)[0]
               if score_thr is not None else -math.inf)
    B, nC, nB = scores.shape
    if node.attr("center_point_box", 0):
        cx, cy, w, h = boxes.unbind(-1)
        y1, x1 = cy - h / 2, cx - w / 2
        y2, x2 = cy + h / 2, cx + w / 2
    else:
        y1, x1, y2, x2 = boxes.unbind(-1)
        y1, y2 = torch.minimum(y1, y2), torch.maximum(y1, y2)
        x1, x2 = torch.minimum(x1, x2), torch.maximum(x1, x2)
    area = (y2 - y1) * (x2 - x1)                             # (B, nB)
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    inter = (torch.clamp_min(yy2 - yy1, 0.0)
             * torch.clamp_min(xx2 - xx1, 0.0))
    iou = inter / torch.clamp_min(area[:, :, None] + area[:, None, :]
                                  - inter, 1e-9)             # (B, nB, nB)
    dev = scores.device
    alive = torch.ones((B, nC, nB), dtype=torch.bool, device=dev)
    b_ix = torch.arange(B, device=dev)[:, None].expand(B, nC)
    picked = []
    for _ in range(M):
        masked = torch.where(alive, scores, -math.inf)
        i = torch.argmax(masked, dim=-1)                     # (B, nC)
        ok = torch.gather(masked, 2, i[..., None])[..., 0] > score_t
        rows = iou[b_ix, i]                                  # (B, nC, nB)
        keep = alive & (rows <= iou_t)
        keep = keep.scatter(2, i[..., None], False)
        alive = torch.where(ok[..., None], keep, False)
        # once a class fails, every later pick of it fails too
        picked.append(torch.where(ok, i, -1))
    picked = torch.stack(picked, dim=-1) if M else torch.zeros(
        (B, nC, 0), dtype=torch.int64, device=dev)           # (B, nC, M)
    valid = picked >= 0
    b_idx = torch.arange(B, device=dev)[:, None, None].expand_as(picked)
    c_idx = torch.arange(nC, device=dev)[None, :, None].expand_as(picked)
    out = torch.stack([torch.where(valid, b_idx, -1),
                       torch.where(valid, c_idx, -1), picked], dim=-1)
    return out.reshape(-1, 3).to(torch.int64)


# --- com.microsoft contrib ops (ORT-optimized transformer graphs) ----------

@op("FusedMatMul")
def _fused_matmul(node, a, b):
    if node.attr("transBatchA", 0) or node.attr("transBatchB", 0):
        raise ValueError("FusedMatMul: transBatchA/transBatchB not "
                         "supported")
    a, b = _t(a), _t(b)
    if node.attr("transA", 0):
        a = a.transpose(-1, -2)
    if node.attr("transB", 0):
        b = b.transpose(-1, -2)
    return node.attr("alpha", 1.0) * _matmul_t(a, b)


@op("FastGelu")
def _fast_gelu(node, x, bias=None):
    x = _t(x)
    if bias is not None:
        x = x + _t(bias)
    return F.gelu(x, approximate="tanh")


@op("BiasGelu")
def _bias_gelu(node, x, bias):
    return F.gelu(_t(x) + _t(bias), approximate="none")


@op("QuickGelu")
def _quick_gelu(node, x):
    x = _t(x)
    return x * torch.sigmoid(node.attr("alpha", 1.702) * x)


@op("SkipLayerNormalization")
def _skip_layernorm(node, x, skip, gamma, beta=None, bias=None):
    eps = node.attr("epsilon", 1e-12)
    h = _t(x) + _t(skip)
    if bias is not None:
        h = h + _t(bias)
    mean = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, correction=0)
    out = (h - mean) / torch.sqrt(var + eps) * _t(gamma)
    if beta is not None:
        out = out + _t(beta)
    # contrib outputs: (out, mean, inv_std_var, input_skip_bias_sum)
    return out, mean, 1.0 / torch.sqrt(var + eps), h


@op("EmbedLayerNormalization")
def _embed_layernorm(node, ids, seg_ids, word_emb, pos_emb, seg_emb=None,
                     gamma=None, beta=None, mask=None, position_ids=None):
    eps = node.attr("epsilon", 1e-12)
    ids = _t(ids).to(torch.int64)
    pos_emb = _t(pos_emb)
    h = _t(word_emb)[ids]
    if position_ids is not None:
        h = h + pos_emb[_t(position_ids).to(torch.int64)]
    else:
        h = h + pos_emb[:ids.shape[1]][None, :, :]
    if seg_emb is not None and seg_ids is not None:
        h = h + _t(seg_emb)[_t(seg_ids).to(torch.int64)]
    mean = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, correction=0)
    out = (h - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        out = out * _t(gamma)
    if beta is not None:
        out = out + _t(beta)
    mask_index = (_t(mask).to(torch.int32).sum(dim=1, dtype=torch.int32)
                  if mask is not None
                  else torch.full((ids.shape[0],), ids.shape[1],
                                  dtype=torch.int32, device=ids.device))
    return out, mask_index


def _sdpa_core(q, k, v, scale, attention_bias, key_padding_mask, causal,
               op_name):
    """Scaled-dot-product attention shared by the fused contrib ops: (B,
    nh, S, D) heads in and out; ORT's -10000 masking for the raw (B, Skv)
    key-padding mask and the causal triangle."""
    logits = _matmul_t(q, k.transpose(-1, -2)) * scale       # (B,nh,Sq,Skv)
    if attention_bias is not None:
        logits = logits + _t(attention_bias)
    if key_padding_mask is not None:
        kpm = _t(key_padding_mask)
        if kpm.dim() != 2:
            raise ValueError(f"{op_name}: only the raw (B, Skv) "
                             "key-padding mask form is supported")
        logits = torch.where(kpm.to(torch.bool)[:, None, None, :], logits,
                             -10000.0)
    if causal:
        s_q, s_kv = q.shape[2], k.shape[2]
        tri = (torch.arange(s_q, device=q.device)[:, None]
               >= torch.arange(s_kv, device=q.device)[None, :])
        logits = torch.where(tri[None, None], logits, -10000.0)
    probs = torch.softmax(logits, dim=-1)
    return _matmul_t(probs, v)                               # (B,nh,Sq,D)


@op("Attention")
def _attention(node, x, w, b=None, mask_index=None, past=None,
               attention_bias=None):
    """com.microsoft fused self-attention: input (B, S, Hin), packed QKV
    weight (Hin, 3*Hout), bias (3*Hout); num_heads, unidirectional and the
    raw (B, S) 0/1 key-padding mask; no past/present KV cache."""
    if past is not None:
        raise ValueError("Attention: past/present KV cache not supported")
    x, w = _t(x), _t(w)
    nh = int(node.attr("num_heads"))
    uni = bool(node.attr("unidirectional", 0))
    B, S, _ = x.shape
    H3 = w.shape[1]
    sizes = node.attr("qkv_hidden_sizes")
    if sizes:
        qh, kh, vh = (int(v_) for v_ in sizes)
        if qh + kh + vh != H3 or qh != kh:
            raise ValueError("Attention: qkv_hidden_sizes must sum to the "
                             "packed width with q == k")
    else:
        qh = kh = vh = H3 // 3
    qkv = _matmul_t(x, w)
    if b is not None:
        qkv = qkv + _t(b)
    q, k, v = (qkv[..., :qh], qkv[..., qh:qh + kh], qkv[..., qh + kh:])

    def heads(t, hsz):
        return t.reshape(B, S, nh, hsz // nh).permute(0, 2, 1, 3)

    q, k, v = heads(q, qh), heads(k, kh), heads(v, vh)
    scale = node.attr("scale", 0.0) or 1.0 / np.sqrt(qh // nh)
    out = _sdpa_core(q, k, v, float(scale), attention_bias, mask_index,
                     causal=uni, op_name="Attention")
    return out.permute(0, 2, 1, 3).reshape(B, S, vh)


@op("MultiHeadAttention")
def _multi_head_attention(node, query, key=None, value=None, bias=None,
                          key_padding_mask=None, attention_bias=None,
                          past_key=None, past_value=None):
    """com.microsoft MultiHeadAttention: separate (B, S, hidden) q/k/v with
    optional packed bias, raw (B, Skv) key-padding mask, additive bias and
    ``unidirectional``; no KV caches or packed-QKV query forms."""
    if past_key is not None or past_value is not None:
        raise ValueError("MultiHeadAttention: past KV cache not supported")
    if key is None or value is None:
        raise ValueError("MultiHeadAttention: packed-QKV query form not "
                         "supported (pass separate key/value)")
    query, key, value = _t(query), _t(key), _t(value)
    nh = int(node.attr("num_heads"))
    B, Sq, Hq = query.shape
    if bias is not None:
        bias = _t(bias)
        query = query + bias[:Hq]
        key = key + bias[Hq:Hq + key.shape[-1]]
        value = value + bias[Hq + key.shape[-1]:]

    def heads(t):
        return t.reshape(B, t.shape[1], nh, -1).permute(0, 2, 1, 3)

    q, k, v = heads(query), heads(key), heads(value)
    scale = node.attr("scale", 0.0) or 1.0 / np.sqrt(Hq // nh)
    out = _sdpa_core(q, k, v, float(scale), attention_bias, key_padding_mask,
                     causal=bool(node.attr("unidirectional", 0)),
                     op_name="MultiHeadAttention")
    return out.permute(0, 2, 1, 3).reshape(B, Sq, -1)


# --- remaining deterministic standard ops ------------------------------------

@op("Hardmax")
def _hardmax(node, x):
    x = _t(x)
    axis = int(node.attr("axis", -1))
    idx = torch.argmax(x, dim=axis)
    return _one_hot(idx, x.shape[axis], axis, x.dtype)


@op("Celu")
def _celu(node, x):
    x = _t(x)
    a = float(node.attr("alpha", 1.0))
    return torch.clamp_min(x, 0.0) + torch.clamp_max(
        a * (torch.exp(x / a) - 1.0), 0.0)


@op("Mish")
def _mish(node, x):
    x = _t(x)
    return x * torch.tanh(_softplus_t(x))


@op("Shrink")
def _shrink(node, x):
    x = _t(x)
    lambd = float(node.attr("lambd", 0.5))
    bias = float(node.attr("bias", 0.0))
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, torch.zeros_like(x)))


@op("ThresholdedRelu")
def _thresholded_relu(node, x):
    x = _t(x)
    a = float(node.attr("alpha", 1.0))
    return torch.where(x > a, x, torch.zeros_like(x))


@op("BitShift")
def _bitshift(node, x, y):
    d = node.attr("direction")
    d = d if isinstance(d, str) else (d or b"LEFT").decode()
    x, y = _t(x), _t(y)
    return torch.bitwise_left_shift(x, y) if d.upper() == "LEFT" \
        else torch.bitwise_right_shift(x, y)


@op("EyeLike")
def _eyelike(node, x):
    x = x if isinstance(x, torch.Tensor) else _t(x)
    k = int(node.attr("k", 0))
    dt = node.attr("dtype")
    if dt is not None:
        dtype = TORCH_DTYPES.get(int(dt))
        if dtype is None:
            raise ValueError(f"EyeLike: unsupported dtype code {int(dt)}")
    else:
        dtype = x.dtype
    n, m = x.shape[0], x.shape[1]
    rows = torch.arange(n, device=_dev())[:, None]
    cols = torch.arange(m, device=_dev())[None, :]
    return (cols - rows == k).to(dtype)


@op("Det")
def _det(node, x):
    return torch.linalg.det(_t(x))


@op("LRN")
def _lrn(node, x):
    """Cross-channel local response normalization (NCHW, channel axis 1):
    y = x / (bias + alpha/size * window_sum(x^2))^beta."""
    x = _t(x)
    alpha = float(node.attr("alpha", 1e-4))
    beta = float(node.attr("beta", 0.75))
    bias = float(node.attr("bias", 1.0))
    size = int(node.attr("size"))
    half_lo = (size - 1) // 2
    half_hi = size // 2
    sq = x * x
    pad = [0, 0] * (sq.dim() - 2) + [half_lo, half_hi]
    padded = F.pad(sq, pad)
    win = padded[:, 0:x.shape[1]]
    for i in range(1, size):
        win = win + padded[:, i:i + x.shape[1]]
    return x / (bias + (alpha / size) * win) ** beta


@op("GridSample")
def _grid_sample(node, x, grid):
    """2-D bilinear/nearest grid sampling: x (N, C, Hin, Win), grid (N,
    Hout, Wout, 2) with xy in [-1, 1]; zeros / border padding, align_corners
    both ways."""
    mode = _str(node.attr("mode", "linear"))
    pad_mode = _str(node.attr("padding_mode", "zeros"))
    align = bool(node.attr("align_corners", 0))
    if mode not in ("linear", "bilinear", "nearest"):
        raise ValueError(f"GridSample: mode {mode!r} not supported")
    if pad_mode not in ("zeros", "border"):
        raise ValueError(f"GridSample: padding_mode {pad_mode!r} "
                         "not supported")
    x, grid = _t(x), _t(grid)
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]          # (N, Ho, Wo), in [-1, 1]
    if align:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    flat = x.reshape(N, C, H * W)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        cx = torch.clamp(ix, 0, W - 1)
        cy = torch.clamp(iy, 0, H - 1)
        lin = (cy * W + cx).reshape(N, 1, -1).to(torch.int64)
        v = torch.gather(flat, 2, lin.expand(N, C, lin.shape[-1]))
        v = v.reshape((N, C) + tuple(ix.shape[1:]))
        if pad_mode == "zeros":
            v = v * inb[:, None].to(v.dtype)
        return v

    if mode == "nearest":
        return gather(torch.round(fx).to(torch.int32),
                      torch.round(fy).to(torch.int32))
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    x1, y1 = x0 + 1, y0 + 1
    wx = (fx - x0).to(x.dtype)[:, None]
    wy = (fy - y0).to(x.dtype)[:, None]
    v00, v01 = gather(x0, y0), gather(x1, y0)
    v10, v11 = gather(x0, y1), gather(x1, y1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


# --- Random* and Multinomial ---------------------------------------------------
# Deterministic, as in the JAX package: threefry keyed by the ``seed``
# attribute, else by zlib.crc32 of the node's first output name, drawn bit
# for bit as ``jax.random`` draws them (``core/prng.py``).

def _random_common(node, shape, like_dtype=None):
    dt = node.attr("dtype")
    if dt is not None:
        dtype = TORCH_DTYPES.get(int(dt))
        if dtype is None:
            raise ValueError(f"Random*: unsupported dtype code {int(dt)}")
    else:
        # spec: the Like forms inherit the input tensor's dtype
        dtype = like_dtype if like_dtype is not None else torch.float32
    seed = node.attr("seed")
    if seed is not None:
        key = prng.prng_key(int(seed))
    else:
        # seed-less nodes must still decorrelate: key off the node's first
        # output name, stably hashed
        ident = (node.outputs[0] if node.outputs else node.name) or "rng"
        key = prng.prng_key(zlib.crc32(ident.encode()))
    return key, tuple(int(s) for s in shape), dtype


def _float_draw(dtype, op_name):
    if dtype not in (torch.float32,):
        raise ValueError(f"{op_name}: dtype {dtype} is not supported (the "
                         "draws are float32, as jax.random's with 64-bit "
                         "types off)")


@op("RandomNormal")
def _random_normal(node):
    key, shape, dtype = _random_common(node, node.attr("shape"))
    _float_draw(dtype, "RandomNormal")
    mean = float(node.attr("mean", 0.0))
    scale = float(node.attr("scale", 1.0))
    return mean + scale * prng.normal(key, shape, _dev())


@op("RandomUniform")
def _random_uniform(node):
    key, shape, dtype = _random_common(node, node.attr("shape"))
    _float_draw(dtype, "RandomUniform")
    return prng.uniform_range(key, shape, float(node.attr("low", 0.0)),
                              float(node.attr("high", 1.0)), _dev())


@op("RandomNormalLike")
def _random_normal_like(node, x):
    key, shape, dtype = _random_common(node, x.shape,
                                       like_dtype=_torch_dtype_of(x))
    _float_draw(dtype, "RandomNormalLike")
    mean = float(node.attr("mean", 0.0))
    scale = float(node.attr("scale", 1.0))
    return mean + scale * prng.normal(key, shape, _dev())


@op("RandomUniformLike")
def _random_uniform_like(node, x):
    key, shape, dtype = _random_common(node, x.shape,
                                       like_dtype=_torch_dtype_of(x))
    _float_draw(dtype, "RandomUniformLike")
    return prng.uniform_range(key, shape, float(node.attr("low", 0.0)),
                              float(node.attr("high", 1.0)), _dev())


@op("Multinomial")
def _multinomial(node, x):
    """Categorical sampling from unnormalized log-probabilities per row,
    ``jax.random.categorical``'s Gumbel-max draw; the dtype attribute is
    honored (spec default int32)."""
    x = _t(x).to(torch.float32)
    n = int(node.attr("sample_size", 1))
    key, _, dtype = _random_common(node, (), like_dtype=torch.int32)
    out = prng.categorical(key, x, (n, x.shape[0]))          # (n, batch)
    return out.T.to(dtype)
