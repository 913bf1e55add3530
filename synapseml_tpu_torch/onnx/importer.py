"""ONNX graph → a function of torch tensors.

The port's counterpart of the JAX package's ``onnx/importer.py``. The graph
work is the same: ``_make_plan`` slices the graph to the asked outputs,
``fold_constants`` promotes constant-only nodes to initializers,
``_inline_constant_ifs`` and ``_unroll_constant_loops`` resolve control
flow whose condition or trip count is a constant. Then the weights are
decoded once and the larger ones moved to the device once; the plan runs
node by node on torch tensors (``ops.py``), so one call is as many kernel
launches as the graph has operations, and ``ONNXModel`` captures the whole
call in a CUDA graph per batch bucket (``core/inference.py``).

Control flow that depends on data runs without reading the device:

* a runtime ``If`` evaluates both branches and selects on the device (the
  JAX package's ``lax.cond`` requires matching branch shapes too);
* a runtime ``Loop`` runs its trip bound (the static trip count, else
  ``max_loop_trips``) with the carried state and scan outputs masked on the
  device after the exit, as the JAX package's ``lax.while_loop`` with its
  zero-padded scan buffers gives; on the CPU, where reading is free, a loop
  stops as soon as it has exited, a loop without scan outputs runs past the
  bound as the JAX package's does, and hitting the bound with the condition
  still true and scan outputs to fill raises; on the card, a loop that
  reaches ``max_loop_trips`` leaves a device flag, true when its condition
  still held there, and the call raises once the flag is read (at the end
  of an eager call; after the copy-out for ``ONNXModel``'s captured graphs);
* ``Scan`` has static trips.

A condition or trip count that is a host value (a ``Shape`` result, a
constant) is read on the host: it is the same for every call at one input
shape, so a captured graph keeps it.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .ops import (HOST_MAX, REGISTRY, Context, context, host_call, is_host,
                  torch_dtype, using)
from .protoio import Attribute, Graph, Model, Node, Tensor

# the running call's device bools, one for each Loop on the card that
# stopped at max_loop_trips: true where its condition still held there
_calls = threading.local()


def loop_bound_error(max_loop_trips: int) -> ValueError:
    return ValueError(
        f"a Loop ran max_loop_trips={max_loop_trips} trips on the device "
        f"with its condition still true — its results would be truncated. "
        f"Raise max_loop_trips.")


class OnnxFunction:
    """Callable wrapper: ``fn(feeds: dict) -> dict`` of torch tensors over
    the requested outputs, on ``device`` (default ``"cuda"``; a missing card
    raises).

    ``precision="bfloat16"`` keeps the JAX package's rule: float32 weights
    and feeds go to bf16, each op's result folds back to bf16 (products
    accumulate in float32 first), an explicit ``Cast`` keeps the type it
    asked for, and bf16 outputs come back as float32.
    """

    def __init__(self, model: Model, outputs: Optional[Sequence[str]] = None,
                 precision: str = "float32", max_loop_trips: int = 128,
                 device=DEFAULT_DEVICE):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be 'float32' or 'bfloat16', "
                             f"got {precision!r}")
        if int(max_loop_trips) < 1:
            raise ValueError(f"max_loop_trips must be >= 1, "
                             f"got {max_loop_trips}")
        self.device = resolve_device(device)
        self.model = model
        self.precision = precision
        self.max_loop_trips = int(max_loop_trips)
        self._bf16 = precision == "bfloat16"
        self._on_card = self.device.type == "cuda"
        # host values copied to the device, by value (see ops.Context)
        self._ctx = Context(self.device, bf16=self._bf16)
        g = model.graph
        # shared fixpoint: unrolling a Loop can expose constant Ifs and
        # vice versa (nested control flow) — alternate until neither changes
        for _ in range(32):
            if not (_inline_constant_ifs(g) | _unroll_constant_loops(g)):
                break
        self.graph_inputs = [vi.name for vi in g.inputs
                             if vi.name not in g.initializers]
        self.input_info = {vi.name: vi for vi in g.inputs}
        self.outputs = list(outputs) if outputs else [vi.name for vi in g.outputs]
        self._plan = self._make_plan(g, self.outputs)
        # decode weights ONCE, and only those the sliced plan reads
        # (subgraph-captured names included)
        used = ({i for n in self._plan for i in _node_reads(n)}
                | set(self.outputs))
        self._weights = {k: self._place(t.array())
                         for k, t in g.initializers.items() if k in used}
        # Constant nodes evaluate once, here, and join the weights
        runtime = []
        for n in self._plan:
            if n.op_type == "Constant" and n.outputs and n.outputs[0]:
                self._weights[n.outputs[0]] = self._place(
                    host_call(REGISTRY["Constant"], n))
            else:
                runtime.append(n)
        self._plan = runtime
        self._subcache: Dict[int, Tuple[Dict, List[str]]] = {}
        # names to drop from the environment after each plan node (their
        # last reader), so a call holds only live activations, as XLA's
        # buffer assignment does: the captured graph's pool stays small
        keep = set(self.outputs) | set(self._weights)
        last: Dict[str, int] = {}
        for i, n in enumerate(self._plan):
            for name in _node_reads(n) + list(n.outputs):
                if name and name not in keep:
                    last[name] = i
        self._frees: List[List[str]] = [[] for _ in self._plan]
        for name, i in last.items():
            self._frees[i].append(name)

    @staticmethod
    def _make_plan(g: Graph, outputs: Sequence[str]) -> List[Node]:
        """Nodes needed for ``outputs``, in topological order (graph
        slicing)."""
        producer: Dict[str, Node] = {}
        for n in g.nodes:
            for o in n.outputs:
                producer[o] = n
        known = set(g.initializers) | {vi.name for vi in g.inputs}
        plan: List[Node] = []
        done = set()      # node ids fully emitted
        in_stack = set()  # node ids on the current path (cycle check)
        # iterative post-order DFS — exported transformer graphs routinely
        # exceed Python's recursion limit in depth
        work: List[Tuple[str, bool]] = [(o, False) for o in reversed(outputs)]
        while work:
            name, expanded = work.pop()
            if name == "" or name in known:
                continue
            n = producer.get(name)
            if n is None:
                raise ValueError(f"tensor {name!r} has no producer and is not "
                                 f"a graph input/initializer")
            if expanded:
                in_stack.discard(id(n))
                if id(n) not in done:
                    done.add(id(n))
                    plan.append(n)
                continue
            if id(n) in done:
                continue
            if id(n) in in_stack:
                raise ValueError(f"cycle through {name!r}")
            in_stack.add(id(n))
            work.append((name, True))
            for i in reversed(_node_reads(n)):
                work.append((i, False))
        return plan

    # --- values ------------------------------------------------------------
    def _place(self, arr: np.ndarray):
        """A decoded weight: a host value when small (shapes, axes,
        scalars), else a tensor on the device (bf16 in bf16 mode)."""
        arr = np.asarray(arr)
        if arr.size <= HOST_MAX:
            return self._down(arr)
        return self._ctx.upload(arr)

    def _down(self, v):
        if not self._bf16:
            return v
        if isinstance(v, torch.Tensor):
            return v.to(torch.bfloat16) if v.dtype == torch.float32 else v
        a = np.asarray(v)
        if a.dtype == np.float32:
            # a host value keeps float32 storage with bf16's value; it goes
            # over to the device as bf16 (ops.Context)
            return torch.from_numpy(np.array(a, copy=True)).to(
                torch.bfloat16).float().numpy()
        return v

    def _feed(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            t = v.to(self.device)
        else:
            t = torch.from_numpy(np.array(np.asarray(v), copy=True)).to(
                self.device)
        return self._down(t)

    # --- execution ---------------------------------------------------------
    def __call__(self, feeds: Dict) -> Dict[str, torch.Tensor]:
        """The outputs for ``feeds``. A Loop cut at ``max_loop_trips`` on
        the card raises here, which reads the device; under a CUDA graph
        capture nothing can be read, so a captured call goes through
        ``_run`` and checks its flag after the replay."""
        out, cut = self._run(feeds)
        if cut is not None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "OnnxFunction: a graph with a device-conditioned Loop "
                    "cannot be checked inside a capture; score it through "
                    "ONNXModel")
            if bool(cut):
                raise loop_bound_error(self.max_loop_trips)
        return out

    def _run(self, feeds: Dict) -> Tuple[Dict[str, torch.Tensor],
                                         Optional[torch.Tensor]]:
        """(outputs, cut): ``cut`` is None when no Loop stopped at
        ``max_loop_trips`` on the device, else a device bool, true where
        one did with its condition still true."""
        _calls.exits = []
        try:
            out = self._outputs(feeds)
        finally:
            exits, _calls.exits = _calls.exits, None
        cut = torch.stack(exits).any() if exits else None
        return out, cut

    def _outputs(self, feeds: Dict) -> Dict[str, torch.Tensor]:
        env: Dict = dict(self._weights)
        for name in self.graph_inputs:
            if name not in feeds:
                raise ValueError(
                    f"missing input {name!r}; expected {self.graph_inputs}")
        for name, v in feeds.items():
            env[name] = self._feed(v)
        with using(self._ctx):
            self._run_nodes(self._plan, env, self._frees)
            out = {}
            for o in self.outputs:
                t = context().tensor(env[o])
                out[o] = t.float() if t.dtype == torch.bfloat16 else t
        return out

    def _apply(self, impl, node: Node, args: list):
        """One op: on the host when every input is a host value, else on
        the device."""
        if all(is_host(a) for a in args):
            return host_call(impl, node, *args)
        return impl(node, *args)

    def _run_nodes(self, nodes: Sequence[Node], env: Dict,
                   frees: Optional[List[List[str]]] = None) -> None:
        """Evaluate ``nodes`` (topological) into ``env`` in place — shared by
        the top-level plan and by control-flow subgraph bodies; ``frees[i]``
        names the values dead after node ``i``."""
        for k, node in enumerate(nodes):
            if node.op_type in ("If", "Loop", "Scan"):
                out = getattr(self, "_exec_" + node.op_type.lower())(node, env)
            else:
                impl = REGISTRY.get(node.op_type)
                if impl is None:
                    raise NotImplementedError(
                        f"ONNX op {node.op_type!r} (node {node.name!r}) is "
                        f"not supported; supported: {sorted(REGISTRY)}")
                args = [env[i] if i else None for i in node.inputs]
                out = self._apply(impl, node, args)
            if not isinstance(out, tuple):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    # products emit float32 accumulations; fold back to
                    # bf16 — except explicit Cast nodes: a graph-mandated
                    # float32 island keeps the precision it asked for
                    env[name] = (val if node.op_type == "Cast"
                                 else self._down(val))
            if frees is not None:
                for name in frees[k]:
                    env.pop(name, None)

    def _sub_info(self, sub: Graph) -> Tuple[Dict, List[str]]:
        """(placed initializers, sorted captured names) for a control-flow
        subgraph, cached per graph object."""
        info = self._subcache.get(id(sub))
        if info is None:
            info = ({k: self._place(t.array())
                     for k, t in sub.initializers.items()},
                    sorted(_free_names(sub)), sub)
            self._subcache[id(sub)] = info
        return info[0], info[1]

    def _run_subgraph(self, sub: Graph, bindings: Dict) -> tuple:
        """Run a control-flow body: fresh scope = its initializers,
        overwritten by formal-input/captured ``bindings``."""
        sub_env = dict(self._sub_info(sub)[0])
        sub_env.update(bindings)
        self._run_nodes(sub.nodes, sub_env)
        return tuple(sub_env[vi.name] for vi in sub.outputs)

    @staticmethod
    def _spec(v) -> tuple:
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), v.dtype
        a = np.asarray(v)
        return a.shape, torch_dtype(a.dtype)

    def _exec_if(self, node: Node, env: Dict):
        """Data-dependent If: a host condition picks its branch; a device
        condition evaluates both branches (matching shapes and dtypes,
        checked) and selects on the device."""
        then_g, else_g = node.attr("then_branch"), node.attr("else_branch")
        if then_g is None or else_g is None:
            raise ValueError(f"If node {node.name!r}: missing branch subgraph")
        for bname, br in (("then", then_g), ("else", else_g)):
            if len(br.outputs) != len(node.outputs):
                raise ValueError(
                    f"If node {node.name!r}: {bname} branch declares "
                    f"{len(br.outputs)} outputs but the If node has "
                    f"{len(node.outputs)}")
        captured = sorted(set(self._sub_info(then_g)[1])
                          | set(self._sub_info(else_g)[1]))
        bind = {c: env[c] for c in captured}
        cond = env[node.inputs[0]]
        if is_host(cond):
            br = then_g if bool(np.asarray(cond).ravel()[0]) else else_g
            return self._run_subgraph(br, bind)
        a_then = self._run_subgraph(then_g, bind)
        a_else = self._run_subgraph(else_g, bind)
        bad = [(self._spec(t), self._spec(e)) for t, e in zip(a_then, a_else)
               if self._spec(t) != self._spec(e)]
        if bad:
            raise ValueError(
                f"If node {node.name!r}: a runtime (data-dependent) If needs "
                f"both branches to produce matching shapes/dtypes — both are "
                f"evaluated and selected on the device. Mismatches: "
                + "; ".join(f"then {t[0]}/{t[1]} vs else {e[0]}/{e[1]}"
                            for t, e in bad))
        pred = context().tensor(cond).reshape(-1)[0] != 0
        tensor = context().tensor
        return tuple(torch.where(pred, tensor(t), tensor(e))
                     for t, e in zip(a_then, a_else))

    def _exec_loop(self, node: Node, env: Dict):
        """Data-dependent Loop (see the module docstring): host conditions
        and trip counts run exactly; device ones run the trip bound under a
        device mask, scan outputs zero past the exit and padded to the
        bound."""
        body = node.attr("body")
        if body is None:
            raise ValueError(f"Loop node {node.name!r}: missing body graph")
        m_name = node.inputs[0] if node.inputs else ""
        c_name = node.inputs[1] if len(node.inputs) > 1 else ""
        carried_names = list(node.inputs[2:])
        n_carried = len(carried_names)
        n_scan = len(node.outputs) - n_carried
        body_in = [vi.name for vi in body.inputs]
        if len(body_in) != 2 + n_carried or n_scan < 0 or \
                len(body.outputs) != 1 + n_carried + n_scan:
            raise ValueError(
                f"Loop node {node.name!r}: body signature mismatch — body "
                f"({len(body_in)} in, {len(body.outputs)} out) vs node "
                f"({n_carried} carried, {n_scan} scan outputs)")
        captured = self._sub_info(body)[1]
        cap = {c: env[c] for c in captured}
        tensor = context().tensor
        m_val = env[m_name] if m_name else None
        m_static = None
        if m_val is not None and is_host(m_val):
            m_static = int(np.asarray(m_val).ravel()[0])
            if m_static >= 2 ** 31 - 1:
                # torch serializes `while cond:` as Loop with trip_count
                # INT64_MAX — an unbounded sentinel, not a real bound
                m_val = m_static = None
        m_dev = None
        if m_val is not None and m_static is None:
            m_dev = tensor(m_val).reshape(-1)[0].to(torch.int64)
        bound = m_static if m_static is not None else self.max_loop_trips
        cond = env[c_name] if c_name else np.asarray(True)
        # the loop's state: ``active`` a Python bool while every condition
        # is a host value, else a device bool (masking from then on)
        active = (bool(np.asarray(cond).ravel()[0]) if is_host(cond)
                  else tensor(cond).reshape(-1)[0] != 0)
        carried = [env[i] for i in carried_names]
        scans: List[list] = [[] for _ in range(n_scan)]
        readable = not self._on_card
        i = 0
        while True:
            if m_static is not None and i >= m_static:
                break
            if m_dev is not None:
                ok = (i < m_dev) | (m_dev < 0)
                active = ok & active if isinstance(active, torch.Tensor) \
                    else ok & bool(active)
            masked = isinstance(active, torch.Tensor)
            if not masked and not active:
                break
            if masked and readable and not bool(active):
                break          # every later iteration is masked out
            if i >= bound and (n_scan or (masked and not readable)):
                if masked and not readable:
                    _calls.exits.append(active)
                    break
                still = bool(active)
                if still and n_scan:
                    raise ValueError(
                        f"Loop node {node.name!r}: exited at "
                        f"max_loop_trips={bound} with its condition still "
                        f"true — scan outputs would be truncated. Raise "
                        f"max_loop_trips.")
                break
            bindings = dict(cap)
            bindings[body_in[0]] = np.asarray(i, np.int64)
            bindings[body_in[1]] = (np.asarray(bool(active)) if not masked
                                    else active)
            bindings.update(zip(body_in[2:], carried))
            outs = self._run_subgraph(body, bindings)
            new_carried = list(outs[1:1 + n_carried])
            for k, (old, new) in enumerate(zip(carried, new_carried)):
                if self._spec(old) != self._spec(new):
                    raise ValueError(
                        f"Loop node {node.name!r}: carried state must keep a "
                        f"fixed shape/dtype across iterations. Mismatches: "
                        f"in {self._spec(old)[0]}/{self._spec(old)[1]} vs out "
                        f"{self._spec(new)[0]}/{self._spec(new)[1]}")
            c_out = outs[0]
            if masked:
                carried = [torch.where(active, tensor(n), tensor(o))
                           for o, n in zip(carried, new_carried)]
                for k, s in enumerate(outs[1 + n_carried:]):
                    s = tensor(s)
                    scans[k].append(torch.where(active, s,
                                                torch.zeros_like(s)))
                active = active & (tensor(c_out).reshape(-1)[0] != 0)
            else:
                carried = new_carried
                for k, s in enumerate(outs[1 + n_carried:]):
                    scans[k].append(s)
                active = (bool(np.asarray(c_out).ravel()[0])
                          if is_host(c_out)
                          else tensor(c_out).reshape(-1)[0] != 0)
            i += 1
        if n_scan and not scans[0]:
            # no iteration ran: the body's shapes give the zero stacks
            bindings = dict(cap)
            bindings[body_in[0]] = np.asarray(i, np.int64)
            bindings[body_in[1]] = np.asarray(False)
            bindings.update(zip(body_in[2:], carried))
            outs = self._run_subgraph(body, bindings)
            scans = [[torch.zeros_like(tensor(s))]
                     for s in outs[1 + n_carried:]]
        stacked = []
        for parts in scans:
            ts = [tensor(p) for p in parts]
            pad = bound - len(ts)
            if pad > 0:
                ts += [torch.zeros_like(ts[0])] * pad
            stacked.append(torch.stack(ts, 0))
        return tuple(carried) + tuple(stacked)

    def _exec_scan(self, node: Node, env: Dict):
        """ONNX Scan: static trips over the scan axis, carried state and
        stacked outputs."""
        body = node.attr("body")
        n_scan_in = int(node.attr("num_scan_inputs", 0))
        if body is None or not n_scan_in:
            raise ValueError(f"Scan node {node.name!r}: missing body or "
                             f"num_scan_inputs")
        n_state = len(node.inputs) - n_scan_in
        n_scan_out = len(node.outputs) - n_state
        body_in = [vi.name for vi in body.inputs]
        if len(body_in) != len(node.inputs) or n_state < 0 or \
                n_scan_out < 0 or len(body.outputs) != len(node.outputs):
            raise ValueError(
                f"Scan node {node.name!r}: body signature mismatch")
        tensor = context().tensor
        in_axes = node.attr("scan_input_axes") or [0] * n_scan_in
        in_dirs = node.attr("scan_input_directions") or [0] * n_scan_in
        out_axes = node.attr("scan_output_axes") or [0] * n_scan_out
        out_dirs = node.attr("scan_output_directions") or [0] * n_scan_out
        carry = [env[i] for i in node.inputs[:n_state]]
        xs = []
        for k, nm in enumerate(node.inputs[n_state:]):
            x = torch.movedim(tensor(env[nm]), int(in_axes[k]), 0)
            if int(in_dirs[k]):
                x = torch.flip(x, (0,))
            xs.append(x)
        captured = self._sub_info(body)[1]
        cap = {c: env[c] for c in captured}
        ys: List[list] = [[] for _ in range(n_scan_out)]
        for t in range(xs[0].shape[0]):
            bindings = dict(cap)
            bindings.update(zip(body_in[:n_state], carry))
            bindings.update(zip(body_in[n_state:], [x[t] for x in xs]))
            outs = self._run_subgraph(body, bindings)
            new = list(outs[:n_state])
            bad = [(self._spec(a), self._spec(b)) for a, b in zip(carry, new)
                   if self._spec(a) != self._spec(b)]
            if bad:
                raise ValueError(
                    f"Scan node {node.name!r}: carried state must keep a "
                    f"fixed shape/dtype across iterations. Mismatches: "
                    + "; ".join(f"in {a[0]}/{a[1]} vs out {b[0]}/{b[1]}"
                                for a, b in bad))
            carry = new
            for k, y in enumerate(outs[n_state:]):
                ys[k].append(tensor(y))
        out = []
        for k, parts in enumerate(ys):
            y = torch.stack(parts, 0)
            if int(out_dirs[k]):
                y = torch.flip(y, (0,))
            out.append(torch.movedim(y, 0, int(out_axes[k])))
        return tuple(carry) + tuple(out)

    def as_torch(self, names: Optional[List[str]] = None):
        """(fn, input_names): a positional callable over torch tensors
        returning a tuple of tensors in ``self.outputs`` order (what
        ``BucketedRunner`` captures). ``names`` overrides the positional
        input ordering (default: graph order)."""
        names = list(names) if names is not None else list(self.graph_inputs)

        def fn(*arrays):
            return tuple(self({n: a for n, a in zip(names, arrays)}).values())

        return fn, names

    def _runner_fn(self, names: List[str]):
        """``as_torch``'s callable with one more output, what
        ``BucketedRunner`` captures for ``ONNXModel``: a bool column over
        the batch, true where a Loop stopped at ``max_loop_trips`` on the
        card with its condition still true (``loop_bound_error``)."""

        def fn(*arrays):
            out, cut = self._run({n: a for n, a in zip(names, arrays)})
            if cut is None:
                cut = torch.zeros((), dtype=torch.bool, device=self.device)
            return tuple(out.values()) + (cut.reshape(1).repeat(
                arrays[0].shape[0]),)

        return fn


def _free_names(sub: Graph) -> set:
    """Outer-scope tensor names a subgraph captures: referenced by its nodes
    (or returned as passthrough outputs) but neither produced inside it, nor
    among its initializers, nor its formal inputs. Nested subgraphs recurse —
    an inner capture bound at this level is not free here."""
    bound = ({o for n in sub.nodes for o in n.outputs if o}
             | set(sub.initializers) | {vi.name for vi in sub.inputs})
    free = set()
    for n in sub.nodes:
        for i in n.inputs:
            if i and i not in bound:
                free.add(i)
        for a in n.attrs.values():
            if a.g is not None:
                free |= _free_names(a.g) - bound
    for vi in sub.outputs:
        if vi.name and vi.name not in bound:
            free.add(vi.name)
    return free


def _node_reads(n: Node) -> List[str]:
    """Every outer tensor ``n`` consumes: declared inputs plus names its
    subgraph attributes capture by scope."""
    reads = list(n.inputs)
    for a in n.attrs.values():
        if a.g is not None:
            reads.extend(sorted(_free_names(a.g)))
    return reads


def _resolve_constant(g: Graph, name: str, _depth: int = 0,
                      _producers=None, _memo=None):
    """The value of tensor ``name`` when derivable from initializers through
    constant-only ops; None when it depends on a graph input."""
    if name in g.initializers:
        return g.initializers[name].array()
    if _depth > 64:
        return None
    if _producers is None:
        _producers = {o: n for n in g.nodes for o in n.outputs if o}
    if _memo is None:
        _memo = {}
    if name in _memo:
        return _memo[name]
    _memo[name] = None               # cycle guard / negative cache
    producer = _producers.get(name)
    if producer is None or producer.op_type in ("Shape", "If"):
        return None
    impl = REGISTRY.get(producer.op_type)
    if impl is None:
        return None
    args = []
    for i in producer.inputs:
        if not i:
            args.append(None)
            continue
        v = _resolve_constant(g, i, _depth + 1, _producers, _memo)
        if v is None:
            return None
        args.append(v)
    try:
        out = host_call(impl, producer, *args)
    except Exception:
        return None
    if not isinstance(out, tuple):
        out = (out,)
    for o, v in zip(producer.outputs, out):
        _memo[o] = np.asarray(v)
    return _memo.get(name)


def _rename_in_subgraph(sub: Graph, rename: dict) -> Graph:
    """Copy of ``sub`` with CAPTURED outer-tensor references renamed."""
    shadowed = ({o for n in sub.nodes for o in n.outputs if o}
                | set(sub.initializers))
    eff = {k: v for k, v in rename.items() if k not in shadowed}
    out = copy.copy(sub)
    out.nodes = []
    for n in sub.nodes:
        n2 = copy.copy(n)
        n2.inputs = [eff.get(i, i) for i in n.inputs]
        if any(a.g is not None for a in n.attrs.values()):
            n2.attrs = {k: copy.copy(a) for k, a in n.attrs.items()}
            for a in n2.attrs.values():
                if a.g is not None:
                    a.g = _rename_in_subgraph(a.g, eff)
        out.nodes.append(n2)
    return out


def _clone_subgraph_nodes(nodes, rename: dict, prefix: str):
    """Copies of subgraph nodes with tensor references remapped, names
    prefixed, and nested subgraph attributes rename-fixed."""
    out = []
    for n2 in nodes:
        n3 = copy.copy(n2)
        n3.inputs = [rename.get(i, i) for i in n2.inputs]
        n3.outputs = [rename.get(o, o) for o in n2.outputs]
        n3.name = prefix + (n2.name or n2.op_type)
        if any(a.g is not None for a in n2.attrs.values()):
            n3.attrs = {k: copy.copy(a) for k, a in n2.attrs.items()}
            for a in n3.attrs.values():
                if a.g is not None:
                    a.g = _rename_in_subgraph(a.g, rename)
        out.append(n3)
    return out


def _inline_constant_ifs(g: Graph) -> bool:
    """Replace every If node whose condition is derivable from constants
    with its chosen branch, inlined (branch-internal tensors prefixed,
    branch outputs mapped positionally onto the If's outputs), to fixpoint.
    A data-dependent If stays in place and runs at call time."""
    any_change = False
    changed = True
    while changed:
        changed = False
        for idx, node in enumerate(list(g.nodes)):
            if node.op_type != "If":
                continue
            cond = _resolve_constant(g, node.inputs[0])
            if cond is None:
                continue
            branch = node.attr("then_branch" if bool(np.asarray(cond).ravel()
                                                     [0])
                               else "else_branch")
            if branch is None:
                continue
            prefix = (node.name or f"if_{idx}") + "/"
            if len(branch.outputs) != len(node.outputs):
                raise ValueError(
                    f"If node {node.name or idx!r}: chosen branch declares "
                    f"{len(branch.outputs)} outputs but the If node has "
                    f"{len(node.outputs)} — malformed model")
            # a branch output the branch neither produces nor initializes is
            # a passthrough of a captured outer tensor: bridge it with
            # Identity instead of renaming the outer tensor
            produced = {o for n2 in branch.nodes for o in n2.outputs if o}
            rename, bridges = {}, []
            for vi, out in zip(branch.outputs, node.outputs):
                if vi.name in produced or vi.name in branch.initializers:
                    rename[vi.name] = out
                else:
                    bridges.append(Node(op_type="Identity",
                                        inputs=[vi.name], outputs=[out],
                                        name=prefix + "passthrough"))
            internal = (produced | set(branch.initializers)) - set(rename)
            rename.update({t: prefix + t for t in internal})
            for t, tensor in branch.initializers.items():
                g.initializers[rename.get(t, t)] = tensor
            g.nodes[idx:idx + 1] = _clone_subgraph_nodes(
                branch.nodes, rename, prefix) + bridges
            changed = True
            any_change = True
            break            # indices shifted: restart the scan
    return any_change


def _unroll_constant_loops(g: Graph) -> bool:
    """Unroll Loop nodes whose trip count is a derivable constant and whose
    condition stays constant-true (scan outputs stack along a new axis 0 via
    Unsqueeze + Concat). Data-dependent loops stay in place."""
    any_change = False
    changed = True
    while changed:
        changed = False
        for idx, node in enumerate(list(g.nodes)):
            if node.op_type != "Loop":
                continue
            body = node.attr("body")
            if body is None:
                continue
            m_name = node.inputs[0] if node.inputs else ""
            cond_name = node.inputs[1] if len(node.inputs) > 1 else ""
            m_val = _resolve_constant(g, m_name) if m_name else None
            cond0 = (_resolve_constant(g, cond_name) if cond_name
                     else np.asarray(True))
            if m_val is None or cond0 is None or not bool(
                    np.asarray(cond0).ravel()[0]):
                continue
            trips = int(np.asarray(m_val).ravel()[0])
            n_carried = len(node.inputs) - 2
            n_scan = len(node.outputs) - n_carried
            body_in = [vi.name for vi in body.inputs]
            body_out = [vi.name for vi in body.outputs]
            # only unroll when the body's cond_out is the unchanged cond_in
            # (possibly through an Identity chain) or a constant-true
            src = body_out[0]
            body_producers = {o: n2 for n2 in body.nodes
                              for o in n2.outputs if o}
            for _ in range(16):
                p = body_producers.get(src)
                if p is not None and p.op_type == "Identity":
                    src = p.inputs[0]
                else:
                    break
            cond_out_const = _resolve_constant(body, body_out[0])
            if not (src == (body_in[1] if len(body_in) > 1 else None)
                    or (cond_out_const is not None
                        and bool(np.asarray(cond_out_const).ravel()[0]))):
                continue
            if trips > 256 or trips < 0:
                continue      # unrolling a huge loop would explode the graph
            if trips == 0 and n_scan > 0:
                continue      # empty scan stack has no static encoding here

            prefix0 = (node.name or f"loop_{idx}") + "/"
            new_nodes: List[Node] = []
            carried = list(node.inputs[2:])
            scan_parts: List[List[str]] = [[] for _ in range(n_scan)]
            produced = {o for n2 in body.nodes for o in n2.outputs if o}
            # body initializers are iteration-invariant: hoist ONCE. An
            # initializer that names a body INPUT is that input's default
            # value and must not shadow the bound outer tensor.
            init_rename = {t: prefix0 + t for t in body.initializers
                           if t not in body_in}
            for t, tensor in body.initializers.items():
                if t not in body_in:
                    g.initializers[init_rename[t]] = tensor
            for it in range(trips):
                pfx = f"{prefix0}it{it}/"
                rename = dict(init_rename)
                it_name = pfx + "iter"
                g.initializers[it_name] = Tensor.from_array(
                    it_name, np.asarray(it, np.int64))
                rename[body_in[0]] = it_name
                cd_name = pfx + "cond"
                g.initializers[cd_name] = Tensor.from_array(
                    cd_name, np.asarray(True))
                if len(body_in) > 1:
                    rename[body_in[1]] = cd_name
                for bi, cur in zip(body_in[2:], carried):
                    rename[bi] = cur
                internal = produced - set(rename)
                rename.update({t: pfx + t for t in internal})
                new_nodes.extend(_clone_subgraph_nodes(body.nodes, rename,
                                                       pfx))
                carried = [rename.get(o, o) for o in
                           body_out[1:1 + n_carried]]
                for s in range(n_scan):
                    src = rename.get(body_out[1 + n_carried + s],
                                     body_out[1 + n_carried + s])
                    un = pfx + f"scan{s}_unsq"
                    ax = pfx + f"scan{s}_axes"
                    g.initializers[ax] = Tensor.from_array(
                        ax, np.asarray([0], np.int64))
                    new_nodes.append(Node(op_type="Unsqueeze",
                                          inputs=[src, ax], outputs=[un],
                                          name=un))
                    scan_parts[s].append(un)
            for out_name, cur in zip(node.outputs[:n_carried], carried):
                new_nodes.append(Node(op_type="Identity", inputs=[cur],
                                      outputs=[out_name],
                                      name=prefix0 + "carry_out"))
            for s in range(n_scan):
                out_name = node.outputs[n_carried + s]
                cat = Node(op_type="Concat", inputs=scan_parts[s],
                           outputs=[out_name], name=prefix0 + f"scan{s}")
                cat.attrs["axis"] = Attribute(name="axis", type=2, i=0)
                new_nodes.append(cat)
            g.nodes[idx:idx + 1] = new_nodes
            changed = True
            any_change = True
            break
    return any_change


def import_model(model_bytes: bytes,
                 outputs: Optional[Sequence[str]] = None,
                 device=DEFAULT_DEVICE) -> OnnxFunction:
    return OnnxFunction(Model.parse(model_bytes), outputs, device=device)


def fold_constants(model: Model) -> Model:
    """Evaluate nodes with all-constant inputs once on the host, promoting
    results to initializers (keeps Reshape/Slice arguments host values)."""
    g = model.graph
    env = {k: t.array() for k, t in g.initializers.items()}
    keep: List[Node] = []
    for node in g.nodes:
        impl = REGISTRY.get(node.op_type)
        inputs_const = all((not i) or (i in env) for i in node.inputs)
        # Shape of a known-rank input is NOT constant in general (batch dim);
        # only fold Shape when the producer value is itself constant.
        if impl is not None and inputs_const and node.op_type != "Shape":
            try:
                out = host_call(impl, node,
                                *[env[i] if i else None for i in node.inputs])
            except Exception:
                keep.append(node)
                continue
            if not isinstance(out, tuple):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    env[name] = np.asarray(val)
                    t = Tensor.from_array(name, env[name])
                    # from_array's contiguous copy makes a 0-d value 1-d;
                    # a folded scalar keeps its rank (a Gather index must:
                    # the JAX package's fold scores torch's BERT fixture
                    # as (2, 1, 2) for it)
                    t.dims = list(env[name].shape)
                    g.initializers[name] = t
        else:
            keep.append(node)
    g.nodes = keep
    return model
