"""Frozen ``GraphDef`` → ``torch.nn.Module`` (counterpart of the JAX
package's ``graphdef/converter.py``).

The original project's ``load_graph()`` deserializes a frozen ``.pb`` and
defers execution to the TF1 runtime. Here the graph is pruned to the
requested outputs, topologically ordered, and evaluated node by node over
the op table (:mod:`..ops.tf_ops`) inside :class:`ConvertedModel`'s
``forward``; the serving engine captures that forward as one CUDA graph
per (canvas, batch) bucket.

As in the reference, every float ``Const`` of at least ``_PARAM_MIN_SIZE``
elements is a parameter (``ConvertedModel.params``, numpy by node name)
and the rest are statics; integer consts stay numpy, so shape arithmetic
(``Shape → StridedSlice → Pack → Reshape``) is host arithmetic and every
tensor op has a static shape.

What the port adds, all at build:

- **The compute dtype.** Float parameters and float statics are cast to
  it (the reference's ``float_dtype`` policy: a float32 constant must not
  promote a bf16 network back to float32).
- **Const-only subgraphs fold.** Every node whose inputs are all constants
  or parameters is evaluated once, at build, in the compute dtype — the
  Keras BN chains (``Reshape``, ``AddV2``, ``Rsqrt``, ``Sub``, ``Mul`` on the
  moving statistics) and the ``ReadVariableOp`` identities. The per-call
  node list (``call_nodes``) holds only the ops that depend on the data.
  Nothing that reads an int8 leaf folds: the int8 tier's kernels stay int8
  and are dequantized on every call, as in the reference.
- **Device buffers.** Each constant a per-call tensor op reads is a buffer
  of the module (under a mangled key: TF names hold ``/`` and ``.``;
  ``buffer_origin`` maps each back to its node), made once in the port's
  layout (a conv kernel OIHW). ``forward`` builds no tensor from host data
  and reads nothing back, so a CUDA graph captures it.

Handlers are resolved eagerly, so an unsupported op fails at conversion,
as in the reference. The reference's space-to-depth stem rewrite is not
ported: cuDNN takes the plain stride-2 stem.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import quant, tf_ops
from .proto import DT_FLOAT, GraphDef, NodeDef, load_pb, np_dtype

# Float consts at least this many elements become params; smaller consts
# (eps scalars, norm means) stay statics — the reference's split.
_PARAM_MIN_SIZE = 64

_INPUT_OPS = ("Placeholder", "PlaceholderWithDefault")
_SHAPE_OPS = ("Shape", "Size", "Rank")


def _ref_name(ref: str) -> tuple[str, int]:
    """Split an input ref ``"node:2"`` → ``("node", 2)``."""
    if ":" in ref:
        name, idx = ref.rsplit(":", 1)
        return name, int(idx)
    return ref, 0


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool, bytes, list))


@dataclasses.dataclass
class InputSpec:
    name: str
    shape: list[int] | None
    dtype: np.dtype


def _topo_order(graph: GraphDef, output_nodes: Sequence[str]) -> list[NodeDef]:
    """Iterative DFS topological sort of the ancestors of ``output_nodes``
    (iterative: Inception-scale graphs are hundreds of nodes deep)."""
    node_map = graph.node_map
    order: list[NodeDef] = []
    state: dict[str, int] = {}  # 0 = visiting, 1 = done
    for root in output_nodes:
        if root in state and state[root] == 1:
            continue
        stack: list[tuple[str, bool]] = [(root, False)]
        while stack:
            name, expanded = stack.pop()
            if expanded:
                state[name] = 1
                order.append(node_map[name])
                continue
            if state.get(name) == 1:
                continue
            if state.get(name) == 0:
                raise ValueError(f"cycle in graph at node '{name}'")
            if name not in node_map:
                raise KeyError(f"graph references unknown node '{name}'")
            state[name] = 0
            stack.append((name, True))
            for ref in node_map[name].inputs:
                if ref.startswith("^"):
                    continue  # control dependency — no data flow
                dep, _ = _ref_name(ref)
                if state.get(dep) != 1:
                    stack.append((dep, False))
    return order


def _infer_outputs(graph: GraphDef) -> list[str]:
    """Default outputs: non-trivial nodes nothing else consumes."""
    consumed: set[str] = set()
    for n in graph.nodes:
        for ref in n.inputs:
            consumed.add(_ref_name(ref.lstrip("^"))[0])
    # Identity is a legitimate sink — the standard freeze pattern names the
    # model output via a trailing Identity node.
    skip = {"Const", "NoOp", "Assert"} | set(_INPUT_OPS)
    return [n.name for n in graph.nodes if n.name not in consumed and n.op not in skip]


def _mangle(name: str) -> str:
    return "c_" + re.sub(r"[^0-9A-Za-z_]", "_", name)


def to_port_layout(layout: str, w: torch.Tensor) -> torch.Tensor:
    """A constant in the TF layout → the port's, by ``buffer_origin``'s
    layout name ("" keeps it)."""
    return tf_ops.LAYOUTS[layout](w).contiguous() if layout else w


@dataclasses.dataclass
class _Step:
    """One per-call node: its handler and where each input comes from —
    ("val", (name, i)) a value of this call, ("buf", key) a module buffer,
    ("np", value) a host constant — and the layouts (``tf_ops.LAYOUTS``)
    to apply per call."""

    node: NodeDef
    handler: tf_ops.OpHandler
    plan: list[tuple[str, Any]]
    prepare: dict[int, str]
    # values whose last reader this step is: dropped after it, so that a
    # forward holds only the live activations (a CUDA graph's pool is sized
    # by what a capture keeps alive at once)
    release: list[tuple[str, int]] = dataclasses.field(default_factory=list)


class ConvertedModel(nn.Module):
    """A converted graph: ``model(*inputs)`` → tuple of outputs.

    Attributes:
        params: numpy weights by const node name (float32 as in the graph;
            int8 ``q`` + ``!qscale`` siblings for the int8 tier).
        input_specs: placeholder name/shape/dtype, in call order.
        output_names: tensor refs produced, e.g. ``["logits", "boxes:0"]``.
        dtype: the compute dtype.
        call_nodes: (name, op) of the nodes evaluated per call.
        folded_nodes: names of the const-only nodes evaluated at build.
        buffer_origin: buffer key → (node name, layout) of the value.
        int8_params: names of the int8-quantized parameters.
    """

    def __init__(self, graph: GraphDef, outputs: Sequence[str] | None = None,
                 inputs: Sequence[str] | None = None, dtype: torch.dtype = torch.float32,
                 int8: bool = False, params: dict[str, np.ndarray] | None = None):
        super().__init__()
        self.dtype = dtype
        self.output_names = list(outputs or _infer_outputs(graph))
        order = _topo_order(graph, [_ref_name(r)[0] for r in self.output_names])

        self.params: dict[str, np.ndarray] = {}
        statics: dict[str, Any] = {}
        placeholders: list[NodeDef] = []
        for node in order:
            if node.op == "Const":
                value = node.attr("value")
                if (isinstance(value, np.ndarray) and value.dtype.kind == "f"
                        and value.size >= _PARAM_MIN_SIZE):
                    self.params[node.name] = value
                else:
                    statics[node.name] = value
            elif node.op in _INPUT_OPS:
                placeholders.append(node)
        if params is not None:  # carried across by node name (e.g. the reference's)
            for name, v in params.items():
                if name not in self.params or np.shape(v) != self.params[name].shape:
                    raise ValueError(f"param {name!r}: not a parameter of this graph with "
                                     f"shape {np.shape(v)}")
                self.params[name] = np.asarray(v)
        if inputs is not None:
            by_name = {p.name: p for p in placeholders}
            placeholders = [by_name[n] for n in inputs]
        self.input_specs = [
            InputSpec(name=p.name, shape=p.attr("shape"),
                      dtype=np_dtype(p.attr("dtype", DT_FLOAT)))
            for p in placeholders
        ]
        self.input_names = [p.name for p in placeholders]
        inputs_set = set(self.input_names)
        compute_nodes = [n for n in order if n.op != "Const" and n.name not in inputs_set]
        # Resolve handlers eagerly so unsupported ops fail at convert time,
        # not on the first request.
        handlers = {n.name: tf_ops.get_handler(n.op) for n in compute_nodes if n.op != "NoOp"}

        # the compute-dtype cast: the reference casts float32 params (int8:
        # the quantized tree) and, under a non-float32 policy, float statics
        if int8:
            self.params = quant.quantize_params(self.params)
        self.int8_params = [k for k in self.params if k + quant.QSCALE_SUFFIX in self.params]
        cast_statics = dtype != torch.float32
        values: dict[tuple[str, int], Any] = {}
        kinds: dict[str, str] = {}  # node → "const" | "shape" (host, per call) | "data"
        origin: dict[int, str] = {}  # id(value) → the node it came from
        for name, v in statics.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                v = tf_ops.as_tensor(v)
                if cast_statics:
                    v = v.to(dtype)
            values[(name, 0)] = v
            kinds[name] = "const"
        for name, v in self.params.items():
            if name.endswith(quant.QSCALE_SUFFIX) or name in self.int8_params:
                continue
            t = tf_ops.as_tensor(v)
            values[(name, 0)] = t.to(dtype) if v.dtype == np.float32 else t
            kinds[name] = "const"
        for name in self.int8_params:
            kinds[name] = "data"  # dequantized on every call
        for name in self.input_names:
            kinds[name] = "data"
        for (name, _), v in values.items():
            origin.setdefault(id(v), name)

        # Fold the const-only subgraphs; classify the rest.
        self.folded_nodes: list[str] = []
        self._steps: list[_Step] = []
        self.buffer_origin: dict[str, tuple[str, str]] = {}
        # (id of a value — kept alive by ``values`` during the build —,
        # layout) → its buffer
        buffer_of: dict[tuple[int, str], str] = {}

        def buffer_for(v, layout: str, node_name: str) -> str:
            key = (id(v), layout)
            if key not in buffer_of:
                src = origin.get(id(v), node_name)
                name = _mangle(src) + (f"__{layout}" if layout else "")
                while name in self._buffers:
                    name += "_"
                self.register_buffer(name, to_port_layout(layout, tf_ops.as_tensor(v))
                                     .contiguous())
                self.buffer_origin[name] = (src, layout)
                buffer_of[key] = name
            return buffer_of[key]

        for node in compute_nodes:
            if node.op == "NoOp":
                continue
            refs = [_ref_name(r) for r in node.inputs if not r.startswith("^")]
            handler = handlers[node.name]
            in_kinds = [kinds[n] for n, _ in refs]
            if all(k == "const" for k in in_kinds):
                ins = [values[r] for r in refs]
                use_np = handler.static_ok and all(_is_static(v) for v in ins)
                out = handler.fn(node, ins, np if use_np else torch)
                outs = out if isinstance(out, tuple) else (out,)
                for i, o in enumerate(outs):
                    values[(node.name, i)] = o
                    # an identity keeps its input's origin (a kernel behind
                    # its ReadVariableOp)
                    if id(o) not in origin:
                        origin[id(o)] = node.name
                kinds[node.name] = "const"
                self.folded_nodes.append(node.name)
                continue
            if node.op in _SHAPE_OPS or (handler.static_ok and all(
                    k in ("const", "shape") for k in in_kinds)):
                kinds[node.name] = "shape"
            else:
                kinds[node.name] = "data"
            plan: list[tuple[str, Any]] = []
            per_call_prepare: dict[int, str] = {}
            for pos, ((name, idx), kind) in enumerate(zip(refs, in_kinds)):
                layout = handler.prepare.get(pos, "")
                if kind != "const":
                    plan.append(("val", (name, idx)))
                    if layout:
                        per_call_prepare[pos] = layout
                    continue
                v = values[(name, idx)]
                if (kinds[node.name] == "shape" or node.op in _SHAPE_OPS
                        or handler.is_static_arg(pos, len(refs))):
                    plan.append(("np", tf_ops._np(v) if isinstance(v, torch.Tensor) else v))
                elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
                    plan.append(("buf", buffer_for(v, layout, node.name)))
                else:
                    plan.append(("np", v))
            self._steps.append(_Step(node, handler, plan, per_call_prepare))

        self._int8 = {}
        for name in self.int8_params:
            q = tf_ops.as_tensor(self.params[name])
            scale = tf_ops.as_tensor(self.params[name + quant.QSCALE_SUFFIX]).to(dtype)
            qkey, skey = _mangle(name) + "__q", _mangle(name) + "__qscale"
            self.register_buffer(qkey, q)
            self.register_buffer(skey, scale)
            self.buffer_origin[qkey] = (name, "int8")
            self.buffer_origin[skey] = (name + quant.QSCALE_SUFFIX, "")
            self._int8[name] = (qkey, skey)
        self._outputs: list[tuple[str, Any]] = []
        for r in self.output_names:
            name, idx = _ref_name(r)
            if kinds[name] == "const":
                v = values[(name, idx)]
                self._outputs.append(("buf", buffer_for(v, "", name)))
            else:
                self._outputs.append(("val", (name, idx)))
        self.call_nodes = [(s.node.name, s.node.op) for s in self._steps]
        last: dict[tuple[str, int], int] = {}
        for i, step in enumerate(self._steps):
            for kind, ref in step.plan:
                if kind == "val":
                    last[ref] = i
        kept = {ref for kind, ref in self._outputs if kind == "val"}
        for ref, i in last.items():
            if ref not in kept:
                self._steps[i].release.append(ref)
        self._needed = frozenset(last) | kept

    def forward(self, *args):
        if len(args) != len(self.input_names):
            raise TypeError(f"expected {len(self.input_names)} inputs {self.input_names}, "
                            f"got {len(args)}")
        bufs = self._buffers
        values: dict[tuple[str, int], Any] = {(n, 0): a for n, a in zip(self.input_names, args)}
        for name, (qkey, skey) in self._int8.items():
            # the JAX layout's output channel is the last axis
            values[(name, 0)] = bufs[qkey] * bufs[skey]
        for step in self._steps:
            ins = []
            for pos, (kind, ref) in enumerate(step.plan):
                if kind == "val":
                    layout = step.prepare.get(pos)
                    ins.append(values[ref] if layout is None
                               else tf_ops.LAYOUTS[layout](values[ref]))
                elif kind == "buf":
                    ins.append(bufs[ref])
                else:
                    ins.append(ref)
            use_np = step.handler.static_ok and all(_is_static(v) for v in ins)
            out = step.handler.fn(step.node, ins, np if use_np else torch)
            for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
                if (step.node.name, i) in self._needed:
                    values[(step.node.name, i)] = o
            del ins, out
            for ref in step.release:
                del values[ref]
        return tuple(bufs[ref] if kind == "buf" else tf_ops.as_tensor(values[ref])
                     for kind, ref in self._outputs)


def convert_graphdef(graph: GraphDef, outputs: Sequence[str] | None = None,
                     inputs: Sequence[str] | None = None, dtype: torch.dtype = torch.float32,
                     int8: bool = False,
                     params: dict[str, np.ndarray] | None = None) -> ConvertedModel:
    """Convert a parsed ``GraphDef`` into a :class:`ConvertedModel` on the
    CPU in ``dtype`` (the caller moves it).

    Args:
        graph: parsed graph (:func:`..graphdef.proto.parse_graphdef`).
        outputs: tensor refs to produce (``"name"`` or ``"name:idx"``); if
            omitted, inferred as the graph's sink nodes.
        inputs: placeholder order override; defaults to graph order.
        dtype: the compute dtype (float params and statics cast to it).
        int8: quantize the reference's eligible kernels (``ops/quant.py``).
        params: weights by node name to use instead of the graph's own.
    """
    return ConvertedModel(graph, outputs=outputs, inputs=inputs, dtype=dtype, int8=int8,
                          params=params).eval().requires_grad_(False)


def convert_pb(path: str, outputs: Sequence[str] | None = None,
               inputs: Sequence[str] | None = None, dtype: torch.dtype = torch.float32,
               int8: bool = False) -> ConvertedModel:
    """``load_graph()`` equivalent: frozen ``.pb`` file → :class:`ConvertedModel`."""
    return convert_graphdef(load_pb(path), outputs=outputs, inputs=inputs, dtype=dtype,
                            int8=int8)
