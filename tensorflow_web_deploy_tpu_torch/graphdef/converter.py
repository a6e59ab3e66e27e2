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
as in the reference.

**The stem's input-format rewrite** (the reference's ``S2DStem``). Where
the graph's image input feeds, through at most one static zero ``Pad``, a
stride-2 few-channel ``Conv2D`` (each link with a single consumer), the
converter records an :class:`S2DStem`: ``build(h, w)`` gives a variant of
the module whose first input is the preprocess's ``pack_s2d`` cells, the
absorbed ``Pad`` skipped and the stem conv computed by
``ops/stem.py::conv2d_s2d_input`` on a kernel rearranged once at build.
Every other stride-2 few-channel ``Conv2D`` takes the space-to-depth
rewrite on its own input (``ops/tf_ops.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import re
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import quant, stem, tf_ops
from ..ops.depthwise import resolve_pads
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
class S2DStem:
    """Input-format rewrite handle: the graph's image input feeds (through
    at most one static zero ``Pad``) a stride-2 few-channel ``Conv2D``.
    ``build(h, w)`` returns a copy of the converted module that takes the
    preprocess's ``pack_s2d`` cells [B, ⌈h/2⌉, ⌈w/2⌉, 4·cin] in place of
    NHWC images.

    ``base_pads`` come from the absorbed ``Pad``; the conv's own SAME/VALID
    padding is resolved against the serving (h, w), and the sum goes to
    ``ops.stem.conv2d_s2d_input`` as explicit pads (odd leading pads by a
    kernel shift there). ``cin`` is the conv's input channels: the port's
    engine hands cells only to a stem of the 3 channels its preprocess
    makes (the reference's detector takes any ``cin`` ≤ 4)."""

    conv_name: str
    skip_names: frozenset[str]
    base_pads: tuple[tuple[int, int], tuple[int, int]]
    conv_padding: str  # "SAME" / "VALID"
    kernel_hw: tuple[int, int]
    cin: int
    _builder: Any  # (explicit pads, (h, w)) -> the cells-consuming module

    def resolve_pads(self, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        (bt, bb), (bl, br) = self.base_pads
        if self.conv_padding == "VALID":
            (ct, cb), (cl, cr) = (0, 0), (0, 0)
        else:  # TF SAME on the padded extent: lax's rule
            (ct, cb), (cl, cr) = resolve_pads("SAME", (h + bt + bb, w + bl + br),
                                              self.kernel_hw, (2, 2))
        return (bt + ct, bb + cb), (bl + cl, br + cr)

    def supports(self, h: int, w: int) -> bool:
        """Is the even-extent cell convention exact at serving size (h, w)?
        Per axis: an even extent always; an odd extent needs an even total
        pad (then the implied extra zero row changes no output)."""
        (pt, pb), (pl, pr) = self.resolve_pads(h, w)
        return (h % 2 == 0 or (pt + pb) % 2 == 0) and (w % 2 == 0 or (pl + pr) % 2 == 0)

    def build(self, h: int, w: int) -> "ConvertedModel":
        if not self.supports(h, w):
            raise ValueError(f"s2d stem not exact at {(h, w)}")
        return self._builder(self.resolve_pads(h, w), (h, w))


def _detect_s2d_stem(compute_nodes, input_names, params, statics, builder) -> S2DStem | None:
    """Match [Placeholder] → (optional static zero Pad) → stride-2 small-C
    Conv2D (NHWC, undilated, odd kernel), each link single-consumer: the
    Keras/TF-Slim frozen-graph stem (Inception: a VALID conv on the input;
    MobileNet: ZeroPadding2D then a VALID conv). The reference's rule."""
    if len(input_names) != 1:
        return None

    def consumers_of(name):
        return [n for n in compute_nodes if n.op != "NoOp"
                and any(_ref_name(r) == (name, 0) for r in n.inputs if not r.startswith("^"))]

    cons = consumers_of(input_names[0])
    if len(cons) != 1:
        return None
    node = cons[0]
    base_pads = ((0, 0), (0, 0))
    skip: frozenset[str] = frozenset()
    if node.op == "Pad":
        pads_v = statics.get(_ref_name(node.inputs[1])[0])
        if not isinstance(pads_v, np.ndarray) or pads_v.shape != (4, 2):
            return None
        p = pads_v.astype(np.int64)
        if (p < 0).any() or p[0].any() or p[3].any():
            return None  # batch/channel padding: not a spatial stem pad
        base_pads = ((int(p[1, 0]), int(p[1, 1])), (int(p[2, 0]), int(p[2, 1])))
        nxt = consumers_of(node.name)
        if len(nxt) != 1:
            return None
        skip = frozenset({node.name})
        node = nxt[0]
    if node.op != "Conv2D":
        return None
    df = tf_ops._decode(node.attr("data_format"), "NHWC")
    if df != "NHWC":
        return None
    strides = tf_ops._hw(node.attr("strides"), df)
    dil = tf_ops._hw(node.attr("dilations", [1, 1, 1, 1]), df)
    padding = tf_ops._decode(node.attr("padding"), "VALID")
    if padding not in ("SAME", "VALID") or (padding == "SAME" and skip):
        return None  # Pad-then-SAME never occurs in the genre
    # the kernel may sit behind pass-through nodes (frozen Keras graphs wire
    # consts through ReadVariableOp/Identity)
    node_by_name = {n.name: n for n in compute_nodes}
    kname = _ref_name(node.inputs[1])[0]
    for _ in range(8):
        if kname in params or kname in statics:
            break
        nd = node_by_name.get(kname)
        if nd is None or nd.op not in ("Identity", "ReadVariableOp"):
            break
        kname = _ref_name(nd.inputs[0])[0]
    kernel = params.get(kname)
    if kernel is None:
        kernel = statics.get(kname)
    if not isinstance(kernel, np.ndarray) or kernel.ndim != 4:
        return None
    if not stem.worthwhile(kernel.shape[2], strides, kernel.shape[:2], dil):
        return None
    return S2DStem(conv_name=node.name, skip_names=skip, base_pads=base_pads,
                   conv_padding=padding, kernel_hw=(int(kernel.shape[0]), int(kernel.shape[1])),
                   cin=int(kernel.shape[2]), _builder=builder)


def _conv_cells(node, inputs, xp, pads):
    """The stem conv of a cells-consuming module: cells NHWC [B, ch, cw,
    4·cin], the OIHW kernel, and the rearranged kernel when it was made at
    build (a per-call kernel, the int8 tier's, is rearranged per call)."""
    x, w, *k = inputs
    y = stem.conv2d_s2d_input(x.permute(0, 3, 1, 2), w, pads, rearranged=k[0] if k else None)
    return y.permute(0, 2, 3, 1)


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
        s2d_stem: the stem's input-format rewrite handle (:class:`S2DStem`)
            when the graph's stem matches the pattern, else None.
        cells_input: with ``s2d_input=(h, w)`` the module takes the
            preprocess's cells at that serving size: True.
    """

    def __init__(self, graph: GraphDef, outputs: Sequence[str] | None = None,
                 inputs: Sequence[str] | None = None, dtype: torch.dtype = torch.float32,
                 int8: bool = False, params: dict[str, np.ndarray] | None = None,
                 s2d_input: tuple[int, int] | None = None):
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
        self.s2d_stem = _detect_s2d_stem(compute_nodes, self.input_names, self.params, statics,
                                         self._cells_variant)
        self.cells_input = False

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
        self._plan_releases()
        if s2d_input is not None:
            if self.s2d_stem is None or not self.s2d_stem.supports(*s2d_input):
                raise ValueError(f"the graph's stem cannot take cells at {tuple(s2d_input)}: "
                                 f"{self.s2d_stem}")
            self._read_cells(self.s2d_stem.resolve_pads(*s2d_input), s2d_input)

    def _plan_releases(self) -> None:
        """The per-call node list, and each value's last reader (which drops
        it after reading)."""
        self.call_nodes = [(s.node.name, s.node.op) for s in self._steps]
        last: dict[tuple[str, int], int] = {}
        for i, step in enumerate(self._steps):
            step.release = []
            for kind, ref in step.plan:
                if kind == "val":
                    last[ref] = i
        kept = {ref for kind, ref in self._outputs if kind == "val"}
        for ref, i in last.items():
            if ref not in kept:
                self._steps[i].release.append(ref)
        self._needed = frozenset(last) | kept

    def _read_cells(self, pads, hw: tuple[int, int]) -> None:
        """Turn this module into the cells-consuming variant at serving size
        ``hw``: the first input becomes cells, the absorbed ``Pad`` is
        skipped, and the stem conv reads the cells through
        ``conv2d_s2d_input`` with explicit ``pads``. A kernel made once (a
        buffer) is rearranged once, here."""
        st = self.s2d_stem
        cells = (self.input_names[0], 0)
        self._steps = [s for s in self._steps if s.node.name not in st.skip_names]
        for step in self._steps:
            if step.node.name != st.conv_name:
                continue
            kind, ref = step.plan[1]
            step.plan = [("val", cells), (kind, ref)]
            if kind == "buf":
                key = ref + "__s2d"
                self.register_buffer(key, stem.s2d_input_kernel(self._buffers[ref], pads)
                                     .contiguous())
                self.buffer_origin[key] = (self.buffer_origin[ref][0], "s2d")
                step.plan.append(("buf", key))
            step.handler = tf_ops.OpHandler(functools.partial(_conv_cells, pads=pads))
        self._plan_releases()
        h, w = hw
        self.input_specs[0] = dataclasses.replace(
            self.input_specs[0], shape=[None, (h + 1) // 2, (w + 1) // 2, 4 * st.cin])
        self.cells_input = True

    def _cells_variant(self, pads, hw: tuple[int, int]) -> "ConvertedModel":
        """:meth:`S2DStem.build`: a copy of this module reading cells."""
        model = copy.deepcopy(self)
        model._read_cells(pads, hw)
        return model

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
                     int8: bool = False, params: dict[str, np.ndarray] | None = None,
                     s2d_input: tuple[int, int] | None = None) -> ConvertedModel:
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
        s2d_input: the serving (h, w) at which the module takes the
            preprocess's cells (:class:`S2DStem`); a graph whose stem
            cannot is refused.
    """
    return ConvertedModel(graph, outputs=outputs, inputs=inputs, dtype=dtype, int8=int8,
                          params=params, s2d_input=s2d_input).eval().requires_grad_(False)


def convert_pb(path: str, outputs: Sequence[str] | None = None,
               inputs: Sequence[str] | None = None, dtype: torch.dtype = torch.float32,
               int8: bool = False) -> ConvertedModel:
    """``load_graph()`` equivalent: frozen ``.pb`` file → :class:`ConvertedModel`."""
    return convert_graphdef(load_pb(path), outputs=outputs, inputs=inputs, dtype=dtype,
                            int8=int8)
