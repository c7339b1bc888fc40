"""Program IR: Program / Block / Operator / Variable / Parameter.

The port's own copy of ``paddle_tpu/core/framework.py`` (pure Python and
numpy), kept line for line where it can be so that a program built by
the port has the same ops, var names, shapes, attrs and JSON as the one
the JAX package builds. What differs: no dygraph bridge, and the
Variable operator sugar covers only the ops the port lowers
(elementwise add/sub/mul/div and scale).

This is the declarative graph the user builds, equivalent in role to
Fluid's ProgramDesc protobuf and its Python wrappers. The Executor
(``core/executor.py``) runs it op by op through ``core/registry.py``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------
# dtype handling: we use numpy dtype names as the canonical representation.
# Reference framework.proto VarType.Type enum -> plain strings here.
# --------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float64": "float64",
    "fp64": "float64",
    "float16": "float16",
    "fp16": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    # fp8: the quantized-inference weight dtype (e4m3 weights)
    "float8_e4m3fn": "float8_e4m3fn",
    "fp8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "bool": "bool",
}


def convert_dtype(dtype) -> str:
    """Normalize any dtype spec (str, np.dtype, torch.dtype) to a string.

    Unknown specs raise one consistent ``ValueError`` naming the
    offending object — np.dtype() raises a mix of TypeError/ValueError
    with messages that don't mention the spec (bfloat16-like extension
    types were the worst offenders), so every failure path funnels
    through the same error here.
    """
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    if str(dtype).startswith("torch."):   # torch.float32 -> "float32"
        return convert_dtype(str(dtype)[len("torch."):])
    name = getattr(dtype, "name", None)  # np.dtype
    if isinstance(name, str) and name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    try:
        resolved = np.dtype(dtype)
    except (TypeError, ValueError):
        raise ValueError(f"unsupported dtype: {dtype!r}") from None
    if resolved.kind in ("O", "U", "S", "V", "M", "m"):
        raise ValueError(
            f"unsupported dtype: {dtype!r} (resolves to np.{resolved.name}, "
            "which has no tensor mapping)")
    return _DTYPE_ALIASES.get(resolved.name, resolved.name)


# --------------------------------------------------------------------------
# unique_name — reference python/paddle/fluid/unique_name.py
# --------------------------------------------------------------------------


class _UniqueNameGenerator:
    def __init__(self):
        self.ids = collections.defaultdict(int)
        self.prefix = ""
        self._lock = threading.Lock()

    def __call__(self, key: str) -> str:
        with self._lock:
            tmp = self.ids[key]
            self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


class _UniqueNameModule:
    """Callable module-like object: unique_name("fc") and
    unique_name.generate("fc") both work (reference has a submodule)."""

    def __init__(self):
        self._generator = _UniqueNameGenerator()

    def generate(self, key: str) -> str:
        return self._generator(key)

    def __call__(self, key: str) -> str:
        return self._generator(key)

    @contextlib.contextmanager
    def guard(self, new_prefix: str = ""):
        old = self._generator
        self._generator = _UniqueNameGenerator()
        self._generator.prefix = new_prefix
        try:
            yield
        finally:
            self._generator = old

    def switch(self, new_generator=None):
        """Reference unique_name.switch: swap the live generator,
        returning the previous one (callers restore it themselves)."""
        old = self._generator
        self._generator = new_generator or _UniqueNameGenerator()
        return old


unique_name = _UniqueNameModule()


_name_scope_stack: List[str] = []


@contextlib.contextmanager
def name_scope(prefix: str):
    """Name scoping for debugging / profiler grouping (reference
    framework.py name_scope); ops record it in their ``name_scope``
    attr."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def _current_name_scope() -> str:
    return "/".join(_name_scope_stack)


# --------------------------------------------------------------------------
# Variable — reference framework.py:806 (class Variable), VarDesc proto :164
# --------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block.

    shape uses -1 for dynamic dims (batch). ``persistable`` vars live in
    the Scope across executor runs (parameters, optimizer state);
    non-persistables are pure SSA values inside the compiled function.
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype="float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        lod_level: int = 0,
        trainable: bool = True,
        type: str = "lod_tensor",
        initializer=None,
        error_clip=None,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.trainable = trainable
        self.type = type
        self.initializer = initializer
        self.error_clip = error_clip
        # Optional sharding annotation (PartitionSpec-like tuple of
        # axis-name-or-None per dim) consumed by the distributed executor.
        self.sharding: Optional[tuple] = None
        # Optional LOGICAL axis names per dim ("batch", "embed",
        # "heads", ...) — what the dims MEAN, not where they live; the
        # partition subsystem's rules table resolves these to mesh axes
        # per compile (partition/rules.py), so one tagged model serves
        # every mesh shape. Stamped via ParamAttr(logical_axes=...).
        self.logical_axes: Optional[tuple] = None

    # -- reference-API surface ------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, "
            f"dtype={self.dtype}, persistable={self.persistable})"
        )

    __str__ = __repr__

    # Operator sugar so graph code reads like numpy. Each emits ops into
    # the variable's block (reference monkey-patches these in
    # python/paddle/fluid/layers/math_op_patch.py).
    def _binary(self, other, op, reverse=False):
        from .. import layers

        return layers._elementwise_binary(self, other, op, reverse=reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from .. import layers

        return layers.scale(self, scale=-1.0)

    # -- serialization --------------------------------------------------------
    # structural tags that must survive serialization: sharding specs
    # and accumulator/MoE ownership drive re-sharding of a LOADED
    # program (with_expert_parallel, shard_optimizer_states) — losing
    # them would make a deserialized program silently unshardable
    _SERIALIZED_TAGS = ("sharding", "logical_axes", "is_accumulator",
                        "accumulator_owner", "_moe_expert_param")

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "lod_level": self.lod_level,
            "trainable": self.trainable,
            "type": self.type,
        }
        tags = {}
        for t in self._SERIALIZED_TAGS:
            v = getattr(self, t, None)
            if v is not None and v is not False:
                tags[t] = list(v) if isinstance(v, tuple) else v
        if tags:
            d["tags"] = tags
        return d


class Parameter(Variable):
    """A trainable persistable variable (reference framework.py:4631)."""

    def __init__(self, block, name, shape, dtype="float32", **kwargs):
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("trainable", True)
        super().__init__(block, name, shape, dtype, **kwargs)


# --------------------------------------------------------------------------
# Operator — reference framework.py:1706, OpDesc proto framework.proto:42
# --------------------------------------------------------------------------

# op_role marking (reference framework.py OpRole + op_proto_maker.h): lets
# passes/optimizers identify forward vs backward vs optimize ops.
class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


class Operator:
    """One node: type + named input/output slots (each a list of var
    names) + attrs. Lowering is resolved from the registry at executor
    compile time, not stored here."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.attrs.setdefault("op_role", OpRole.Forward)
        # stable identity for deterministic per-op RNG derivation; grad
        # ops copy their forward op's ident (see registry.LoweringContext).
        # Per-PROGRAM counter so two identical program builds derive
        # identical init randomness (loss-parity tests rely on this).
        if "op_ident" not in self.attrs:
            self.attrs["op_ident"] = block.program._next_op_ident()
        if _current_name_scope():
            self.attrs.setdefault("name_scope", _current_name_scope())

        def _canon(slots):
            out = {}
            for slot, vs in (slots or {}).items():
                if vs is None:
                    out[slot] = []
                    continue
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[slot] = [v.name if isinstance(v, Variable) else str(v) for v in vs]
            return out

        self.inputs = _canon(inputs)
        self.outputs = _canon(outputs)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def all_attrs(self):
        return dict(self.attrs)

    def attr(self, name):
        return self.attrs.get(name)

    def _set_attr(self, name, val):
        self.attrs[name] = val

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs})}}"

    def to_dict(self) -> Dict[str, Any]:
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            elif isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            else:
                attrs[k] = v
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": attrs,
        }


# --------------------------------------------------------------------------
# Block / Program — reference framework.py:2176 (Block), :3602 (Program)
# --------------------------------------------------------------------------


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = collections.OrderedDict()
        self.ops: List[Operator] = []

    # -- vars -----------------------------------------------------------------
    def create_var(self, name: Optional[str] = None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype="float32", **kwargs) -> Parameter:
        existing = self.program.global_block().vars.get(name)
        if isinstance(existing, Parameter):
            if tuple(existing.shape or ()) != tuple(shape or ()):
                raise ValueError(
                    f"parameter {name!r} already exists with shape "
                    f"{existing.shape}, requested {tuple(shape)} — explicit "
                    "param names shared across layers must agree on shape "
                    "(an fc over a LIST of inputs needs per-input names or "
                    "a pre-concat)"
                )
            return existing  # weight sharing
        param = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[name] = param
        # Parameters are global: also visible from block 0.
        gb = self.program.global_block()
        if gb is not self:
            gb.vars[name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block()
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- ops ------------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        return op

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, parent={self.parent_idx})"]
        for v in self.vars.values():
            lines.append(f"  {v}")
        for op in self.ops:
            lines.append(f"  {op}")
        return "\n".join(lines)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """An ordered list of blocks; block 0 is the global block.

    ``version`` increments on every mutation so the executor's
    compilation cache can key on (program, version).
    """

    _uid_counter = itertools.count(1)

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.version = 0
        self.random_seed = 0
        self._seed_counter = 0
        self._op_ident_counter = 0
        # unique serial for executor cache keys (id() is reused by the
        # allocator after GC, which could serve a stale executable)
        self.uid = next(Program._uid_counter)
        # populated by append_backward / optimizers for introspection
        self._op_role_var: List[str] = []

    def _next_op_ident(self) -> int:
        self._op_ident_counter += 1
        return self._op_ident_counter

    # -- blocks ---------------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def num_blocks(self) -> int:
        return len(self.blocks)

    # -- mutation tracking ----------------------------------------------------
    def _bump(self):
        self.version += 1

    # -- reference API --------------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy. for_test=True marks the clone as inference-mode:
        ops with an is_test attr get it set (dropout/batch_norm change
        behavior), matching reference Program.clone(for_test=True)."""
        p = copy.deepcopy(self)
        p.uid = next(Program._uid_counter)
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if op.type in _IS_TEST_OPS or "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        p._bump()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    def to_dict(self):
        return {
            "version": self.version,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            p.blocks.append(blk)
        for bd, blk in zip(d["blocks"], p.blocks):
            for vd in bd["vars"]:
                vd = dict(vd)
                name = vd.pop("name")
                trainable = vd.pop("trainable", True)
                tags = vd.pop("tags", None)
                if trainable and vd.get("persistable"):
                    shape = vd.pop("shape")
                    dtype = vd.pop("dtype")
                    vd.pop("is_data", None)
                    vd.pop("type", None)
                    nv = blk.create_parameter(name, shape, dtype, **vd)
                else:
                    nv = blk.create_var(name, **vd)
                for t, val in (tags or {}).items():
                    if t == "sharding":
                        # entries may themselves be joint-axis tuples
                        val = tuple(tuple(e) if isinstance(e, list) else e
                                    for e in val)
                    elif t == "logical_axes":
                        val = tuple(val)
                    setattr(nv, t, val)
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    elif isinstance(v, dict) and "__block__" in v:
                        attrs[k] = ("__block__", v["__block__"])
                    else:
                        attrs[k] = v
                op = Operator(blk, od["type"], attrs=attrs)
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                blk.ops.append(op)
        # resolve block-ref attrs
        max_ident = 0
        for blk in p.blocks:
            for op in blk.ops:
                for k, v in op.attrs.items():
                    if isinstance(v, tuple) and len(v) == 2 and v[0] == "__block__":
                        op.attrs[k] = p.blocks[v[1]]
                max_ident = max(max_ident, int(op.attrs.get("op_ident", 0)))
        p._op_ident_counter = max_ident
        return p

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))


# op types whose behavior flips in inference mode (reference
# framework.py clone(for_test) targets ops carrying an is_test attr)
_IS_TEST_OPS = {"dropout", "batch_norm", "sync_batch_norm", "instance_norm"}


# --------------------------------------------------------------------------
# default programs + guards — reference framework.py:4879
# --------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
