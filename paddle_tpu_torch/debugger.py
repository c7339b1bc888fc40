"""Program pretty-printer and graph export: the port's copy of
``paddle_tpu/debugger.py`` (reference python/paddle/fluid/debugger.py,
``pprint_program_codes`` and ``draw_block_graphviz`` through
net_drawer/graphviz.py). Both give the JAX package's text for the same
Program."""

from __future__ import annotations

from typing import Optional

from .core.framework import Program

__all__ = ["pprint_program", "draw_block_graphviz"]


def pprint_program(program: Program, file=None) -> str:
    """Human-readable program dump (one op per line, vars with shapes)."""
    lines = []
    for blk in program.blocks:
        lines.append(f"// block {blk.idx} (parent {blk.parent_idx})")
        for v in blk.vars.values():
            tag = "param" if getattr(v, "trainable", False) and v.persistable else (
                "persist" if v.persistable else ("data" if v.is_data else "tmp")
            )
            lines.append(f"  var {v.name}: {v.dtype}{list(v.shape) if v.shape else '?'} [{tag}]")
        for op in blk.ops:
            ins = ", ".join(
                f"{slot}={names}" for slot, names in op.inputs.items() if names
            )
            outs = ", ".join(
                f"{slot}={names}" for slot, names in op.outputs.items() if names
            )
            attrs = {
                k: v for k, v in op.attrs.items()
                if k not in ("op_ident", "op_role", "name_scope") and not hasattr(v, "ops")
            }
            lines.append(f"  {op.type}({ins}) -> {outs}  {attrs if attrs else ''}")
    text = "\n".join(lines)
    if file:
        print(text, file=file)
    return text


def draw_block_graphviz(block, path: Optional[str] = None, highlights=None) -> str:
    """A graphviz dot of the op / var graph (reference
    ``draw_block_graphviz``). Returns the dot source and writes it when
    ``path`` is given (render with ``dot -Tpng``)."""
    lines = ["digraph G {", "  rankdir=TB;", '  node [fontsize=10];']
    hi = set(highlights or [])
    var_ids: dict = {}

    def vid(name):
        # stable sequential ids: hash() is randomised per process and
        # can collide, merging distinct vars in the graph
        if name not in var_ids:
            var_ids[name] = f"var{len(var_ids)}"
        return var_ids[name]

    for i, op in enumerate(block.ops):
        color = "lightblue" if op.type.endswith("_grad") else "lightgrey"
        lines.append(
            f'  op{i} [label="{op.type}", shape=box, style=filled, fillcolor={color}];'
        )
        for names in op.inputs.values():
            for n in names:
                shape_color = "red" if n in hi else "white"
                lines.append(
                    f'  {vid(n)} [label="{n}", shape=ellipse, style=filled, fillcolor={shape_color}];'
                )
                lines.append(f"  {vid(n)} -> op{i};")
        for names in op.outputs.values():
            for n in names:
                lines.append(f'  {vid(n)} [label="{n}", shape=ellipse];')
                lines.append(f"  op{i} -> {vid(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
