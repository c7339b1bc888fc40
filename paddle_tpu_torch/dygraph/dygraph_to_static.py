"""dygraph_to_static: the AST transform of Python control flow.

The port's copy of ``paddle_tpu/dygraph/dygraph_to_static.py``
(reference python/paddle/fluid/dygraph/dygraph_to_static/: the
IfElse / loop / return transformers rewrite a dygraph function's
source; cache_program.py caches the converted function). The
transformer (if, while, for, break, continue, return and the bool ops,
JAX's :332-965) comes over unchanged in logic.

The runtime helpers (the namespace the rewritten code calls, bound as
``_pt_jst`` where JAX binds ``_jst``) take torch tensors and VarBases. The port has no tracer, so every
predicate is concrete and is read on the host, as JAX's eager branch
does: the converted function runs the original Python branch and loop.
JAX's traced paths (``lax.cond`` / ``lax.while_loop`` under ``jax.jit``)
have no counterpart. A converted function captured into a CUDA graph
(``jit.to_static``) whose predicate is a device tensor fails the
capture, as a concrete Python ``if`` over a tracer fails ``jax.jit``.
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap

import numpy as np
import torch


# -- runtime helpers (the `_jst` namespace the rewritten code calls) --------


def _unwrap(v):
    from .base import VarBase

    return v.value if isinstance(v, VarBase) else v


def _host_bool(v) -> bool:
    v = _unwrap(v)
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(()).item())
    if hasattr(v, "reshape") or hasattr(v, "__array__"):
        return bool(np.asarray(v).reshape(()))
    return bool(v)


def _host_int(v) -> int:
    v = _unwrap(v)
    if isinstance(v, torch.Tensor):
        return int(v.reshape(()).item())
    return int(np.asarray(v).reshape(()))


class _Undef:
    """Placeholder for names not yet bound before a converted block.
    Use-site traps make it behave like an unbound name: mere presence
    in a carry is fine (an if-without-else that assigns a new name is
    legal python when the branch is untaken), USING it raises."""

    def __repr__(self):
        return "<to_static undefined>"

    def _raise(self, *a, **k):
        raise NameError(
            "to_static: variable was only assigned in an untaken branch"
        )

    __bool__ = __call__ = __getattr__ = __add__ = __radd__ = _raise
    __sub__ = __mul__ = __truediv__ = __iter__ = __array__ = _raise
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _raise
    __getitem__ = __len__ = __str__ = __format__ = __hash__ = _raise


UNDEF = _Undef()


def grab(lcls, names):
    return tuple(lcls.get(n, UNDEF) for n in names)


def convert_ifelse(pred, true_fn, false_fn, init, names=()):
    """Branch fns take the tuple of assigned names' CURRENT values (a
    branch that reads a name it also assigns would otherwise hit
    UnboundLocalError: python makes assigned names function-local) and
    return the updated tuple. The predicate is read on the host; an
    untaken branch may leave a fresh name as UNDEF, legal until used."""
    return true_fn(init) if _host_bool(pred) else false_fn(init)


def convert_while(cond_fn, body_fn, init, names=()):
    """cond_fn(carry_tuple) -> scalar; body_fn(carry_tuple) -> carry
    tuple: Python iterations while the condition, read on the host,
    holds."""
    carry = tuple(init)
    while _host_bool(cond_fn(carry)):
        carry = body_fn(carry)
    return carry


# -- for-loop sequence protocol ---------------------------------------------


class _RangeSeq:
    """range(...) whose bounds may be tensors (python range() rejects
    those)."""

    def __init__(self, start, stop, step):
        self.start, self.stop, self.step = start, stop, step


def to_seq_range(*args):
    if len(args) == 1:
        return _RangeSeq(0, args[0], 1)
    if len(args) == 2:
        return _RangeSeq(args[0], args[1], 1)
    return _RangeSeq(args[0], args[1], args[2])


def to_seq(x):
    x = _unwrap(x)
    if isinstance(x, range):
        return _RangeSeq(x.start, x.stop, x.step)
    return x


def seq_len(seq):
    if isinstance(seq, _RangeSeq):
        return len(range(_host_int(seq.start), _host_int(seq.stop),
                         _host_int(seq.step)))
    if hasattr(seq, "shape"):
        if not len(seq.shape):
            raise TypeError("to_static: cannot iterate a 0-d tensor")
        return int(seq.shape[0])
    return len(seq)


def seq_get(seq, i):
    if isinstance(seq, _RangeSeq):
        return seq.start + i * seq.step
    if isinstance(seq, (list, tuple)):
        return seq[_host_int(i)]
    return seq[i]


def seq_template(seq, n):
    """Pre-loop binding for the loop target: undefined for an empty
    sequence (python semantics), else the element at index 0."""
    if _host_int(n) == 0:
        return UNDEF
    return seq_get(seq, 0)


def convert_logical_and(a, b_fn):
    return _host_bool(a) and b_fn()


def convert_logical_or(a, b_fn):
    return _host_bool(a) or b_fn()


def convert_logical_not(a):
    return not _host_bool(a)


# -- the AST transformer -----------------------------------------------------


def _assigned_names(stmts) -> list:
    names = []

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if t.id not in names:
                        names.append(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for e in t.elts:
                        if isinstance(e, ast.Name) and e.id not in names:
                            names.append(e.id)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            if isinstance(node.target, ast.Name) and node.target.id not in names:
                names.append(node.target.id)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            pass  # nested defs keep their own scope

    for s in stmts:
        V().visit(s)
    return names


def _contains_return(stmts) -> bool:
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            V.found = True

        def visit_FunctionDef(self, node):
            pass

    for s in stmts:
        V().visit(s)
    return V.found


def _name_tuple(names, ctx):
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names], ctx=ctx())


def _lower_break_continue(stmts, brk, cnt):
    """Rewrite break/continue into flag assignments + rest-gating (the
    reference's break_continue_transformer.py): `break` sets the brk
    flag (the loop condition gains `and not brk`), `continue` sets the
    cnt flag (reset at the top of each iteration); statements after
    either, at any If nesting depth, are gated on the flags being
    unset. Does not descend into nested FunctionDefs (converted inner
    loops are already function defs by the time this runs, so any
    remaining Break/Continue belongs to THIS loop).
    Returns (new_stmts, uses_brk, uses_cnt)."""
    out, uses_brk, uses_cnt = [], False, False
    for idx, st in enumerate(stmts):
        rest = stmts[idx + 1:]
        if isinstance(st, ast.Break):
            out.append(ast.Assign(
                targets=[ast.Name(id=brk, ctx=ast.Store())],
                value=ast.Constant(value=True)))
            return out, True, uses_cnt  # rest of suite is dead code
        if isinstance(st, ast.Continue):
            out.append(ast.Assign(
                targets=[ast.Name(id=cnt, ctx=ast.Store())],
                value=ast.Constant(value=True)))
            return out, uses_brk, True
        if isinstance(st, ast.If):
            tb, tbrk, tcnt = _lower_break_continue(st.body, brk, cnt)
            fb, fbrk, fcnt = _lower_break_continue(st.orelse, brk, cnt)
            st.body = tb or [ast.Pass()]
            st.orelse = fb
            out.append(st)
            if tbrk or fbrk or tcnt or fcnt:
                uses_brk = uses_brk or tbrk or fbrk
                uses_cnt = uses_cnt or tcnt or fcnt
                new_rest, rbrk, rcnt = _lower_break_continue(rest, brk, cnt)
                uses_brk, uses_cnt = uses_brk or rbrk, uses_cnt or rcnt
                if new_rest:
                    flags = []
                    if tbrk or fbrk:
                        flags.append(ast.Name(id=brk, ctx=ast.Load()))
                    if tcnt or fcnt:
                        flags.append(ast.Name(id=cnt, ctx=ast.Load()))
                    test = flags[0] if len(flags) == 1 else ast.BoolOp(
                        op=ast.Or(), values=flags)
                    out.append(ast.If(
                        test=ast.UnaryOp(op=ast.Not(), operand=test),
                        body=new_rest, orelse=[]))
                return out, uses_brk, uses_cnt
            continue
        out.append(st)
    return out, uses_brk, uses_cnt


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites If/While/For whose condition may be traced. Mirrors the
    reference's IfElseTransformer/LoopTransformer
    (dygraph_to_static/loop_transformer.py:115 visit_For, :121
    visit_While) with break/continue and early-return support."""

    def __init__(self):
        self._count = 0

    def _uid(self):
        self._count += 1
        return self._count

    def visit_If(self, node):
        self.generic_visit(node)
        if _contains_return(node.body) or _contains_return(node.orelse):
            raise NotImplementedError(
                "to_static: `return` inside a converted if/else is not "
                "supported — assign to a variable and return after"
            )
        names = sorted(
            set(_assigned_names(node.body)) | set(_assigned_names(node.orelse))
        )
        if not names:
            return node  # pure-side-effect if over concrete values only
        k = self._uid()
        carry = f"_jst_ifc_{k}"
        tname, fname = f"_jst_true_{k}", f"_jst_false_{k}"
        unpack = ast.Assign(
            targets=[_name_tuple(names, ast.Store)],
            value=ast.Name(id=carry, ctx=ast.Load()),
        )
        ret = ast.Return(value=_name_tuple(names, ast.Load))
        import copy

        tfn = ast.FunctionDef(
            name=tname, args=_one_arg(carry),
            body=[unpack] + node.body + [ret], decorator_list=[],
        )
        ffn = ast.FunctionDef(
            name=fname, args=_one_arg(carry),
            body=[copy.deepcopy(unpack)] + list(node.orelse)
            + [copy.deepcopy(ret)],
            decorator_list=[],
        )
        call = ast.Assign(
            targets=[_name_tuple(names, ast.Store)],
            value=ast.Call(
                func=_jst_attr("convert_ifelse"),
                args=[_transform_test(node.test),
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      _grab_expr(names)],
                keywords=[ast.keyword(
                    arg="names",
                    value=ast.Tuple(
                        elts=[ast.Constant(value=n) for n in names],
                        ctx=ast.Load()))],
            ),
        )
        return [tfn, ffn, call]

    def visit_While(self, node):
        # ORDER MATTERS: lower break/continue on the RAW body first —
        # once generic_visit converts inner ifs into function defs, a
        # Break inside them would be 'break outside loop'. Nested
        # While/For still own their breaks (_lower_break_continue does
        # not descend into them); they convert during generic_visit
        # below.
        orelse = list(node.orelse)
        node.orelse = []
        if _contains_return(node.body):
            # _apply_return_transform lowers return-in-loop before this
            # runs; anything left (e.g. conversion invoked on a raw
            # fragment) still fails loudly
            raise NotImplementedError(
                "to_static: `return` inside a converted while is not supported"
            )
        k = self._uid()
        brk, cnt = f"_jst_brk_{k}", f"_jst_cnt_{k}"
        body, uses_brk, uses_cnt = _lower_break_continue(node.body, brk, cnt)
        pre = []
        test = node.test
        if uses_cnt:
            # reset at the top of each iteration
            body = [ast.Assign(targets=[ast.Name(id=cnt, ctx=ast.Store())],
                               value=ast.Constant(value=False))] + body
            pre.append(ast.Assign(
                targets=[ast.Name(id=cnt, ctx=ast.Store())],
                value=ast.Constant(value=False)))
        if uses_brk:
            test = ast.BoolOp(op=ast.And(), values=[
                test,
                ast.UnaryOp(op=ast.Not(),
                            operand=ast.Name(id=brk, ctx=ast.Load()))])
            pre.append(ast.Assign(
                targets=[ast.Name(id=brk, ctx=ast.Store())],
                value=ast.Constant(value=False)))
        node.body = body
        node.test = test
        ast.fix_missing_locations(node)
        self.generic_visit(node)
        test = node.test
        names = _assigned_names(node.body)
        if not names:
            raise NotImplementedError(
                "to_static: converted while must assign at least one variable"
            )
        carry = f"_jst_carry_{k}"
        cname, bname = f"_jst_cond_{k}", f"_jst_body_{k}"
        unpack = ast.Assign(
            targets=[_name_tuple(names, ast.Store)],
            value=ast.Name(id=carry, ctx=ast.Load()),
        )
        import copy

        cfn = ast.FunctionDef(
            name=cname, args=_one_arg(carry),
            body=[unpack, ast.Return(value=_transform_test(test))],
            decorator_list=[],
        )
        bfn = ast.FunctionDef(
            name=bname, args=_one_arg(carry),
            body=[copy.deepcopy(unpack)] + node.body + [
                ast.Return(value=_name_tuple(names, ast.Load))],
            decorator_list=[],
        )
        call = ast.Assign(
            targets=[_name_tuple(names, ast.Store)],
            value=ast.Call(
                func=_jst_attr("convert_while"),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      _grab_expr(names)],
                keywords=[ast.keyword(
                    arg="names",
                    value=ast.Tuple(
                        elts=[ast.Constant(value=n) for n in names],
                        ctx=ast.Load()))],
            ),
        )
        # a while/else's else suite runs unless the loop broke; the
        # else suite was detached before generic_visit, so convert it
        # here (visit may return a list per statement)
        def _flat_visit(stmts):
            out = []
            for s in stmts:
                r = self.visit(s)
                out.extend(r if isinstance(r, list) else [r])
            return out

        if orelse and uses_brk:
            gate = ast.If(
                test=ast.UnaryOp(op=ast.Not(),
                                 operand=ast.Name(id=brk, ctx=ast.Load())),
                body=orelse, orelse=[])
            ast.fix_missing_locations(gate)
            lowered_gate = self.visit_If(gate)
            orelse = (lowered_gate if isinstance(lowered_gate, list)
                      else [lowered_gate])
        elif orelse:
            orelse = _flat_visit(orelse)
        return [cfn, bfn] + pre + [call] + orelse

    def visit_For(self, node):
        """Lower `for target in ITER:` to the while machinery through a
        sequence protocol (reference loop_transformer.py:115 visit_For):

            seq = _jst.to_seq(ITER)        # range() -> _jst.to_seq_range
            n = _jst.seq_len(seq)
            i = 0
            target = _jst.seq_template(seq, n)
            while i < n:
                target = _jst.seq_get(seq, i)
                i = i + 1        # BEFORE the body: continue must not skip it
                <body>

        Supports range(...) with tensor bounds, tensor iteration (dim
        0), python lists, and enumerate(...) over any of those; the
        loop runs in convert_while."""
        import copy

        k = self._uid()
        seq_n, n_n, i_n = f"_jst_seq_{k}", f"_jst_n_{k}", f"_jst_it_{k}"
        iter_expr, target = node.iter, node.target

        enum_start = None
        if (isinstance(iter_expr, ast.Call)
                and isinstance(iter_expr.func, ast.Name)
                and iter_expr.func.id == "enumerate"):
            if not (isinstance(target, ast.Tuple) and len(target.elts) == 2):
                raise NotImplementedError(
                    "to_static: `for ... in enumerate(...)` needs a "
                    "2-name target (idx, item)")
            enum_start = ast.Constant(value=0)
            if len(iter_expr.args) > 1:
                enum_start = iter_expr.args[1]
            for kw in iter_expr.keywords:
                if kw.arg == "start":
                    enum_start = kw.value
            inner_iter = iter_expr.args[0]
            idx_target, item_target = target.elts[0], target.elts[1]
        else:
            inner_iter = iter_expr

        if (isinstance(inner_iter, ast.Call)
                and isinstance(inner_iter.func, ast.Name)
                and inner_iter.func.id == "range"):
            seq_value = ast.Call(func=_jst_attr("to_seq_range"),
                                 args=list(inner_iter.args), keywords=[])
        else:
            seq_value = ast.Call(func=_jst_attr("to_seq"),
                                 args=[inner_iter], keywords=[])

        def assign(tgt, value):
            return ast.Assign(targets=[tgt], value=value)

        def name(n, ctx=ast.Load):
            return ast.Name(id=n, ctx=ctx())

        get_call = ast.Call(func=_jst_attr("seq_get"),
                            args=[name(seq_n), name(i_n)], keywords=[])
        if enum_start is not None:
            head = [
                assign(copy.deepcopy(idx_target),
                       ast.BinOp(left=name(i_n), op=ast.Add(),
                                 right=enum_start)),
                assign(copy.deepcopy(item_target), get_call),
            ]
            template_tgts = [
                assign(copy.deepcopy(idx_target), ast.Constant(value=0)),
                assign(copy.deepcopy(item_target),
                       ast.Call(func=_jst_attr("seq_template"),
                                args=[name(seq_n), name(n_n)], keywords=[])),
            ]
        else:
            head = [assign(copy.deepcopy(target), get_call)]
            template_tgts = [
                assign(copy.deepcopy(target),
                       ast.Call(func=_jst_attr("seq_template"),
                                args=[name(seq_n), name(n_n)], keywords=[])),
            ]
        head.append(assign(name(i_n, ast.Store),
                           ast.BinOp(left=name(i_n), op=ast.Add(),
                                     right=ast.Constant(value=1))))
        pre = [
            assign(name(seq_n, ast.Store), seq_value),
            assign(name(n_n, ast.Store),
                   ast.Call(func=_jst_attr("seq_len"), args=[name(seq_n)],
                            keywords=[])),
            assign(name(i_n, ast.Store), ast.Constant(value=0)),
        ] + template_tgts
        new_while = ast.While(
            test=ast.Compare(left=name(i_n), ops=[ast.Lt()],
                             comparators=[name(n_n)]),
            body=head + list(node.body),
            orelse=list(node.orelse),
        )
        lowered = self.visit_While(new_while)
        return pre + (lowered if isinstance(lowered, list) else [lowered])

    # NOTE: and/or/not are rewritten ONLY inside if/while TESTS
    # (_transform_test below). A value-position boolop like
    # `cfg = opts or {}` keeps python's value-returning semantics.


class _TestExprTransformer(ast.NodeTransformer):
    """Rewrites and/or/not within a condition expression, preserving
    short-circuit for concrete values via lambdas."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(
                func=_jst_attr(fn),
                args=[out, ast.Lambda(args=_empty_args(), body=v)],
                keywords=[],
            )
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_logical_not"),
                            args=[node.operand], keywords=[])
        return node

    def visit_Lambda(self, node):
        return node  # don't descend into nested value expressions


def _transform_test(test):
    return ast.fix_missing_locations(_TestExprTransformer().visit(test))


def _empty_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                         kw_defaults=[], kwarg=None, defaults=[])


def _one_arg(name):
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=name)], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])


# the name the rewritten code reads this module by (JAX's is "_jst": a
# module may hold functions converted by both packages)
_NS = "_pt_jst"


def _jst_attr(name):
    return ast.Attribute(value=ast.Name(id=_NS, ctx=ast.Load()),
                         attr=name, ctx=ast.Load())


def _grab_expr(names):
    """`_jst.grab(locals(), [names])` — tolerates names not yet bound
    (assigned for the first time inside the converted block)."""
    return ast.Call(
        func=_jst_attr("grab"),
        args=[
            ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                     args=[], keywords=[]),
            ast.List(elts=[ast.Constant(value=n) for n in names],
                     ctx=ast.Load()),
        ],
        keywords=[],
    )


_CACHE = {}

_RV, _DONE = "_jst_ret_val", "_jst_done"


def finalize_ret(rv, done):
    """Final-return hook for functions whose body can fall off the end
    while other paths return a value: the fall-through path returns
    None, as Python's."""
    return rv if _host_bool(done) else None


def _guarantees_return(stmts):
    """True when every path through the suite ends in return/raise."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return (_guarantees_return(last.body)
                and _guarantees_return(last.orelse))
    return False


def _lower_returns(stmts):
    """Rewrite `return` inside if/else AND inside while/for into
    done-flag + value carries (the reference's return_transformer.py):
    a return in a loop becomes RV/done assignment + `break` (the
    break/continue lowering then turns that into loop exit), and
    statements after the loop are gated on the done flag. After this
    pass the only `return` left in the suite is a trailing top-level
    one. Returns (new_stmts, had_early_return)."""
    out, early = [], False
    for idx, st in enumerate(stmts):
        rest = stmts[idx + 1:]
        if isinstance(st, ast.Return):
            val = st.value if st.value is not None else ast.Constant(value=None)
            out.append(ast.Assign(
                targets=[ast.Name(id=_RV, ctx=ast.Store())], value=val))
            out.append(ast.Assign(
                targets=[ast.Name(id=_DONE, ctx=ast.Store())],
                value=ast.Constant(value=True)))
            return out, True  # anything after is dead code
        if isinstance(st, (ast.While, ast.For)):
            nb, ne = _lower_returns_in_loop(st.body)
            if ne:
                st.body = nb
                out.append(st)
                # while/else: a return exits immediately — the break
                # that implements it also (correctly) skips the else
                new_rest, _ = _lower_returns(rest)
                if new_rest:
                    out.append(ast.If(
                        test=ast.UnaryOp(
                            op=ast.Not(),
                            operand=ast.Name(id=_DONE, ctx=ast.Load())),
                        body=new_rest, orelse=[]))
                return out, True
            out.append(st)
            continue
        if isinstance(st, ast.If):
            tb, te = _lower_returns(st.body)
            fb, fe = _lower_returns(st.orelse)
            st.body = tb or [ast.Pass()]
            st.orelse = fb
            out.append(st)
            if te or fe:
                new_rest, _ = _lower_returns(rest)
                if new_rest:
                    out.append(ast.If(
                        test=ast.UnaryOp(
                            op=ast.Not(),
                            operand=ast.Name(id=_DONE, ctx=ast.Load())),
                        body=new_rest, orelse=[]))
                return out, True
            continue
        out.append(st)
    return out, early


def _lower_returns_in_loop(stmts):
    """Lower `return` within a loop body: RV/done assignment followed
    by `break`. After an If that may have returned, `if done: break`
    exits this loop level; a nested loop that returned gets the same
    gate right after it so the break propagates outward level by
    level. Returns (new_stmts, had_return)."""
    out, had = [], False
    done_break = lambda: ast.If(
        test=ast.Name(id=_DONE, ctx=ast.Load()),
        body=[ast.Break()], orelse=[])
    for st in stmts:
        if isinstance(st, ast.Return):
            val = st.value if st.value is not None else ast.Constant(value=None)
            out.append(ast.Assign(
                targets=[ast.Name(id=_RV, ctx=ast.Store())], value=val))
            out.append(ast.Assign(
                targets=[ast.Name(id=_DONE, ctx=ast.Store())],
                value=ast.Constant(value=True)))
            out.append(ast.Break())
            return out, True  # rest of the suite is dead code
        if isinstance(st, (ast.While, ast.For)):
            nb, ne = _lower_returns_in_loop(st.body)
            if ne:
                st.body = nb
                out.append(st)
                out.append(done_break())
                had = True
                continue
            out.append(st)
            continue
        if isinstance(st, ast.If):
            tb, te = _lower_returns_in_loop(st.body)
            fb, fe = _lower_returns_in_loop(st.orelse)
            st.body = tb or [ast.Pass()]
            st.orelse = fb
            out.append(st)
            if te or fe:
                out.append(done_break())
                had = True
            continue
        out.append(st)
    return out, had


def _apply_return_transform(fdef):
    guaranteed = _guarantees_return(fdef.body)
    body, had = _lower_returns(fdef.body)
    if not had:
        return
    inits = [
        ast.Assign(targets=[ast.Name(id=_DONE, ctx=ast.Store())],
                   value=ast.Constant(value=False)),
        ast.Assign(targets=[ast.Name(id=_RV, ctx=ast.Store())],
                   value=ast.Constant(value=None)),
    ]
    if guaranteed:
        final = ast.Return(value=ast.Name(id=_RV, ctx=ast.Load()))
    else:
        # fall-off-the-end is reachable: route through finalize_ret so
        # eager returns None on that path and jit fails loudly
        final = ast.Return(value=ast.Call(
            func=_jst_attr("finalize_ret"),
            args=[ast.Name(id=_RV, ctx=ast.Load()),
                  ast.Name(id=_DONE, ctx=ast.Load())],
            keywords=[]))
    fdef.body = inits + body + [final]


def convert_to_static(fn):
    """Source-to-source conversion (reference cache_program.py caches
    by function; same here)."""
    if fn in _CACHE:
        return _CACHE[fn]
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    fdef.decorator_list = []  # drop @declarative/@to_static
    _apply_return_transform(fdef)
    new_tree = _ControlFlowTransformer().visit(tree)
    ast.fix_missing_locations(new_tree)
    import sys

    # exec into the LIVE module globals (not a copy) so forward
    # references and monkeypatched globals keep working; only _NS is
    # injected (collision-checked). Closures exec into a COPY with the
    # free variables re-read from the cells at every call (they may be
    # rebound between calls).
    ns = dict(fn.__globals__) if fn.__closure__ else fn.__globals__
    me = sys.modules[__name__]
    if _NS in ns and ns[_NS] is not me:
        raise RuntimeError(
            f"to_static: the module already binds the name {_NS!r}"
        )
    ns[_NS] = me
    converted_name = fdef.name
    fdef.name = f"_jst_converted_{fn.__name__}"
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename=f"<to_static:{fn.__name__}>", mode="exec")
    exec(code, ns)
    inner = ns.pop(fdef.name)
    inner.__name__ = converted_name
    if fn.__closure__:
        free, cells = fn.__code__.co_freevars, fn.__closure__

        @functools.wraps(fn)
        def converted(*args, **kwargs):
            for n, c in zip(free, cells):
                ns[n] = c.cell_contents
            return inner(*args, **kwargs)
    else:
        converted = inner
    _CACHE[fn] = converted
    return converted


def declarative(fn=None):
    """@declarative — the reference dygraph_to_static entry point."""
    def deco(f):
        converted = convert_to_static(f)

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return converted(*args, **kwargs)

        wrapper._converted = converted
        wrapper._original = f
        return wrapper

    return deco(fn) if fn is not None else deco
