"""dy2static control-flow conversion: Python ``if``/``while`` on tensors
(counterpart of ``paddle_tpu/jit/dy2static.py``).

The source rewrite is the reference's, line for line: an ``if``/``elif``
/``else`` (branches that ``return`` included, the statement tail folded
into the implicit else), a ``while`` (``break``/``continue`` desugared
into flags folded into the loop condition and guards), a ``for ... in
range(...)`` (a counter ``while``, literal steps only) and ``and``/
``or``/``not`` in their tests become calls of ``convert_ifelse``,
``convert_while_loop`` and ``convert_logical_*``; a function the
rewrite cannot take (no source, a closure, ``return`` inside a loop)
runs as written.

What a converted call does depends on its predicate (port semantics):

- a Python or numpy value runs the taken branch as plain Python, as in
  the reference;
- a tensor inside ``torch.export`` tracing (a ``jit.save``) becomes
  ``torch.cond`` or ``while_loop``: both branches are traced, and every
  variable either branch assigns must give matching shapes and dtypes,
  as the reference requires of ``lax.cond``/``lax.while_loop``; what
  the export cannot represent raises ``Dy2StaticError``, it never bakes
  in the one branch the example took;
- a tensor run eagerly, on the CPU or the card, is read back to the
  host (``bool``) and counted in ``host_reads()``.  The reference kept
  such a predicate on the device inside its jitted module; a CUDA graph
  cannot branch, so ``jit.to_static`` keeps a signature whose warm-up
  read a predicate eager, and says so (``StaticFunction.modes()``).
"""
import ast
import functools
import inspect
import textwrap
import types

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ['convert_ifelse', 'convert_while_loop', 'convert_logical_and',
           'convert_logical_or', 'convert_logical_not',
           'convert_control_flow', 'UNDEFINED', 'Dy2StaticError',
           'host_reads']


class Dy2StaticError(RuntimeError):
    """Converted control flow that ``torch.export`` cannot represent
    (branches of other shapes, a carry that changes dtype, an operation
    ``torch.cond``/``while_loop`` does not take)."""


class _Undefined:
    """Placeholder for names not yet bound when a converted block runs
    (the reference uses UndefinedVar).  Any use raises a clear error."""

    def __repr__(self):
        return '<undefined variable>'

    def _die(self, *a, **k):
        raise NameError(
            'variable used before assignment inside converted control '
            'flow (assign it on every path before use)')

    __getattr__ = __call__ = __add__ = __radd__ = __mul__ = _die
    __bool__ = __iter__ = _die


UNDEFINED = _Undefined()

_reads = 0


def host_reads():
    """How many tensor predicates converted code has read back to the
    host in this process."""
    return _reads


def _tracing(x):
    """True when ``x`` is a tensor of a ``torch.export`` (or compile)
    trace rather than one holding data."""
    if not isinstance(x, torch.Tensor):
        return False
    if torch.compiler.is_exporting() or torch.compiler.is_compiling():
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _read(pred):
    """The truth of a one-element tensor predicate, read on the host."""
    global _reads
    if pred.numel() != 1:
        raise ValueError(
            f'a tensor predicate must hold one element, got shape '
            f'{tuple(pred.shape)}')
    _reads += 1
    return bool(pred.reshape(()))


def _truth(pred):
    return _read(pred) if isinstance(pred, torch.Tensor) else bool(pred)


def _scalar_pred(pred):
    if pred.numel() != 1:
        raise Dy2StaticError(
            f'a tensor predicate must hold one element, got shape '
            f'{tuple(pred.shape)}')
    return pred.reshape(()).bool()


def _check_defined(tree, where):
    leaves = pytree.tree_leaves(tree)
    if any(v is UNDEFINED for v in leaves):
        raise ValueError(
            f'converted {where}: every variable carried through tensor '
            'control flow must be assigned before it and on every '
            'branch (found an unassigned one)')


def _as_tensors(tree, device, where):
    """Every leaf a tensor (Python and numpy numbers on ``device``), as
    ``torch.cond``/``while_loop`` carry only tensors."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, int, float, np.ndarray, np.generic)):
            return torch.as_tensor(v, device=device)
        raise Dy2StaticError(
            f'converted {where}: torch.export carries only tensors and '
            f'numbers through tensor control flow, got {type(v).__name__}')
    return pytree.tree_map(leaf, tree)


def grab(local_ns, names):
    """Fetch possibly-unbound locals for branch-function arguments."""
    return tuple(local_ns.get(n, UNDEFINED) for n in names)


def convert_ifelse(pred, true_fn, false_fn, args=()):
    """``if pred: ... else: ...``: ``torch.cond`` when ``pred`` is a
    tensor of an export trace, else the taken branch (a tensor ``pred``
    read on the host).  ``true_fn``/``false_fn`` take ``*args`` (the
    variables either branch assigns) and return the tuple of their
    final values (or, for branches that return, the function's
    value)."""
    if _tracing(pred):
        return _cond(pred, true_fn, false_fn, args)
    return true_fn(*args) if _truth(pred) else false_fn(*args)


def _cond(pred, true_fn, false_fn, args):
    tpos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    def branch(fn):
        def run(*tensors):
            full = list(args)
            for i, t in zip(tpos, tensors):
                full[i] = t
            out = fn(*full)
            _check_defined(out, 'if/else')
            return _as_tensors(out, pred.device, 'if/else')
        return run

    try:
        return torch.cond(_scalar_pred(pred), branch(true_fn),
                          branch(false_fn), tuple(args[i] for i in tpos))
    except (Dy2StaticError, ValueError, NameError):
        raise
    except Exception as e:
        raise Dy2StaticError(
            f'converted if/else: torch.export cannot represent this '
            f'tensor branch ({type(e).__name__}: {e})') from e


def convert_while_loop(cond_fn, body_fn, loop_vars):
    """``while cond: body``: ``while_loop`` when the condition is a
    tensor of an export trace, else a Python loop (a tensor condition
    read on the host each turn).  ``cond_fn``/``body_fn`` take
    ``*loop_vars``; ``body_fn`` returns their new values.  Vars still
    UNDEFINED at entry are loop-local temporaries, recomputed each
    iteration and not carried (reading one after the loop raises, as
    the reference's UndefinedVar does)."""
    pred = cond_fn(*loop_vars)
    if _tracing(pred):
        return _while(pred, cond_fn, body_fn, loop_vars)
    while _truth(pred):
        loop_vars = body_fn(*loop_vars)
        pred = cond_fn(*loop_vars)
    return loop_vars


def _while(pred0, cond_fn, body_fn, loop_vars):
    from torch._higher_order_ops.while_loop import while_loop
    carried = [i for i, v in enumerate(loop_vars) if v is not UNDEFINED]
    n = len(loop_vars)
    device = pred0.device

    def full(vs):
        out = [UNDEFINED] * n
        for slot, v in zip(carried, vs):
            out[slot] = v
        return out

    init = _as_tensors(tuple(loop_vars[i] for i in carried), device,
                       'while')

    def cond(*vs):
        p = cond_fn(*full(vs))
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(bool(p), device=device)
        return _scalar_pred(p)

    def body(*vs):
        out = body_fn(*full(vs))
        picked = tuple(out[i] for i in carried)
        _check_defined(picked, 'while')
        picked = _as_tensors(picked, device, 'while')
        for was, now in zip(init, picked):
            if was.dtype != now.dtype:
                raise Dy2StaticError(
                    f'converted while: a carried variable changes dtype '
                    f'from {was.dtype} to {now.dtype} in the body; start '
                    'it as a tensor of the dtype the body gives it')
        return picked

    try:
        res = while_loop(cond, body, tuple(init))
    except (Dy2StaticError, ValueError, NameError):
        raise
    except Exception as e:
        raise Dy2StaticError(
            f'converted while: torch.export cannot represent this tensor '
            f'loop ({type(e).__name__}: {e})') from e
    final = [UNDEFINED] * n
    for slot, v in zip(carried, res):
        final[slot] = v
    return tuple(final)


def convert_logical_and(x_fn, y_fn):
    """``x and y``: both sides and ``torch.logical_and`` in an export
    trace; else Python's short circuit, a tensor side read on the
    host."""
    x = x_fn()
    if _tracing(x):
        y = y_fn()
        return torch.logical_and(x, _as_tensors(y, x.device, 'and'))
    return y_fn() if _truth(x) else x


def convert_logical_or(x_fn, y_fn):
    x = x_fn()
    if _tracing(x):
        y = y_fn()
        return torch.logical_or(x, _as_tensors(y, x.device, 'or'))
    return x if _truth(x) else y_fn()


def convert_logical_not(x):
    """``not x``: a tensor stays on its device (``torch.logical_not``),
    for the ``if``/``while`` that reads it; a Python value is negated."""
    if isinstance(x, torch.Tensor):
        return torch.logical_not(x)
    return not x


# -- AST rewrite -------------------------------------------------------------

class _Unsupported(Exception):
    pass


class _StoreCollector(ast.NodeVisitor):
    """Names assigned within a statement block (not descending into
    nested function/class definitions)."""

    def __init__(self):
        self.names = []

    def _add(self, name):
        if name not in self.names:
            self.names.append(name)

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._add(node.id)

    def visit_FunctionDef(self, node):
        self._add(node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._add(node.name)

    def visit_Lambda(self, node):
        pass  # own scope


def _stores(stmts):
    c = _StoreCollector()
    for s in stmts:
        c.visit(s)
    return c.names


def _has(stmts, kinds):
    for s in stmts:
        for node in ast.walk(s):
            if isinstance(node, kinds):
                return True
    return False


def _returns_directly(stmts, kinds=(ast.Return,)):
    """True if the block contains a Return not nested in a def."""
    for s in stmts:
        if isinstance(s, ast.Return):
            return True
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        for node in ast.walk(s):
            if isinstance(node, ast.Return):
                return True
    return False


# collision-safe module-globals binding (the reference's converted code
# binds '__paddle_tpu_jst__' in the same modules)
_JST = '__paddle_tpu_torch_jst__'


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _jst(attr):
    return ast.Attribute(value=_name(_JST), attr=attr, ctx=ast.Load())


def _call(func, args=None, keywords=None):
    return ast.Call(func=func, args=args or [], keywords=keywords or [])


def _tuple_of(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.n = 0

    def _uid(self):
        self.n += 1
        return self.n

    # tests: a and b / a or b / not a -> converted ops
    def _convert_test(self, node):
        if isinstance(node, ast.BoolOp):
            vals = [self._convert_test(v) for v in node.values]
            fn = ('convert_logical_and'
                  if isinstance(node.op, ast.And) else 'convert_logical_or')
            out = vals[0]
            for v in vals[1:]:
                out = _call(_jst(fn), [
                    ast.Lambda(args=ast.arguments(
                        posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                        kw_defaults=[], kwarg=None, defaults=[]), body=out),
                    ast.Lambda(args=ast.arguments(
                        posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                        kw_defaults=[], kwarg=None, defaults=[]), body=v)])
            return out
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return _call(_jst('convert_logical_not'),
                         [self._convert_test(node.operand)])
        return self.visit(node)

    def _fn_def(self, name, argnames, body):
        return ast.FunctionDef(
            name=name,
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=a) for a in argnames],
                vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
                defaults=[]),
            body=body, decorator_list=[], returns=None, type_params=[])

    def _grab_call(self, names):
        return _call(_jst('grab'), [
            _call(_name('locals')),
            ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                      ctx=ast.Load())])

    def visit_If(self, node):
        # handled by _transform_block (needs the statement tail)
        return node

    def visit_While(self, node):
        return node

    def visit_FunctionDef(self, node):
        node.body = self._transform_block(node.body, fn_exit=True)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_For(self, node):
        node.body = self._transform_block(node.body, fn_exit=False)
        node.orelse = self._transform_block(node.orelse, fn_exit=False)
        return node

    # -- for-range desugaring (reference convert_operators.py converts
    # tensor-ranged `for` through the same while machinery) -----------

    @staticmethod
    def _is_range_for(node):
        return (isinstance(node, ast.For)
                and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == 'range'
                and not node.iter.keywords
                and 1 <= len(node.iter.args) <= 3)

    def _desugar_range_for(self, node):
        """`for i in range(a, b, s): body` -> counter while.

        The increment runs BEFORE the user body so `continue` keeps
        python-for semantics (next item, not an infinite loop); the
        loop variable is assigned from the counter at body entry, so
        it holds the last executed value after the loop, like python.
        The resulting While then converts through _rewrite_while when
        its predicate traces (tensor range bound), or runs as plain
        python when concrete.
        """
        if node.orelse:
            raise _Unsupported('for/else on a converted range loop')
        uid = self._uid()
        it = f'__cf_it_{uid}'
        args = node.iter.args
        if len(args) == 1:
            start, stop, step = ast.Constant(value=0), args[0], 1
        elif len(args) == 2:
            start, stop, step = args[0], args[1], 1
        else:
            start, stop = args[0], args[1]
            s = args[2]
            neg = (isinstance(s, ast.UnaryOp)
                   and isinstance(s.op, ast.USub)
                   and isinstance(s.operand, ast.Constant))
            if isinstance(s, ast.Constant) and isinstance(s.value, int):
                step = s.value
            elif neg and isinstance(s.operand.value, int):
                step = -s.operand.value
            else:
                raise _Unsupported(
                    'range() step must be an integer literal in a '
                    'converted for')
            if step == 0:
                raise _Unsupported('range() step of 0')
        step_const = step if isinstance(step, int) else 1
        cmp_op = ast.Lt() if step_const > 0 else ast.Gt()
        # hoist the stop into a temp evaluated ONCE before the loop —
        # python evaluates range() bounds once, so a body that mutates
        # a variable used in the bound must not change iteration count
        stop_name = f'__cf_stop_{uid}'
        test = ast.Compare(left=_name(it), ops=[cmp_op],
                           comparators=[_name(stop_name)])
        body = [
            ast.Assign(targets=[ast.Name(id=node.target.id,
                                         ctx=ast.Store())],
                       value=_name(it)),
            ast.Assign(targets=[_name(it, ast.Store())],
                       value=ast.BinOp(left=_name(it), op=ast.Add(),
                                       right=ast.Constant(
                                           value=step_const))),
        ] + list(node.body)
        return [
            ast.Assign(targets=[_name(it, ast.Store())], value=start),
            ast.Assign(targets=[_name(stop_name, ast.Store())],
                       value=stop),
            ast.While(test=test, body=body, orelse=[]),
        ]

    def visit_With(self, node):
        node.body = self._transform_block(node.body, fn_exit=False)
        return node

    visit_AsyncWith = visit_With

    def visit_Try(self, node):
        node.body = self._transform_block(node.body, fn_exit=False)
        node.orelse = self._transform_block(node.orelse, fn_exit=False)
        node.finalbody = self._transform_block(node.finalbody,
                                               fn_exit=False)
        for h in node.handlers:
            h.body = self._transform_block(h.body, fn_exit=False)
        return node

    def _rewrite_if(self, node, tail, fn_exit):
        """Rewrite one If; returns (new_stmts, consumed_tail).

        `fn_exit` is True when falling off the end of the current block
        returns from the function (function top level, or a branch of an
        already-return-folded if).  Only there may a partially-returning
        `if` fold the statement tail into its implicit else — inside a
        for/while/with/try body, fall-through continues the block, so
        such an `if` is unconvertible (the whole function falls back)."""
        uid = self._uid()
        test = self._convert_test(node.test)

        body_ret = _returns_directly(node.body)
        else_ret = _returns_directly(node.orelse) if node.orelse else False

        if body_ret or else_ret:
            both = body_ret and else_ret
            if not both and not fn_exit:
                raise _Unsupported(
                    'early return from an `if` inside a loop/with/try')
            # fold the statement tail into the non-returning branch so
            # both end in return; `if p: return X` + tail -> else = tail
            raw_body, raw_else = list(node.body), list(node.orelse)
            consumed = False
            if not both:
                if not node.orelse:
                    raw_else = list(tail)
                elif not body_ret:
                    raw_body = raw_body + list(tail)
                else:
                    raw_else = raw_else + list(tail)
                consumed = True
            # params must cover everything either branch (incl. folded
            # tail) assigns, or reassignments hit UnboundLocalError
            stores = sorted(set(_stores(raw_body) + _stores(raw_else)))
            body = self._transform_block(raw_body, fn_exit=True)
            orelse = self._transform_block(raw_else, fn_exit=True)
            if not body or not _returns_directly(body):
                body = body + [ast.Return(value=ast.Constant(value=None))]
            if not orelse or not _returns_directly(orelse):
                orelse = orelse + [ast.Return(value=ast.Constant(value=None))]
            tname, fname = f'__cf_true_{uid}', f'__cf_false_{uid}'
            stmts = [
                self._fn_def(tname, stores, body),
                self._fn_def(fname, stores, orelse),
                ast.Return(value=_call(_jst('convert_ifelse'), [
                    test, _name(tname), _name(fname),
                    self._grab_call(stores)])),
            ]
            return stmts, consumed

        body = self._transform_block(node.body, fn_exit=False)
        orelse = self._transform_block(node.orelse, fn_exit=False)
        stores = sorted(set(_stores(node.body) + _stores(node.orelse)))
        if not stores:
            # pure side-effect-free branches (e.g. asserts) — keep as-is
            node.test = test
            node.body = body
            node.orelse = orelse
            return [node], False
        tname, fname = f'__cf_true_{uid}', f'__cf_false_{uid}'
        ret = ast.Return(value=_tuple_of(stores))
        stmts = [
            self._fn_def(tname, stores, body + [ret]),
            self._fn_def(fname, stores,
                         (orelse or [ast.Pass()]) + [ast.Return(
                             value=_tuple_of(stores))]),
            ast.Assign(
                targets=[_tuple_of(stores, ast.Store())],
                value=_call(_jst('convert_ifelse'), [
                    test, _name(tname), _name(fname),
                    self._grab_call(stores)])),
        ]
        return stmts, False

    # -- break/continue desugaring (reference convert_operators.py:25
    # handles these through while-op flags; same flag technique here) --

    @staticmethod
    def _contains_bc(node):
        """break/continue belonging to THIS loop level (not descending
        into nested loops or function definitions)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.While, ast.For, ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda,
                                  ast.ClassDef)):
                continue
            if isinstance(child, (ast.Break, ast.Continue)) \
                    or _ControlFlowTransformer._contains_bc(child):
                return True
        return False

    def _desugar_bc(self, stmts, brk, cont):
        """Rewrite break -> brk=True, continue -> cont=True, and guard
        every statement that follows a potential flag set with
        `if not (brk or cont):` — the guards become lax.cond via the
        normal if conversion, so `while` bodies with break/continue
        compile into the SAME lax.while_loop (flag folded into the
        loop condition)."""

        def set_flag(name):
            return ast.Assign(targets=[_name(name, ast.Store())],
                              value=ast.Constant(value=True))

        def not_skipping():
            return ast.UnaryOp(op=ast.Not(), operand=ast.BoolOp(
                op=ast.Or(), values=[_name(brk), _name(cont)]))

        def rewrite(block):
            out = []
            for idx, s in enumerate(block):
                rest = block[idx + 1:]
                if isinstance(s, ast.Break):
                    out.append(set_flag(brk))
                    return out          # rest is unreachable
                if isinstance(s, ast.Continue):
                    out.append(set_flag(cont))
                    return out
                if isinstance(s, ast.If) and self._contains_bc(s):
                    new_if = ast.If(
                        test=s.test,
                        body=rewrite(s.body) or [ast.Pass()],
                        orelse=rewrite(s.orelse))
                    out.append(new_if)
                    if rest:
                        tail = rewrite(rest)
                        if tail:
                            out.append(ast.If(test=not_skipping(),
                                              body=tail, orelse=[]))
                    return out
                if isinstance(s, (ast.With, ast.AsyncWith, ast.Try)) \
                        and self._contains_bc(s):
                    raise _Unsupported(
                        'break/continue inside with/try in a converted '
                        'while')
                out.append(s)
            return out

        return rewrite(stmts)

    def _rewrite_while(self, node):
        if _returns_directly(node.body):
            raise _Unsupported('return in converted while')
        if node.orelse:
            raise _Unsupported('while/else')
        uid = self._uid()
        pre = []
        body_stmts = list(node.body)
        test_ast = node.test
        if _has(node.body, (ast.Break, ast.Continue)):
            brk, cont = f'__cf_brk_{uid}', f'__cf_cont_{uid}'
            body_stmts = self._desugar_bc(body_stmts, brk, cont)
            # cont resets every iteration (loop-local); brk is carried
            # and folds into the loop condition
            body_stmts = [ast.Assign(
                targets=[_name(cont, ast.Store())],
                value=ast.Constant(value=False))] + body_stmts
            pre = [ast.Assign(targets=[_name(brk, ast.Store())],
                              value=ast.Constant(value=False))]
            test_ast = ast.BoolOp(op=ast.And(), values=[
                ast.UnaryOp(op=ast.Not(), operand=_name(brk)),
                node.test])
        test = self._convert_test(test_ast)
        body = self._transform_block(body_stmts)
        stores = sorted(set(_stores(body_stmts)))
        if not stores:
            raise _Unsupported('while body assigns nothing')
        cname, bname = f'__cf_cond_{uid}', f'__cf_body_{uid}'
        stmts = [
            self._fn_def(cname, stores, [ast.Return(value=test)]),
            self._fn_def(bname, stores,
                         body + [ast.Return(value=_tuple_of(stores))]),
            ast.Assign(
                targets=[_tuple_of(stores, ast.Store())],
                value=_call(_jst('convert_while_loop'), [
                    _name(cname), _name(bname), self._grab_call(stores)])),
        ]
        return pre + stmts

    def _transform_block(self, stmts, fn_exit=False):
        out = []
        i = 0
        while i < len(stmts):
            s = stmts[i]
            if isinstance(s, ast.If):
                new, consumed = self._rewrite_if(s, stmts[i + 1:],
                                                 fn_exit)
                out.extend(new)
                if consumed:
                    return out
                i += 1
                continue
            if isinstance(s, ast.While):
                out.extend(self._rewrite_while(s))
                i += 1
                continue
            if self._is_range_for(s):
                # desugar to a counter while and convert THAT (tensor
                # range bounds lower to lax.while_loop; concrete ones
                # run as plain python inside convert_while_loop)
                out.extend(self._transform_block(
                    self._desugar_range_for(s), fn_exit=False))
                i += 1
                continue
            out.append(self.visit(s))
            i += 1
        return out


def _transform_source(fn):
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise _Unsupported('not a plain function definition')
    fdef.decorator_list = []  # avoid re-applying @to_static etc.
    tr = _ControlFlowTransformer()
    fdef.body = tr._transform_block(fdef.body, fn_exit=True)
    if tr.n == 0:
        return None  # nothing to convert
    ast.fix_missing_locations(tree)
    module_code = compile(tree, filename=f'<dy2static {fn.__qualname__}>',
                          mode='exec')
    inner = next(c for c in module_code.co_consts
                 if isinstance(c, types.CodeType)
                 and c.co_name == fdef.name)
    # bind against the LIVE module globals (not a snapshot) so later
    # global reassignments / monkeypatches stay visible; only the _JST
    # helper binding is added
    import sys
    g = fn.__globals__
    g.setdefault(_JST, sys.modules[__name__])
    new = types.FunctionType(inner, g, fn.__name__, fn.__defaults__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new = functools.wraps(fn)(new)
    return new


_cache = {}


def convert_control_flow(fn):
    """AST-convert tensor control flow in `fn`; returns `fn` unchanged
    when conversion is impossible (no source, closures, unsupported
    constructs) — plain tracing then behaves exactly as before."""
    if isinstance(fn, types.MethodType):
        converted = convert_control_flow(fn.__func__)
        if converted is fn.__func__:
            return fn
        return types.MethodType(converted, fn.__self__)
    key = getattr(fn, '__code__', None)
    if key is None:
        return fn
    if key in _cache:
        return _cache[key]
    out = fn
    try:
        if not fn.__code__.co_freevars:  # closures: bail (see docstring)
            t = _transform_source(fn)
            if t is not None:
                out = t
    except (_Unsupported, OSError, TypeError, SyntaxError, ValueError):
        out = fn
    _cache[key] = out
    return out
