"""Higher-order functions over arrays and maps (counterpart of
`spark_tpu/expr/higher_order.py`): transform, filter, exists/any_match,
forall/all_match, aggregate/reduce, zip_with, transform_keys,
transform_values, map_filter, map_zip_with and array_sort with a
comparator, with the lambda binding (LambdaFunction, NamedLambdaVariable).

Collection columns are dictionary-encoded host values, so a lambda runs on
the host over one collection value at a time through the scalar
interpreter (expr/scalar.py); the device carries only the dictionary
codes. Each higher-order function lowers to a host UDF (expr/pyudf.py,
run by physical/python_eval.py) whose inputs are its collection
argument(s) plus any outer columns the lambda captures.
"""

from __future__ import annotations

import itertools
from typing import Sequence

from ..errors import AnalysisException
from ..types import (
    ArrayType, BooleanType, DataType, IntegerType, MapType, NullType,
    boolean, int32, null_type,
)
from . import expressions as E

_lambda_ids = itertools.count(1)


class UnresolvedNamedLambdaVariable(E.Expression):
    """A lambda parameter reference inside an unbound lambda body. The
    PARSER creates these (lexical scoping: it knows the param names), so
    attribute resolution can never capture a lambda name as a column."""

    child_fields = ()

    def __init__(self, name: str):
        self.name = name

    @property
    def resolved(self):
        return False

    @property
    def dtype(self):
        raise AnalysisException(
            f"lambda variable {self.name} not bound yet")

    def _data_args(self):
        return (("name", self.name),)

    def simple_string(self):
        return self.name


class NamedLambdaVariable(E.Expression):
    """A bound, typed lambda parameter (higherOrderFunctions.scala
    NamedLambdaVariable). Evaluated only by the scalar interpreter."""

    child_fields = ()

    def __init__(self, name: str, dtype: DataType,
                 expr_id: int | None = None):
        self.name = name
        self._dtype = dtype
        self.expr_id = expr_id if expr_id is not None \
            else next(_lambda_ids) | (1 << 40)   # disjoint from attr ids

    @property
    def resolved(self):
        return True

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return True

    def _data_args(self):
        return (("name", self.name), ("expr_id", self.expr_id))

    def eval(self, ctx):
        raise AnalysisException(
            f"lambda variable {self.name} outside a lambda body")

    def simple_string(self):
        return self.name


class LambdaFunction(E.Expression):
    """`x -> body` / `(x, y) -> body`. Ready for binding once its body
    has no unresolved attributes/functions left (lambda variables are
    bound by the enclosing higher-order function at build time)."""

    child_fields = ("body",)

    def __init__(self, params: Sequence[str], body: E.Expression):
        self.params = list(params)
        self.body = body

    @property
    def resolved(self):
        # ready for binding: outer-column references all resolved AND no
        # FREE lambda variables (a lambda referencing an ENCLOSING
        # lambda's parameter must wait for the outer binder - building
        # it standalone would bind against the wrong scope). Nested
        # lambdas bind their own params, so freeness is scope-aware.
        if any(isinstance(n, E.UnresolvedAttribute)
               for n in self.body.iter_nodes()):
            return False
        return not _free_lambda_vars(
            self.body, frozenset(p.lower() for p in self.params))

    @property
    def dtype(self):
        return self.body.dtype

    def _data_args(self):
        return (("params", tuple(self.params)),)

    def bind(self, types: Sequence[DataType]) -> tuple[list, E.Expression]:
        """params -> typed NamedLambdaVariables substituted into the body,
        then resolve functions that were waiting on the lambda types -
        including nested higher-order functions, which stay as HOF nodes
        for the scalar interpreter (ResolveLambdaVariables +
        ResolveFunctions ordering in higherOrderFunctions.scala)."""
        if len(self.params) > len(types):
            raise AnalysisException(
                f"lambda has {len(self.params)} parameters but at most "
                f"{len(types)} are available")
        vars_ = [NamedLambdaVariable(p, t)
                 for p, t in zip(self.params, types)]
        top = {p.lower(): v for p, v in zip(self.params, vars_)}

        def sub(node, byname):
            if isinstance(node, LambdaFunction):
                # an inner lambda's params SHADOW ours inside its body
                inner = {p.lower() for p in node.params}
                reduced = {k: v for k, v in byname.items()
                           if k not in inner}
                return node.copy(body=sub(node.body, reduced))
            if isinstance(node, UnresolvedNamedLambdaVariable):
                v = byname.get(node.name.lower())
                return v if v is not None else node  # inner binder's job
            node = node.map_children(lambda c: sub(c, byname))
            if isinstance(node, E.UnresolvedFunction) and \
                    all(c.resolved for c in node.args):
                return build_inner_function(node.fname, node.args,
                                            node.distinct)
            return node

        return vars_, sub(self.body, top)

    def simple_string(self):
        ps = ", ".join(self.params)
        return f"lambda ({ps}) -> {self.body.simple_string()}"


def _free_lambda_vars(e: E.Expression, bound: frozenset) -> set:
    """Lambda variable names referenced under `e` that no enclosing
    lambda (within `e`) binds."""
    if isinstance(e, UnresolvedNamedLambdaVariable):
        return set() if e.name.lower() in bound else {e.name.lower()}
    if isinstance(e, LambdaFunction):
        return _free_lambda_vars(
            e.body, bound | {p.lower() for p in e.params})
    out: set = set()
    for c in e.children:
        out |= _free_lambda_vars(c, bound)
    return out


def mark_lambda_params(body: E.Expression,
                       params: Sequence[str]) -> E.Expression:
    """Parser helper: rewrite single-part UnresolvedAttributes matching a
    param name into UnresolvedNamedLambdaVariable (lexical scoping)."""
    names = {p.lower() for p in params}

    def sub(node):
        if isinstance(node, E.UnresolvedAttribute) and \
                len(node.name_parts) == 1 and \
                node.name_parts[0].lower() in names:
            return UnresolvedNamedLambdaVariable(node.name_parts[0])
        return node.map_children(sub)

    return sub(body)


# ---------------------------------------------------------------------------
# HOF expressions
# ---------------------------------------------------------------------------

def _elem_type(dt: DataType) -> DataType:
    return dt.element_type if isinstance(dt, ArrayType) else null_type


class HigherOrderFunction(E.Expression):
    """Base: one or two collection args + one (or two) lambdas. Lowers
    itself through the Python-eval host path; `scalar_apply` computes
    the result for ONE collection value (also used when a HOF appears
    nested inside another lambda)."""

    child_fields = ("args", "function")
    fname = "hof"

    def __init__(self, args: Sequence[E.Expression],
                 function: LambdaFunction):
        self.args = list(args)
        self.function = function
        self._bound = None      # (vars, body) after bind

    # -- binding --------------------------------------------------------
    def lambda_types(self) -> list[DataType]:
        raise NotImplementedError

    def bound(self):
        if self._bound is None:
            if isinstance(self.function, LambdaFunction):
                self._bound = self.function.bind(self.lambda_types())
            else:
                raise AnalysisException(
                    f"{self.fname} expects a lambda argument")
        return self._bound

    def collection_args(self) -> list[E.Expression]:
        return self.args

    def capture_exprs(self) -> list[E.Expression]:
        """Expressions whose free column references the lowered UDF must
        receive as extra inputs (lambda bodies; aggregate's zero too)."""
        return [self.bound()[1]]

    @property
    def resolved(self):
        return all(a.resolved for a in self.args) and \
            self.function.resolved

    @property
    def nullable(self):
        return True

    def scalar_apply(self, values: list, env: dict):
        raise NotImplementedError

    def eval(self, ctx):
        from ..errors import ExecutionError

        raise ExecutionError(
            f"{self.fname} must lower through the Python-eval path")

    def simple_string(self):
        a = ", ".join(x.simple_string() for x in self.args)
        return f"{self.fname}({a}, {self.function.simple_string()})"


def _pyval(v):
    """numpy -> pure-Python values: lambda semantics (`is True` checks,
    Kleene logic) depend on Python singletons, and np.True_ is not
    True."""
    import numpy as np

    if isinstance(v, np.ndarray):
        return [_pyval(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_pyval(x) for x in v]
    if isinstance(v, dict):
        return {_pyval(k): _pyval(x) for k, x in v.items()}
    return v


def lower_hof(hof: "HigherOrderFunction"):
    """HOF -> PythonUDF over (collection args + captured outer columns):
    the planner's ExtractPythonUDFs path then evaluates it host-side
    per row with full capture semantics."""
    from .pyudf import PythonUDF
    from .scalar import free_attributes

    hof.bound()     # force binding errors to surface at analysis time
    captured, seen = [], set()
    for e in hof.capture_exprs():
        for a in free_attributes(e):
            if a.expr_id not in seen:
                seen.add(a.expr_id)
                captured.append(a)
    coll = hof.collection_args()

    def fn(*vals):
        vals = [_pyval(v) for v in vals]
        env = {a.expr_id: v
               for a, v in zip(captured, vals[len(coll):])}
        return hof.scalar_apply(list(vals[:len(coll)]), env)

    return PythonUDF(fn, coll + captured, hof.dtype, name=hof.fname,
                     vectorized=False)


class ArrayTransform(HigherOrderFunction):
    """transform(arr, x -> ...) / transform(arr, (x, i) -> ...)."""

    fname = "transform"

    def lambda_types(self):
        return [_elem_type(self.args[0].dtype), int32]

    @property
    def dtype(self):
        return ArrayType(self.bound()[1].dtype)

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        out = []
        for i, el in enumerate(arr):
            e2 = dict(env)
            e2[vars_[0].expr_id] = el
            if len(vars_) > 1:
                e2[vars_[1].expr_id] = i
            out.append(scalar_eval(body, e2))
        return out


class ArrayFilter(HigherOrderFunction):
    fname = "filter"

    def lambda_types(self):
        return [_elem_type(self.args[0].dtype), int32]

    @property
    def dtype(self):
        return self.args[0].dtype

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        out = []
        for i, el in enumerate(arr):
            e2 = dict(env)
            e2[vars_[0].expr_id] = el
            if len(vars_) > 1:
                e2[vars_[1].expr_id] = i
            if scalar_eval(body, e2) is True:
                out.append(el)
        return out


class ArrayExists(HigherOrderFunction):
    """exists(arr, pred) with SQL three-valued logic: TRUE if any
    element satisfies, else NULL if any predicate was NULL, else
    FALSE (ArrayExists.followThreeValuedLogic)."""

    fname = "exists"

    def lambda_types(self):
        return [_elem_type(self.args[0].dtype)]

    @property
    def dtype(self):
        return boolean

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        saw_null = False
        for el in arr:
            r = scalar_eval(body, {**env, vars_[0].expr_id: el})
            if r is True:
                return True
            if r is None:
                saw_null = True
        return None if saw_null else False


class ArrayForAll(HigherOrderFunction):
    fname = "forall"

    def lambda_types(self):
        return [_elem_type(self.args[0].dtype)]

    @property
    def dtype(self):
        return boolean

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        saw_null = False
        for el in arr:
            r = scalar_eval(body, {**env, vars_[0].expr_id: el})
            if r is False:
                return False
            if r is None:
                saw_null = True
        return None if saw_null else True


class ArrayAggregate(HigherOrderFunction):
    """aggregate(arr, zero, (acc, x) -> ..., [acc -> finish])."""

    fname = "aggregate"

    def __init__(self, args, merge: LambdaFunction,
                 finish: LambdaFunction | None = None):
        super().__init__(args, merge)
        self.finish = finish
        self._finish_bound = None

    # finish participates in tree traversal
    child_fields = ("args", "function", "finish")

    def lambda_types(self):
        zero_t = self.args[1].dtype
        return [zero_t, _elem_type(self.args[0].dtype)]

    def finish_bound(self):
        if self.finish is None:
            return None
        if self._finish_bound is None:
            self._finish_bound = self.finish.bind([self.args[1].dtype])
        return self._finish_bound

    @property
    def resolved(self):
        base = super().resolved
        if self.finish is not None:
            base = base and self.finish.resolved
        return base

    @property
    def dtype(self):
        if self.finish is not None:
            return self.finish_bound()[1].dtype
        return self.bound()[1].dtype

    def collection_args(self):
        return [self.args[0]]

    def capture_exprs(self):
        out = [self.bound()[1], self.args[1]]
        fb = self.finish_bound()
        if fb is not None:
            out.append(fb[1])
        return out

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        from .scalar import scalar_eval

        acc = scalar_eval(self.args[1], env)    # zero expr (env-bound)
        vars_, body = self.bound()
        for el in arr:
            acc = scalar_eval(
                body, {**env, vars_[0].expr_id: acc,
                       vars_[1].expr_id: el})
        fb = self.finish_bound()
        if fb is not None:
            fvars, fbody = fb
            acc = scalar_eval(fbody, {**env, fvars[0].expr_id: acc})
        return acc


class ZipWith(HigherOrderFunction):
    """zip_with(a, b, (x, y) -> ...) - pads the shorter side with
    NULLs (reference ZipWith semantics)."""

    fname = "zip_with"

    def lambda_types(self):
        return [_elem_type(self.args[0].dtype),
                _elem_type(self.args[1].dtype)]

    @property
    def dtype(self):
        return ArrayType(self.bound()[1].dtype)

    def scalar_apply(self, values, env):
        a, b = values[0], values[1]
        if a is None or b is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        n = max(len(a), len(b))
        out = []
        for i in range(n):
            out.append(scalar_eval(body, {
                **env,
                vars_[0].expr_id: a[i] if i < len(a) else None,
                vars_[1].expr_id: b[i] if i < len(b) else None}))
        return out


class ArraySortLambda(HigherOrderFunction):
    """array_sort(arr, (a, b) -> cmp) - comparator returns -1/0/1;
    NULLs placed last like the reference's default comparator."""

    fname = "array_sort"

    def lambda_types(self):
        et = _elem_type(self.args[0].dtype)
        return [et, et]

    @property
    def dtype(self):
        return self.args[0].dtype

    def scalar_apply(self, values, env):
        arr = values[0]
        if arr is None:
            return None
        import functools

        from .scalar import scalar_eval

        vars_, body = self.bound()

        def cmp(x, y):
            r = scalar_eval(body, {**env, vars_[0].expr_id: x,
                                   vars_[1].expr_id: y})
            return 0 if r is None else int(r)

        return sorted(arr, key=functools.cmp_to_key(cmp))


class TransformKeys(HigherOrderFunction):
    fname = "transform_keys"

    def lambda_types(self):
        dt = self.args[0].dtype
        if isinstance(dt, MapType):
            return [dt.key_type, dt.value_type]
        return [null_type, null_type]

    @property
    def dtype(self):
        dt = self.args[0].dtype
        vt = dt.value_type if isinstance(dt, MapType) else null_type
        return MapType(self.bound()[1].dtype, vt)

    def scalar_apply(self, values, env):
        m = values[0]
        if m is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        out = {}
        for k, v in m.items():
            nk = scalar_eval(body, {**env, vars_[0].expr_id: k,
                                    vars_[1].expr_id: v})
            if nk is None:
                raise AnalysisException(
                    "transform_keys: a lambda produced a NULL key")
            out[nk] = v
        return out


class TransformValues(TransformKeys):
    fname = "transform_values"

    @property
    def dtype(self):
        dt = self.args[0].dtype
        kt = dt.key_type if isinstance(dt, MapType) else null_type
        return MapType(kt, self.bound()[1].dtype)

    def scalar_apply(self, values, env):
        m = values[0]
        if m is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        return {k: scalar_eval(body, {**env, vars_[0].expr_id: k,
                                      vars_[1].expr_id: v})
                for k, v in m.items()}


class MapFilter(TransformKeys):
    fname = "map_filter"

    @property
    def dtype(self):
        return self.args[0].dtype

    def scalar_apply(self, values, env):
        m = values[0]
        if m is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        return {k: v for k, v in m.items()
                if scalar_eval(body, {**env, vars_[0].expr_id: k,
                                      vars_[1].expr_id: v}) is True}


class MapZipWith(HigherOrderFunction):
    """map_zip_with(m1, m2, (k, v1, v2) -> ...) over the key union."""

    fname = "map_zip_with"

    def lambda_types(self):
        d1, d2 = self.args[0].dtype, self.args[1].dtype
        kt = d1.key_type if isinstance(d1, MapType) else null_type
        v1 = d1.value_type if isinstance(d1, MapType) else null_type
        v2 = d2.value_type if isinstance(d2, MapType) else null_type
        return [kt, v1, v2]

    @property
    def dtype(self):
        d1 = self.args[0].dtype
        kt = d1.key_type if isinstance(d1, MapType) else null_type
        return MapType(kt, self.bound()[1].dtype)

    def scalar_apply(self, values, env):
        m1, m2 = values[0], values[1]
        if m1 is None or m2 is None:
            return None
        from .scalar import scalar_eval

        vars_, body = self.bound()
        keys = list(m1) + [k for k in m2 if k not in m1]
        return {k: scalar_eval(body, {
            **env, vars_[0].expr_id: k,
            vars_[1].expr_id: m1.get(k),
            vars_[2].expr_id: m2.get(k)}) for k in keys}


# ---------------------------------------------------------------------------
# builders (registry entries)
# ---------------------------------------------------------------------------

_INNER_HOFS = {
    "transform": lambda a, f: ArrayTransform([a], f),
    "filter": lambda a, f: ArrayFilter([a], f),
    "exists": lambda a, f: ArrayExists([a], f),
    "forall": lambda a, f: ArrayForAll([a], f),
    "aggregate": lambda a, z, m, fin=None: ArrayAggregate([a, z], m, fin),
    "reduce": lambda a, z, m, fin=None: ArrayAggregate([a, z], m, fin),
    "zip_with": lambda a, b, f: ZipWith([a, b], f),
    "transform_keys": lambda m, f: TransformKeys([m], f),
    "transform_values": lambda m, f: TransformValues([m], f),
    "map_filter": lambda m, f: MapFilter([m], f),
    "map_zip_with": lambda a, b, f: MapZipWith([a, b], f),
    "array_sort": lambda a, f: ArraySortLambda([a], f),
}


def build_inner_function(name: str, args, distinct: bool) -> E.Expression:
    """Function resolution INSIDE a lambda body: nested HOFs stay as HOF
    nodes (the scalar interpreter applies them); everything else goes
    through the normal registry."""
    from .registry import build_function

    b = _INNER_HOFS.get(name.lower())
    if b is not None and any(isinstance(a, LambdaFunction) for a in args):
        return b(*args)
    return build_function(name, list(args), distinct)

def _need_lambda(args, n, name):
    lams = [a for a in args if isinstance(a, LambdaFunction)]
    if len(lams) < n:
        raise AnalysisException(f"{name} expects a lambda argument")
    return lams


def build_transform(arr, f):
    _need_lambda([f], 1, "transform")
    return lower_hof(ArrayTransform([arr], f))


def build_filter(arr, f):
    _need_lambda([f], 1, "filter")
    return lower_hof(ArrayFilter([arr], f))


def build_exists(arr, f):
    _need_lambda([f], 1, "exists")
    return lower_hof(ArrayExists([arr], f))


def build_forall(arr, f):
    _need_lambda([f], 1, "forall")
    return lower_hof(ArrayForAll([arr], f))


def build_aggregate(arr, zero, merge, finish=None):
    _need_lambda([merge], 1, "aggregate")
    return lower_hof(ArrayAggregate([arr, zero], merge, finish))


def build_zip_with(a, b, f):
    _need_lambda([f], 1, "zip_with")
    return lower_hof(ZipWith([a, b], f))


def build_transform_keys(m, f):
    _need_lambda([f], 1, "transform_keys")
    return lower_hof(TransformKeys([m], f))


def build_transform_values(m, f):
    _need_lambda([f], 1, "transform_values")
    return lower_hof(TransformValues([m], f))


def build_map_filter(m, f):
    _need_lambda([f], 1, "map_filter")
    return lower_hof(MapFilter([m], f))


def build_map_zip_with(m1, m2, f):
    _need_lambda([f], 1, "map_zip_with")
    return lower_hof(MapZipWith([m1, m2], f))
