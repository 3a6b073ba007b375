"""Immutable tree framework with rule-based transforms (the port's copy of
`spark_tpu/plan/tree.py`).

Role of the reference's Catalyst tree framework:
  - TreeNode (sqlcat/trees/TreeNode.scala:70): children, transformUp/Down,
    withNewChildren, fastEquals, treeString
  - RuleExecutor (sqlcat/rules/RuleExecutor.scala:125, execute at :215):
    fixed-point batches of rules

Python re-design: nodes are plain objects whose children live in declared
`child_fields`; transforms rebuild nodes structurally. We skip the reference's
tree-pattern bitmask pruning (an optimization for 100+-rule batches) in favor
of cheap Python iteration; rule batches and fixed-point semantics are kept
because the optimizer design depends on them.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, Sequence, TypeVar

T = TypeVar("T", bound="TreeNode")

_id_counter = itertools.count()


def next_id() -> int:
    """Monotonic id source for expression ids (reference: NamedExpression.newExprId)."""
    return next(_id_counter)


class TreeNode:
    """Base of Expression and LogicalPlan/PhysicalPlan trees.

    Subclasses declare `child_fields`: names of attributes holding a child
    node, a list of child nodes, or None. Everything else is 'data'.
    """

    child_fields: tuple[str, ...] = ()

    # --- children ---------------------------------------------------------
    @property
    def children(self) -> list["TreeNode"]:
        out: list[TreeNode] = []
        for f in self.child_fields:
            v = getattr(self, f)
            if v is None:
                continue
            if isinstance(v, (list, tuple)):
                out.extend(c for c in v if c is not None)
            else:
                out.append(v)
        return out

    def with_new_children(self: T, new_children: Sequence["TreeNode"]) -> T:
        """Rebuild this node with children replaced positionally."""
        it = iter(new_children)
        kwargs: dict[str, Any] = {}
        for f in self.child_fields:
            v = getattr(self, f)
            if v is None:
                kwargs[f] = None
            elif isinstance(v, (list, tuple)):
                kwargs[f] = type(v)(next(it) for _ in v if _ is not None)
            else:
                kwargs[f] = next(it)
        return self.copy(**kwargs)

    def copy(self: T, **overrides: Any) -> T:
        """Shallow copy with attribute overrides. Subclasses with __init__
        side effects should override."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.__dict__.update(overrides)
        new.__dict__.pop("_dtype_memo", None)  # children may have changed
        return new

    # --- traversal --------------------------------------------------------
    def foreach(self, f: Callable[["TreeNode"], None]) -> None:
        f(self)
        for c in self.children:
            c.foreach(f)

    def foreach_up(self, f: Callable[["TreeNode"], None]) -> None:
        for c in self.children:
            c.foreach_up(f)
        f(self)

    def collect(self, pf: Callable[["TreeNode"], Any]) -> list[Any]:
        out: list[Any] = []

        def go(n: TreeNode) -> None:
            r = pf(n)
            if r is not None:
                out.append(r)

        self.foreach(go)
        return out

    def find(self, pred: Callable[["TreeNode"], bool]) -> "TreeNode | None":
        if pred(self):
            return self
        for c in self.children:
            r = c.find(pred)
            if r is not None:
                return r
        return None

    def exists(self, pred: Callable[["TreeNode"], bool]) -> bool:
        return self.find(pred) is not None

    def iter_nodes(self) -> Iterator["TreeNode"]:
        yield self
        for c in self.children:
            yield from c.iter_nodes()

    # --- transforms -------------------------------------------------------
    def map_children(self: T, f: Callable[["TreeNode"], "TreeNode"]) -> T:
        if not self.child_fields:
            return self
        changed = False
        kwargs: dict[str, Any] = {}
        for fld in self.child_fields:
            v = getattr(self, fld)
            if v is None:
                kwargs[fld] = None
            elif isinstance(v, (list, tuple)):
                nv = [f(c) if c is not None else None for c in v]
                if any(a is not b for a, b in zip(nv, v)):
                    changed = True
                kwargs[fld] = type(v)(nv)
            else:
                nv1 = f(v)
                if nv1 is not v:
                    changed = True
                kwargs[fld] = nv1
        return self.copy(**kwargs) if changed else self

    def transform_down(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> T:
        after = rule(self)
        if after is None:
            after = self
        return after.map_children(lambda c: c.transform_down(rule))

    def transform_up(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> T:
        with_new = self.map_children(lambda c: c.transform_up(rule))
        out = rule(with_new)
        return with_new if out is None else out

    transform = transform_up

    # --- equality ---------------------------------------------------------
    # attributes that duplicate child_fields content and must stay out of
    # equality (comparing them both as data and as children makes equality
    # traverse shared subtrees twice — exponential on expression DAGs)
    equality_excluded_fields: tuple[str, ...] = ()

    def _data_args(self) -> tuple:
        """Non-child attributes participating in equality. Default: all
        __dict__ entries not in child_fields (best-effort)."""
        skip = set(self.child_fields) | set(self.equality_excluded_fields)
        items = []
        for k in sorted(self.__dict__):
            # private attrs are caches (_hash, _cast_cache, _pipeline…) —
            # _cast_cache in particular holds a Cast whose child is THIS
            # node, which would make equality cyclic
            if k in skip or k.startswith("_"):
                continue
            v = self.__dict__[k]
            if isinstance(v, list):
                v = tuple(v)
            items.append((k, v))
        return tuple(items)

    def fast_equals(self, other: "TreeNode") -> bool:
        return self is other or self.semantic_equals(other)

    def semantic_equals(self, other: "TreeNode") -> bool:
        if type(self) is not type(other):
            return False
        if self._data_args() != other._data_args():
            return False
        a, b = self.children, other.children
        return len(a) == len(b) and all(x.semantic_equals(y) for x, y in zip(a, b))

    def __eq__(self, other: object) -> bool:  # expressions override (DSL)
        return isinstance(other, TreeNode) and self.semantic_equals(other)

    def __hash__(self) -> int:
        h = getattr(self, "_hash", None)
        if h is None:
            try:
                h = hash((type(self).__name__, self._data_args(),
                          tuple(hash(c) for c in self.children)))
            except TypeError:
                h = hash(type(self).__name__)
            self.__dict__["_hash"] = h
        return h

    # --- pretty printing --------------------------------------------------
    def node_name(self) -> str:
        return type(self).__name__

    def arg_string(self) -> str:
        parts = []
        for k, v in self._data_args():
            if v is None or v == () or v == "":
                continue
            parts.append(f"{k}={v!r}")
        return ", ".join(parts)

    def simple_string(self) -> str:
        a = self.arg_string()
        return f"{self.node_name()}({a})" if a else self.node_name()

    def tree_string(self, depth: int = 0) -> str:
        pad = "  " * depth
        lines = [pad + ("+- " if depth else "") + self.simple_string()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.simple_string()


# ---------------------------------------------------------------------------
# RuleExecutor
# ---------------------------------------------------------------------------

class Rule:
    """A named plan→plan transform (reference: sqlcat/rules/Rule.scala)."""

    name: str = ""

    def __call__(self, plan: T) -> T:
        return self.apply(plan)

    def apply(self, plan: T) -> T:
        raise NotImplementedError

    def rule_name(self) -> str:
        return self.name or type(self).__name__


class FixedPoint:
    def __init__(self, max_iterations: int = 100):
        self.max_iterations = max_iterations


class Once(FixedPoint):
    def __init__(self):
        super().__init__(1)


class Batch:
    def __init__(self, name: str, strategy: FixedPoint, rules: Sequence[Rule | Callable]):
        self.name = name
        self.strategy = strategy
        self.rules = list(rules)


class RuleExecutor:
    """Runs batches of rules to fixed point
    (reference: sqlcat/rules/RuleExecutor.scala:215 execute)."""

    def __init__(self) -> None:
        self.rule_timings: dict[str, float] = {}

    def batches(self) -> list[Batch]:
        raise NotImplementedError

    def execute(self, plan: T, tracker=None) -> T:
        import time

        cur = plan
        for batch in self.batches():
            iteration = 0
            while True:
                iteration += 1
                before = cur
                for rule in batch.rules:
                    t0 = time.perf_counter()
                    result = rule(cur)
                    if result is not None:
                        cur = result
                    name = rule.rule_name() if isinstance(rule, Rule) else getattr(
                        rule, "__name__", str(rule))
                    dt = time.perf_counter() - t0
                    self.rule_timings[name] = self.rule_timings.get(name, 0.0) + dt
                    if tracker is not None:
                        tracker.record_rule(name, dt)
                if cur.fast_equals(before):
                    break
                if iteration >= batch.strategy.max_iterations:
                    if batch.strategy.max_iterations > 1:
                        import warnings

                        warnings.warn(
                            f"Batch {batch.name!r} did not converge in "
                            f"{batch.strategy.max_iterations} iterations")
                    break
        return cur
