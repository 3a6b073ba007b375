"""SQL parser: text -> unresolved LogicalPlan (counterpart of
`spark_tpu/sql/parser.py`, the SELECT grammar of the port's slices).

The productions below are the reference's, copied: WITH (common table
expressions: inlined where used once or cheap, else materialised once by
the session through `WithCTE`, the reference's choice; a CTE is visible
inside subquery expressions too); UNION [ALL | DISTINCT], INTERSECT,
EXCEPT and MINUS (ALL reads as DISTINCT, as in the reference); SELECT
[DISTINCT] with AS and bare aliases; FROM comma lists, joins with ON,
table aliases and subqueries with an alias; WHERE, GROUP BY (ordinals
too), HAVING, ORDER BY ... ASC|DESC [NULLS FIRST|LAST], LIMIT and OFFSET;
AND/OR/NOT, comparisons, IS [NOT] NULL, [NOT] IN (list), [NOT] IN
(SELECT ...), [NOT] EXISTS (SELECT ...), scalar subqueries, [NOT]
LIKE, [NOT] BETWEEN, `+ - * /`, `||`, unary minus, parentheses, integer, decimal,
string, DATE, TIMESTAMP and INTERVAL literals, CAST (timestamp among its
types), CASE (searched and simple), EXTRACT, struct field access `a.b`
(also on a function's result), the `[]` subscript (an element_at call),
function calls (the analyzer resolves the names it knows), window
functions `fn(...) OVER (PARTITION BY ... ORDER BY ... [ROWS | RANGE
frame])` and named `WINDOW` specs, and GROUP BY ROLLUP, CUBE and
GROUPING SETS, VALUES (a LocalRelation, as a query and in FROM) and JOIN
... USING. `parse_statement` also reads the commands (plan/commands.py):
CREATE [OR REPLACE] [TEMP] VIEW | TABLE ... AS, DROP VIEW | TABLE |
VARIABLE, INSERT INTO | OVERWRITE, UPDATE, DELETE, MERGE, SHOW TABLES |
FUNCTIONS [LIKE], DESCRIBE, EXPLAIN [EXTENDED | FORMATTED | ANALYZE],
DECLARE, SET [VARIABLE], ANALYZE TABLE and [UN]CACHE TABLE. Every other
production of the reference's grammar raises `NotPortedError` naming the
construct: table-valued functions and TABLESAMPLE among them. A function
argument may be a lambda, `x -> e` or `(x, y) -> e`.
"""

from __future__ import annotations

import datetime
import itertools

from ..errors import NotPortedError, ParseException
from ..expr import expressions as E
from ..expr.window import UnresolvedWindowExpression
from ..plan import logical as L
from ..plan.subquery import (
    Exists, InSubquery, ScalarSubquery, iter_plans, map_subquery_plans,
)
from ..types import (
    DataType, DecimalType, boolean, date, float32, float64, int8, int16,
    int32, int64, string, timestamp,
)
from .lexer import Token, tokenize


def parse_sql(text: str):
    """A query's LogicalPlan, or a command (plan/commands.py)."""
    p = Parser(tokenize(text))
    plan = p.parse_statement()
    p.expect_eof()
    return plan


def parse_expression(text: str) -> E.Expression:
    p = Parser(tokenize(text))
    e = p.parse_named_expression()
    p.expect_eof()
    return e


class Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0
        self._query_depth = 0  # WITH materialises only at the top level

    # --- token helpers ----------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:  # noqa: A003
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value.lower() in words

    def eat_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.eat_kw(word):
            raise ParseException(
                f"expected {word.upper()} near {self.peek().value!r}")

    def eat_word(self, word: str) -> bool:
        """Consume a statement word that is not a reserved keyword
        (ANALYZE, COMPUTE, STATISTICS, ... lex as plain identifiers)."""
        t = self.peek()
        if t.kind in ("kw", "ident") and t.value.lower() == word:
            self.next()
            return True
        return False

    def expect_word(self, word: str) -> None:
        if not self.eat_word(word):
            raise ParseException(
                f"expected {word.upper()} near {self.peek().value!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise ParseException(
                f"expected {op!r} near {self.peek().value!r} "
                f"(pos {self.peek().pos})")

    def expect_eof(self) -> None:
        t = self.peek()
        if t.kind != "eof" and not (t.kind == "op" and t.value == ";"):
            raise ParseException(f"unexpected trailing input {t.value!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind in ("ident", "kw"):
            self.next()
            return t.value
        raise ParseException(f"expected identifier near {t.value!r}")

    # --- statements -------------------------------------------------------
    def parse_statement(self):
        from ..plan import commands as C

        if self.at_kw("with", "select", "values") or self.at_op("("):
            return self.parse_query()
        if self.eat_kw("create"):
            replace = False
            if self.eat_kw("or"):
                self.expect_kw("replace")
                replace = True
            while self.peek().value.lower() in ("global", "temporary", "temp"):
                self.next()
            materialize = False
            if self.eat_kw("view"):
                pass
            elif self.eat_kw("table"):
                materialize = True
            else:
                raise ParseException("expected VIEW or TABLE")
            name = self._qualified_name()
            self.expect_kw("as")
            q = self.parse_query()
            return C.CreateViewCommand(name, q, replace=replace or True,
                                       materialize=materialize)
        if self.eat_kw("drop"):
            self.eat_word("temporary")
            if self.peek().value.lower() in ("variable", "var"):
                self.next()
                if_exists = False
                if self.eat_word("if"):
                    self.expect_word("exists")
                    if_exists = True
                return C.DropVariableCommand(self.ident(), if_exists)
            if not (self.eat_kw("view") or self.eat_kw("table")):
                raise ParseException("expected VIEW or TABLE")
            if_exists = False
            if self.peek().value.lower() == "if":
                self.next()
                self.expect_kw("exists")
                if_exists = True
            return C.DropRelationCommand(self._qualified_name(), if_exists)
        if self.eat_kw("insert"):
            overwrite = False
            if self.peek().value.lower() == "overwrite":
                self.next()
                overwrite = True
                self.eat_kw("table")
            else:
                self.expect_kw("into")
                self.eat_kw("table")
            name = self._qualified_name()
            q = self.parse_query()
            return C.InsertIntoCommand(name, q, overwrite)
        if self.eat_kw("update"):
            name = self._qualified_name()
            self.expect_kw("set")
            assigns = [self._parse_assignment()]
            while self.eat_op(","):
                assigns.append(self._parse_assignment())
            cond = self.parse_expr() if self.eat_kw("where") else None
            return C.UpdateCommand(name, assigns, cond)
        if self.eat_kw("delete"):
            self.expect_kw("from")
            name = self._qualified_name()
            cond = self.parse_expr() if self.eat_kw("where") else None
            return C.DeleteCommand(name, cond)
        if self.eat_kw("merge"):
            return self._parse_merge()
        if self.eat_kw("show"):
            if self.eat_word("functions"):
                pattern = None
                if self.eat_kw("like"):
                    t = self.next()
                    if t.kind != "str":
                        raise ParseException(
                            "SHOW FUNCTIONS LIKE expects a string "
                            f"literal, got {t.value!r}")
                    pattern = str(t.value)
                return C.ShowFunctionsCommand(pattern)
            self.expect_kw("tables")
            return C.ShowTablesCommand()
        if self.eat_kw("describe"):
            self.eat_kw("table")
            return C.DescribeCommand(self._qualified_name())
        if self.eat_kw("explain"):
            mode = self.peek().value.lower()
            analyze = mode == "analyze"
            extended = mode in ("extended", "formatted")
            if analyze or extended:
                self.next()
            return C.ExplainCommand(self.parse_query(), extended, analyze)
        if self.peek().value.lower() == "declare":
            self.next()
            replace = False
            if self.eat_word("or"):
                self.expect_word("replace")
                replace = True
            self.eat_word("variable") or self.eat_word("var")
            name = self.ident()
            dtype = None
            if self.peek().kind in ("ident", "kw") and \
                    self.peek().value.lower() != "default":
                dtype = self.parse_type()
            default = None
            if self.eat_word("default") or self.eat_op("="):
                default = self.parse_expr()
            return C.DeclareVariableCommand(name, dtype, default,
                                            replace=replace)
        if self.peek().value.lower() == "analyze":
            self.next()
            self.expect_word("table")
            name = self._qualified_name()
            self.expect_word("compute")
            self.expect_word("statistics")
            columns = None
            if self.eat_word("for"):
                if self.eat_word("all"):
                    self.expect_word("columns")
                else:
                    self.expect_word("columns")
                    columns = [self.ident()]
                    while self.eat_op(","):
                        columns.append(self.ident())
            return C.AnalyzeTableCommand(name, columns)
        if self.peek().value.lower() == "cache":
            self.next()
            self.expect_kw("table")
            return C.CacheTableCommand(self._qualified_name())
        if self.peek().value.lower() == "uncache":
            self.next()
            self.expect_kw("table")
            return C.CacheTableCommand(self._qualified_name(), uncache=True)
        if self.peek().value.lower() == "set":
            self.next()
            if self.peek().kind == "eof":
                return C.SetCommand(None, None)
            if self.peek().value.lower() in ("variable", "var"):
                self.next()
                name = self.ident()
                self.expect_op("=")
                return C.SetVariableCommand(name, self.parse_expr())
            key = self._conf_key()
            value = None
            if self.eat_op("="):
                parts = []
                while self.peek().kind != "eof" and not self.at_op(";"):
                    parts.append(self.next().value)
                value = " ".join(parts)
            return C.SetCommand(key, value)
        raise ParseException(
            f"unsupported statement near {self.peek().value!r}")

    def _parse_assignment(self):
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        self.expect_op("=")
        return (parts[-1], self.parse_expr())

    def _parse_merge(self):
        from ..plan import commands as C

        self.expect_kw("into")
        name = self._qualified_name()
        talias = self._maybe_alias() or name.split(".")[-1]
        target = L.SubqueryAlias(talias,
                                 L.UnresolvedRelation(name.split(".")))
        self.expect_kw("using")
        source = self.parse_relation_primary()
        self.expect_kw("on")
        cond = self.parse_expr()
        matched, not_matched = [], []
        while self.eat_kw("when"):
            neg = self.eat_kw("not")
            self.expect_kw("matched")
            extra = self.parse_expr() if self.eat_kw("and") else None
            self.expect_kw("then")
            if neg:
                self.expect_kw("insert")
                if self.at_op("*"):
                    self.next()
                    not_matched.append(C.MergeClause(
                        "insert", extra, insert_star=True))
                else:
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.eat_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    self.expect_kw("values")
                    self.expect_op("(")
                    vals = [self.parse_expr()]
                    while self.eat_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    not_matched.append(C.MergeClause(
                        "insert", extra, insert_cols=cols,
                        insert_vals=vals))
            elif self.eat_kw("delete"):
                matched.append(C.MergeClause("delete", extra))
            else:
                self.expect_kw("update")
                self.expect_kw("set")
                assigns = [self._parse_assignment()]
                while self.eat_op(","):
                    assigns.append(self._parse_assignment())
                matched.append(C.MergeClause("update", extra,
                                             assignments=assigns))
        return C.MergeCommand(name, target, source, cond, matched,
                              not_matched)

    def _qualified_name(self) -> str:
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    def _conf_key(self) -> str:
        parts = [self.next().value]
        while self.at_op("."):
            self.next()
            parts.append(self.next().value)
        return ".".join(parts)

    def parse_query(self) -> L.LogicalPlan:
        depth = self._query_depth
        self._query_depth = depth + 1
        try:
            defs: list[tuple[str, L.LogicalPlan]] = []
            if self.eat_kw("with"):
                while True:
                    name = self.ident()
                    self.eat_kw("as")
                    self.expect_op("(")
                    defs.append((name, self.parse_query()))
                    self.expect_op(")")
                    if not self.eat_op(","):
                        break
            plan = self.parse_set_expr()
            plan = self._order_limit(plan)
            if defs:
                plan = _apply_ctes(plan, defs, top_level=(depth == 0))
            return plan
        finally:
            self._query_depth = depth

    def parse_set_expr(self) -> L.LogicalPlan:
        left = self.parse_term_query()
        while self.at_kw("union", "intersect", "minus", "except"):
            op = self.next().value.lower()
            distinct = True
            if self.eat_kw("all"):
                distinct = False
            else:
                self.eat_kw("distinct")
            right = self.parse_term_query()
            if op == "union":
                left = L.Union([left, right])
                if distinct:
                    left = L.Distinct(left)
            elif op == "intersect":
                left = L.Intersect(left, right)
            else:  # except / minus
                left = L.Except(left, right)
        return left

    def parse_term_query(self) -> L.LogicalPlan:
        if self.eat_op("("):
            q = self.parse_query()
            self.expect_op(")")
            return q
        if self.at_kw("values"):
            return self.parse_values()
        return self.parse_select()

    def parse_values(self) -> L.LogicalPlan:
        """VALUES (..), (..): a LocalRelation of columns col1, col2, ...
        whose entries must fold to constants."""
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.parse_expr()]
            while self.eat_op(","):
                row.append(self.parse_expr())
            self.expect_op(")")
            rows.append(row)
            if not self.eat_op(","):
                break
        import pyarrow as pa

        from ..plan.optimizer import const_value
        from ..types import from_arrow_type

        cols = {}
        for c in range(len(rows[0])):
            vals = []
            for r in rows:
                ok, v = const_value(r[c])
                if not ok:
                    raise ParseException("VALUES entries must be literals")
                vals.append(v)
            cols[f"col{c + 1}"] = vals
        table = pa.table(cols)
        attrs = [E.AttributeReference(f.name, from_arrow_type(f.type), True)
                 for f in table.schema]
        return L.LocalRelation(attrs, table)

    def parse_select(self) -> L.LogicalPlan:
        self.expect_kw("select")
        distinct = False
        if self.eat_kw("distinct"):
            distinct = True
        else:
            self.eat_kw("all")
        select_list = [self.parse_named_expression()]
        while self.eat_op(","):
            select_list.append(self.parse_named_expression())

        plan: L.LogicalPlan
        if self.eat_kw("from"):
            plan = self.parse_relation()
            while self.eat_op(","):
                right = self.parse_relation()
                plan = L.Join(plan, right, "cross", None)
        else:
            plan = L.OneRowRelation()

        if self.eat_kw("where"):
            plan = L.Filter(self.parse_expr(), plan)

        group_exprs = None
        grouping_sets: list[list[int]] | None = None
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            if self.at_kw("rollup", "cube"):
                kind = self.next().value.lower()
                self.expect_op("(")
                group_exprs = [self.parse_expr()]
                while self.eat_op(","):
                    group_exprs.append(self.parse_expr())
                self.expect_op(")")
                n = len(group_exprs)
                if kind == "rollup":
                    grouping_sets = [list(range(n - i)) for i in range(n + 1)]
                else:  # cube: every subset
                    grouping_sets = [list(c) for k in range(n, -1, -1)
                                     for c in itertools.combinations(range(n),
                                                                     k)]
            elif self.at_kw("grouping"):
                self.next()
                if self.peek().value.lower() != "sets":
                    raise ParseException("expected SETS after GROUPING")
                self.next()
                self.expect_op("(")
                group_exprs, grouping_sets = [], []
                index: dict[str, int] = {}
                while True:
                    self.expect_op("(")
                    one: list[int] = []
                    if not self.at_op(")"):
                        while True:
                            e = self.parse_expr()
                            key = e.simple_string()
                            if key not in index:
                                index[key] = len(group_exprs)
                                group_exprs.append(e)
                            one.append(index[key])
                            if not self.eat_op(","):
                                break
                    self.expect_op(")")
                    grouping_sets.append(one)
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            else:
                group_exprs = [self.parse_expr()]
                while self.eat_op(","):
                    group_exprs.append(self.parse_expr())

        having = None
        if self.eat_kw("having"):
            having = self.parse_expr()

        # WINDOW w AS (spec) [, w2 AS (spec)]*: named specs substitute into
        # the `fn() OVER w` placeholders
        if self.peek().kind == "ident" and \
                self.peek().value.lower() == "window":
            self.next()
            specs: dict[str, tuple] = {}
            while True:
                wname = self.ident().lower()
                self.expect_kw("as")
                specs[wname] = self._parse_window_spec()
                if not self.eat_op(","):
                    break

            def _sub(e):
                if isinstance(e, UnresolvedWindowExpression) and \
                        e.ref_name is not None:
                    spec = specs.get(e.ref_name.lower())
                    if spec is None:
                        raise ParseException(
                            f"undefined window: {e.ref_name}")
                    return UnresolvedWindowExpression(e.function, *spec)
                return e

            select_list = [e.transform_up(_sub) for e in select_list]

        has_agg = any(_contains_agg(e) for e in select_list)
        if group_exprs is not None or has_agg or having is not None:
            # GROUP BY ordinals
            resolved_groups = []
            for g in group_exprs or []:
                if isinstance(g, E.Literal) and isinstance(g.value, int):
                    idx = g.value - 1
                    if not (0 <= idx < len(select_list)):
                        raise ParseException(f"GROUP BY position {g.value}")
                    tgt = select_list[idx]
                    resolved_groups.append(
                        tgt.child if isinstance(tgt, E.Alias) else tgt)
                else:
                    resolved_groups.append(g)
            if grouping_sets is not None:
                plan = L.GroupingSets(grouping_sets, resolved_groups,
                                      list(select_list), plan)
            else:
                plan = L.Aggregate(resolved_groups, list(select_list), plan)
            if having is not None:
                plan = L.Filter(having, plan)
        else:
            plan = L.Project(list(select_list), plan)
        if distinct:
            plan = L.Distinct(plan)
        return plan

    def _order_limit(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            orders = [self.parse_sort_item(plan)]
            while self.eat_op(","):
                orders.append(self.parse_sort_item(plan))
            plan = L.Sort(orders, True, plan)
        if self.eat_kw("limit"):
            t = self.next()
            if t.kind != "num":
                raise ParseException("LIMIT expects a number")
            plan = L.Limit(int(t.value.rstrip("LlDdSs")), plan)
        if self.eat_kw("offset"):
            t = self.next()
            if t.kind != "num":
                raise ParseException("OFFSET expects a number")
            plan = L.Offset(int(t.value.rstrip("LlDdSs")), plan)
        return plan

    def parse_sort_item(self, plan) -> E.SortOrder:
        e = self.parse_expr()
        # ORDER BY ordinal
        if isinstance(e, E.Literal) and isinstance(e.value, int) and \
                isinstance(plan, (L.Project, L.Aggregate)):
            lst = plan.project_list if isinstance(plan, L.Project) \
                else plan.aggregate_exprs
            idx = e.value - 1
            if 0 <= idx < len(lst):
                tgt = lst[idx]
                if isinstance(tgt, E.Alias):
                    e = E.UnresolvedAttribute([tgt.name])
                elif isinstance(tgt, (E.AttributeReference,
                                      E.UnresolvedAttribute)):
                    e = tgt
        asc = True
        if self.eat_kw("desc"):
            asc = False
        else:
            self.eat_kw("asc")
        nulls_first = None
        if self.eat_kw("nulls"):
            if self.eat_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return E.SortOrder(e, asc, nulls_first)

    # --- relations --------------------------------------------------------
    def parse_relation(self) -> L.LogicalPlan:
        left = self.parse_relation_primary()
        while True:
            jt = self._join_type()
            if jt is None:
                return left
            right = self.parse_relation_primary()
            cond = None
            using = None
            if self.eat_kw("on"):
                cond = self.parse_expr()
            elif self.eat_kw("using"):
                self.expect_op("(")
                using = [self.ident()]
                while self.eat_op(","):
                    using.append(self.ident())
                self.expect_op(")")
            if using is not None:
                left = L.UsingJoin(left, right, jt, using)
            else:
                left = L.Join(left, right, jt, cond)

    def _join_type(self) -> str | None:
        if self.eat_kw("cross"):
            self.expect_kw("join")
            return "cross"
        if self.at_kw("join"):
            self.next()
            return "inner"
        if self.eat_kw("inner"):
            self.expect_kw("join")
            return "inner"
        for side in ("left", "right", "full"):
            if self.at_kw(side):
                self.next()
                if side == "left" and self.eat_kw("semi"):
                    self.expect_kw("join")
                    return "left_semi"
                if side == "left" and self.eat_kw("anti"):
                    self.expect_kw("join")
                    return "left_anti"
                self.eat_kw("outer")
                self.expect_kw("join")
                return {"left": "left_outer", "right": "right_outer",
                        "full": "full_outer"}[side]
        if self.peek().kind == "ident" and \
                self.peek().value.lower() in ("lateral", "natural",
                                              "pivot", "unpivot"):
            raise NotPortedError(f"{self.peek().value.upper()} in FROM")
        return None

    def parse_relation_primary(self) -> L.LogicalPlan:
        if self.eat_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            alias = self._maybe_alias()
            if alias:
                return L.SubqueryAlias(alias, sub)
            return sub
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        if self.at_op("("):
            raise NotPortedError(f"table-valued function {parts[-1]}")
        plan: L.LogicalPlan = L.UnresolvedRelation(parts)
        if self.peek().value.lower() == "tablesample":
            raise NotPortedError("TABLESAMPLE")
        alias = self._maybe_alias()
        if alias:
            return L.SubqueryAlias(alias, plan)
        return plan

    # soft keywords that begin a clause and therefore can't be a bare
    # relation alias (WINDOW w AS ..., LATERAL VIEW, PIVOT ...)
    _NON_ALIAS_IDENTS = frozenset(("window", "lateral", "pivot", "unpivot"))

    def _maybe_alias(self) -> str | None:
        if self.eat_kw("as"):
            return self.ident()
        t = self.peek()
        if t.kind == "ident" and t.value.lower() not in self._NON_ALIAS_IDENTS:
            self.next()
            return t.value
        return None

    # --- expressions ------------------------------------------------------
    def parse_named_expression(self) -> E.Expression:
        if self.at_op("*"):
            self.next()
            return E.UnresolvedStar()
        # qualified star: t.*
        if self.peek().kind in ("ident",) and self.peek(1).value == "." and \
                self.peek(2).value == "*":
            target = self.ident()
            self.next()  # .
            self.next()  # *
            return E.UnresolvedStar(target)
        e = self.parse_expr()
        if self.eat_kw("as"):
            return E.Alias(e, self.ident())
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return E.Alias(e, t.value)
        return e

    def parse_expr(self) -> E.Expression:
        return self.parse_or()

    def parse_or(self) -> E.Expression:
        left = self.parse_and()
        while self.eat_kw("or"):
            left = E.Or(left, self.parse_and())
        return left

    def parse_and(self) -> E.Expression:
        left = self.parse_not()
        while self.eat_kw("and"):
            left = E.And(left, self.parse_not())
        return left

    def parse_not(self) -> E.Expression:
        if self.eat_kw("not"):
            return E.Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> E.Expression:
        left = self.parse_bitwise_or()
        while True:
            if self.at_op("=", "==", "<>", "!=", "<", "<=", ">", ">=",
                          "<=>"):
                op = self.next().value
                right = self.parse_bitwise_or()
                cls = {"=": E.EqualTo, "==": E.EqualTo, "<>": E.NotEqualTo,
                       "!=": E.NotEqualTo, "<": E.LessThan,
                       "<=": E.LessThanOrEqual, ">": E.GreaterThan,
                       ">=": E.GreaterThanOrEqual,
                       "<=>": E.EqualNullSafe}[op]
                left = cls(left, right)
                continue
            if self.at_kw("is"):
                self.next()
                neg = self.eat_kw("not")
                self.expect_kw("null")
                left = E.IsNotNull(left) if neg else E.IsNull(left)
                continue
            neg = False
            save = self.i
            if self.eat_kw("not"):
                neg = True
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    sub = self.parse_query()
                    self.expect_op(")")
                    left = InSubquery(left, sub)
                    if neg:
                        left = E.Not(left)
                    continue
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                left = E.In(left, items)
                if neg:
                    left = E.Not(left)
                continue
            if self.eat_kw("like"):
                pat = self.next()
                if pat.kind != "str":
                    raise ParseException("LIKE expects a string literal")
                left = E.Like(left, pat.value)
                if neg:
                    left = E.Not(left)
                continue
            if self.eat_kw("rlike"):
                pat = self.next()
                left = E.RLike(left, pat.value)
                if neg:
                    left = E.Not(left)
                continue
            if self.eat_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                left = E.And(E.GreaterThanOrEqual(left, lo),
                             E.LessThanOrEqual(left, hi))
                if neg:
                    left = E.Not(left)
                continue
            if neg:
                self.i = save
            break
        return left

    # the reference's precedence, loosest first: | ^ & (<< >>) (+ - ||)
    # (* / % DIV) unary
    def parse_bitwise_or(self) -> E.Expression:
        left = self.parse_bitwise_xor()
        while self.at_op("|"):
            self.next()
            left = E.BitwiseOr(left, self.parse_bitwise_xor())
        return left

    def parse_bitwise_xor(self) -> E.Expression:
        left = self.parse_bitwise_and()
        while self.at_op("^"):
            self.next()
            left = E.BitwiseXor(left, self.parse_bitwise_and())
        return left

    def parse_bitwise_and(self) -> E.Expression:
        left = self.parse_shift()
        while self.at_op("&"):
            self.next()
            left = E.BitwiseAnd(left, self.parse_shift())
        return left

    def parse_shift(self) -> E.Expression:
        left = self.parse_additive()
        while self.at_op("<<", ">>"):
            op = self.next().value
            right = self.parse_additive()
            left = E.ShiftLeft(left, right) if op == "<<" \
                else E.ShiftRight(left, right)
        return left

    def parse_additive(self) -> E.Expression:
        left = self.parse_multiplicative()
        while self.at_op("+", "-") or self.at_op("||"):
            op = self.next().value
            right = self.parse_multiplicative()
            if op == "+":
                left = E.Add(left, right)
            elif op == "-":
                left = E.Subtract(left, right)
            else:
                left = E.Concat([left, right])
        return left

    def parse_multiplicative(self) -> E.Expression:
        left = self.parse_unary()
        while self.at_op("*", "/", "%") or self.at_kw("div"):
            if self.eat_kw("div"):
                # a DIV b: the quotient as a double, cast to bigint (as the
                # reference parses it)
                right = self.parse_unary()
                left = E.Cast(E.Divide(left, right), int64)
                continue
            op = self.next().value
            right = self.parse_unary()
            cls = {"*": E.Multiply, "/": E.Divide, "%": E.Remainder}[op]
            left = cls(left, right)
        return left

    def parse_unary(self) -> E.Expression:
        if self.eat_op("-"):
            e = self.parse_unary()
            if isinstance(e, E.Literal) and isinstance(e.value, (int, float)):
                return E.Literal(-e.value)
            return E.UnaryMinus(e)
        if self.eat_op("+"):
            return self.parse_unary()
        if self.eat_op("~"):
            return E.BitwiseNot(self.parse_unary())
        e = self.parse_primary()
        # subscript: col[key] -> element_at (a map value, an array element)
        while self.eat_op("["):
            key = self.parse_expr()
            self.expect_op("]")
            e = E.UnresolvedFunction("element_at", [e, key], False)
        return e

    def parse_primary(self) -> E.Expression:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return _num_literal(t.value)
        if t.kind == "str":
            self.next()
            return E.Literal(t.value)
        if self.at_kw("true"):
            self.next()
            return E.Literal(True)
        if self.at_kw("false"):
            self.next()
            return E.Literal(False)
        if self.at_kw("null"):
            self.next()
            return E.Literal(None)
        if self.at_kw("date"):
            save = self.i
            self.next()
            if self.peek().kind == "str":
                s = self.next().value
                return E.Literal(datetime.date.fromisoformat(s.strip()[:10]))
            self.i = save
        if self.at_kw("timestamp") and self.peek(1).kind == "str":
            self.next()
            return E.Literal(_parse_ts_literal(self.next().value))
        if self.at_kw("interval"):
            return self.parse_interval()
        if self.at_kw("case"):
            return self.parse_case()
        if self.at_kw("cast"):
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            to = self.parse_type()
            self.expect_op(")")
            return E.Cast(e, to, explicit=True)
        if t.kind == "ident" and t.value.lower() == "try_cast" and \
                self.peek(1).value == "(":
            # try_cast: NULL where the value does not convert, which every
            # cast of the port already gives
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            to = self.parse_type()
            self.expect_op(")")
            return E.Cast(e, to, explicit=True)
        if self.at_kw("exists") and self.peek(1).value == "(" and \
                (self.peek(2).value == "(" or
                 (self.peek(2).kind == "kw" and
                  self.peek(2).value.lower() in ("select", "with",
                                                 "values"))):
            self.next()
            self.expect_op("(")
            sub = self.parse_query()
            self.expect_op(")")
            return Exists(sub)
        if self.eat_op("("):
            if self.at_kw("select", "with"):
                sub = self.parse_query()
                self.expect_op(")")
                return ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "kw"):
            # function call or column reference
            name = self.ident()
            if name.lower() == "extract" and self.at_op("("):
                return self.parse_extract()
            if self.at_op("("):
                f = self.parse_function(name)
                # struct field access on a function's result:
                # named_struct(...).a.b
                while self.at_op(".") and \
                        self.peek(1).kind in ("ident", "kw"):
                    self.next()
                    f = E.GetStructField(f, self.ident())
                return f
            parts = [name]
            while self.at_op(".") and self.peek(1).kind in ("ident", "kw"):
                self.next()
                parts.append(self.ident())
            return E.UnresolvedAttribute(parts)
        raise ParseException(f"unexpected token {t.value!r} at {t.pos}")

    def parse_function(self, name: str) -> E.Expression:
        low = name.lower()
        self.expect_op("(")
        distinct = False
        args: list[E.Expression] = []
        if self.at_op("*"):
            self.next()
            args = [E.UnresolvedStar()]
        elif not self.at_op(")"):
            if self.eat_kw("distinct"):
                distinct = True
            if low == "position":
                # position(substr IN str): parsed below the predicates, so
                # the IN is this form's and not an IN list; the arguments
                # in the order of position(substr, str)
                args.append(self.parse_bitwise_or())
                if self.eat_kw("in"):
                    args.append(self.parse_expr())
                while self.eat_op(","):
                    args.append(self.parse_expr())
            else:
                args.append(self._parse_arg())
                if low == "overlay" and self.peek().value.lower() == "placing":
                    # overlay(str PLACING repl FROM pos [FOR len]), in the
                    # order of overlay(str, repl, pos[, len])
                    self.next()
                    args.append(self.parse_expr())
                    self.expect_kw("from")
                    args.append(self.parse_expr())
                    if self.peek().value.lower() == "for":
                        self.next()
                        args.append(self.parse_expr())
                else:
                    while self.eat_op(","):
                        args.append(self._parse_arg())
        self.expect_op(")")
        func = E.UnresolvedFunction(name, args, distinct)
        if self.at_kw("over"):
            return self.parse_over(func)
        return func

    def parse_over(self, func: E.Expression) -> E.Expression:
        self.expect_kw("over")
        if not self.at_op("("):
            # OVER w: a named window, its spec substituted from the WINDOW
            # clause
            return UnresolvedWindowExpression(func, [], [], None,
                                              ref_name=self.ident())
        return UnresolvedWindowExpression(func, *self._parse_window_spec())

    def _parse_window_spec(self):
        self.expect_op("(")
        partition: list[E.Expression] = []
        orders: list[E.SortOrder] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.eat_op(","):
                partition.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            orders.append(self.parse_sort_item(None))
            while self.eat_op(","):
                orders.append(self.parse_sort_item(None))
        frame = None
        if self.at_kw("rows", "range"):
            ftype = self.next().value.lower()
            if self.eat_kw("between"):
                lo = self._parse_frame_bound()
                self.expect_kw("and")
                hi = self._parse_frame_bound()
            else:
                lo = self._parse_frame_bound()
                hi = 0  # CURRENT ROW
            if ftype == "range":
                if (lo, hi) == (None, 0):
                    frame = None  # the default frame
                elif (lo, hi) == (None, None):
                    frame = ("rows", None, None)  # the whole partition
                else:
                    frame = ("vrange", lo, hi)  # value offsets
            else:
                frame = ("rows", lo, hi)
        self.expect_op(")")
        return partition, orders, frame

    def _parse_frame_bound(self):
        """A row offset: None = unbounded, 0 = current row, -n preceding,
        +n following."""
        if self.eat_kw("unbounded"):
            if not (self.eat_kw("preceding") or self.eat_kw("following")):
                raise ParseException("bad frame bound")
            return None
        if self.eat_kw("current"):
            self.expect_kw("row")
            return 0
        t = self.next()
        if t.kind != "num":
            raise ParseException("bad frame bound")
        n = int(t.value.rstrip("LlDdSs"))
        if self.eat_kw("preceding"):
            return -n
        if self.eat_kw("following"):
            return n
        raise ParseException("bad frame bound")

    def parse_interval(self) -> E.Expression:
        """INTERVAL [-]n unit [n unit ...], with quoted or bare numbers."""
        self.expect_kw("interval")
        months = days = micros = 0
        saw = False
        while True:
            sign = 1
            # only a '-' that introduces another signed component: in
            # `interval '2' day - interval '1' day` the minus belongs to
            # the enclosing subtraction
            if self.at_op("-") and self.peek(1).kind in ("num", "str"):
                self.next()
                sign = -1
            t = self.peek()
            if t.kind == "num":
                self.next()
                n = sign * int(float(t.value.rstrip("LlDdSs")))
            elif t.kind == "str":
                self.next()
                n = sign * int(float(t.value))
            else:
                break
            unit = self.ident().lower().rstrip("s")
            if unit == "year":
                months += 12 * n
            elif unit == "month":
                months += n
            elif unit == "week":
                days += 7 * n
            elif unit == "day":
                days += n
            elif unit == "hour":
                micros += n * 3_600_000_000
            elif unit == "minute":
                micros += n * 60_000_000
            elif unit == "second":
                micros += n * 1_000_000
            else:
                raise ParseException(f"unknown interval unit {unit}")
            saw = True
        if not saw:
            raise ParseException("empty INTERVAL literal")
        return E.IntervalLiteral(months, days, micros)

    def _parse_arg(self) -> E.Expression:
        """A function argument: `x -> body`, `(x, y) -> body` (a
        higher-order function's lambda, its parameters marked in the body
        by lexical scope), or a plain expression."""
        from ..expr.higher_order import LambdaFunction, mark_lambda_params

        t = self.peek()
        if t.kind in ("ident", "kw") and self.peek(1).value == "->":
            names = [self.ident()]
        elif self._at_lambda_params():
            self.expect_op("(")
            names = [self.ident()]
            while self.eat_op(","):
                names.append(self.ident())
            self.expect_op(")")
        else:
            return self.parse_expr()
        self.next()     # ->
        body = self.parse_expr()
        return LambdaFunction(names, mark_lambda_params(body, names))

    def _at_lambda_params(self) -> bool:
        """At `(x, y, ...) ->`: a lambda's parameter list."""
        if not self.at_op("("):
            return False
        k = 1
        while self.peek(k).kind in ("ident", "kw"):
            if self.peek(k + 1).value == ")":
                return self.peek(k + 2).value == "->"
            if self.peek(k + 1).value != ",":
                return False
            k += 2
        return False

    def parse_extract(self) -> E.Expression:
        """EXTRACT(field FROM d), the reference's fields over dates and
        timestamps."""
        self.expect_op("(")
        field = self.ident().lower()
        self.expect_kw("from")
        src = self.parse_expr()
        self.expect_op(")")
        mapping = {
            "year": E.Year, "month": E.Month, "day": E.DayOfMonth,
            "dayofmonth": E.DayOfMonth, "quarter": E.Quarter,
            "week": E.WeekOfYear, "doy": E.DayOfYear, "dow": E.DayOfWeek,
            "hour": E.Hour, "minute": E.Minute, "second": E.Second,
        }
        cls = mapping.get(field)
        if cls is None:
            raise ParseException(f"EXTRACT field {field} not supported")
        return cls(src)

    def parse_case(self) -> E.Expression:
        self.expect_kw("case")
        base = None
        if not self.at_kw("when"):
            base = self.parse_expr()
        branches = []
        while self.eat_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            if base is not None:
                cond = E.EqualTo(base, cond)
            branches.append((cond, val))
        els = None
        if self.eat_kw("else"):
            els = self.parse_expr()
        self.expect_kw("end")
        return E.CaseWhen(branches, els)

    # --- types ------------------------------------------------------------
    def parse_type(self) -> DataType:
        name = self.ident().lower()
        if name in ("int", "integer"):
            return int32
        if name in ("bigint", "long"):
            return int64
        if name in ("smallint", "short"):
            return int16
        if name in ("tinyint", "byte"):
            return int8
        if name in ("float", "real"):
            return float32
        if name == "double":
            return float64
        if name in ("string", "text"):
            return string
        if name in ("varchar", "char"):
            if self.eat_op("("):
                self.next()
                self.expect_op(")")
            return string
        if name in ("bool", "boolean"):
            return boolean
        if name == "date":
            return date
        if name == "timestamp":
            return timestamp
        if name in ("decimal", "numeric", "dec"):
            p, s = 10, 0
            if self.eat_op("("):
                p = int(self.next().value)
                if self.eat_op(","):
                    s = int(self.next().value)
                self.expect_op(")")
            return DecimalType(min(p, DecimalType.MAX_PRECISION), s)
        raise ParseException(f"unknown type {name}")


def _parse_ts_literal(s: str) -> datetime.datetime:
    s = s.strip().replace("T", " ")
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime.datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ParseException(f"bad timestamp literal {s!r}")


def _num_literal(text: str) -> E.Literal:
    if text[:2].lower() == "0x":
        v = int(text, 16)
        return E.Literal(v) if -(2 ** 31) <= v < 2 ** 31 \
            else E.Literal(v, int64)
    suffix = ""
    if text and text[-1] in "LlDdSs":
        suffix = text[-1].lower()
        text = text[:-1]
    if "." in text or "e" in text.lower() or suffix == "d":
        return E.Literal(float(text))
    v = int(text)
    if suffix == "l" or not (-(2 ** 31) <= v < 2 ** 31):
        return E.Literal(v, int64)
    return E.Literal(v)


_AGG_NAMES = frozenset((
    "sum", "count", "min", "max", "avg", "mean", "first", "any_value",
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "collect_set", "collect_list", "array_agg", "first_value", "median",
    "percentile",
    "percentile_approx", "corr", "covar_samp", "covar_pop", "skewness",
    "kurtosis", "approx_count_distinct"))


def _contains_agg(e: E.Expression) -> bool:
    if isinstance(e, UnresolvedWindowExpression):
        return False  # window aggregates are not grouping aggregates
    if isinstance(e, E.AggregateFunction):
        return True
    if isinstance(e, E.UnresolvedFunction) and e.fname.lower() in _AGG_NAMES:
        return True
    return any(_contains_agg(c) for c in e.children)


def _refresh_alias_ids(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Fresh expr_ids for every Alias in a parse-time subtree. CTE bodies
    splice into several call sites, and shared alias ids would collide once
    resolved (references are still by name before resolution, so only the
    ids need refreshing; DeduplicateRelations handles relation ids)."""

    def fresh(e: E.Expression) -> E.Expression:
        if isinstance(e, E.Alias):
            return E.Alias(e.child, e.name)  # new expr_id
        return e

    def go(node: L.LogicalPlan) -> L.LogicalPlan:
        node = node.map_children(go)
        return node.map_expressions(lambda ex: ex.transform_up(fresh))

    return go(plan)


def _count_cte_refs(plan: L.LogicalPlan, name: str) -> int:
    """Occurrences of UnresolvedRelation(name) in a plan, including inside
    subquery-expression plans (the scope _substitute_ctes rewrites)."""
    return sum(1 for p in iter_plans(plan) for node in p.iter_nodes()
               if isinstance(node, L.UnresolvedRelation)
               and node.name.lower() == name)


def _cte_expensive(plan: L.LogicalPlan) -> bool:
    """Worth materialising: two joins, or an aggregate over a join."""
    joins = sum(1 for n in plan.iter_nodes() if isinstance(n, L.Join))
    aggs = sum(1 for n in plan.iter_nodes() if isinstance(n, L.Aggregate))
    return joins >= 2 or (joins >= 1 and aggs >= 1)


def _apply_ctes(plan: L.LogicalPlan, defs: list,
                top_level: bool) -> L.LogicalPlan:
    """Inline single-use or cheap CTEs; turn expensive ones instantiated
    more than once into WithCTE materialisations (top-level queries only:
    a WithCTE inside a tree has no point of execution)."""
    import uuid as _uuid

    # effective instantiation count, later definitions first: a CTE read
    # from an inlined CTE body is instantiated once per instantiation of
    # that body; a materialised body runs once
    eff: dict[str, int] = {}
    mat: dict[str, bool] = {}
    for i in range(len(defs) - 1, -1, -1):
        name, body = defs[i]
        key = name.lower()
        cnt = _count_cte_refs(plan, key)
        for j in range(i + 1, len(defs)):
            jname, jbody = defs[j]
            jkey = jname.lower()
            mult = 1 if mat.get(jkey) else eff.get(jkey, 0)
            cnt += _count_cte_refs(jbody, key) * mult
        eff[key] = cnt
        mat[key] = bool(top_level and cnt >= 2 and _cte_expensive(body))

    ctes: dict[str, L.LogicalPlan] = {}
    materializations: list[tuple[str, L.LogicalPlan]] = []
    for name, body in defs:
        key = name.lower()
        body = _substitute_ctes(body, ctes)  # earlier CTEs visible
        if mat[key]:
            uniq = f"__cte_mat_{key}_{_uuid.uuid4().hex[:8]}"
            materializations.append((uniq, body))
            ctes[key] = L.SubqueryAlias(name, L.UnresolvedRelation([uniq]))
        else:
            ctes[key] = L.SubqueryAlias(name, body)
    plan = _substitute_ctes(plan, ctes)
    if materializations:
        plan = L.WithCTE(materializations, plan)
    return plan


def _substitute_ctes(plan: L.LogicalPlan,
                     ctes: dict[str, L.LogicalPlan]) -> L.LogicalPlan:
    def rule(node):
        if isinstance(node, L.UnresolvedRelation):
            hit = ctes.get(node.name.lower())
            if hit is not None:
                return _refresh_alias_ids(hit)
        # CTEs are visible inside subquery expressions too: q1 reads its
        # CTE in a correlated scalar subquery
        return map_subquery_plans(node, lambda p: _substitute_ctes(p, ctes))

    return plan.transform_up(rule)
