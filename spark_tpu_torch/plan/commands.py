"""SQL commands (counterpart of `spark_tpu/plan/commands.py`, copied): DDL,
DML and utility statements. A command runs eagerly in `session.sql` and
returns its result rows as a DataFrame over a LocalRelation.

DML is set-based, as in the reference: DELETE, UPDATE and MERGE run their
queries through the session's planner and compile tiers like any query,
collect the new table to Arrow and register it in the target's place
(`_write_target`). MERGE's cardinality check and its delete filter run on
that collected result, on the host. Replacing or dropping a view lets its
old table's ingested tiles go (physical/operators.py LocalTableScanExec).

CACHE TABLE, UNCACHE TABLE and EXPLAIN ANALYZE raise NotPortedError: the
block store, the persistent result cache and the phase-time and metrics
snapshot they need are ROADMAP.md A12.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .logical import LogicalPlan


class Command:
    """Marker base; session.sql dispatches on these."""


@dataclass
class CreateViewCommand(Command):
    name: str
    query: LogicalPlan
    replace: bool = True
    materialize: bool = False  # True for CREATE TABLE ... AS


@dataclass
class DropRelationCommand(Command):
    name: str
    if_exists: bool = False


@dataclass
class ShowTablesCommand(Command):
    pass


@dataclass
class ShowFunctionsCommand(Command):
    """SHOW FUNCTIONS [LIKE 'pattern'] (FunctionRegistry listing)."""

    pattern: Optional[str] = None


@dataclass
class DescribeCommand(Command):
    name: str


@dataclass
class ExplainCommand(Command):
    query: LogicalPlan
    extended: bool = False
    analyze: bool = False


@dataclass
class CacheTableCommand(Command):
    name: str
    uncache: bool = False


@dataclass
class SetCommand(Command):
    key: Optional[str]
    value: Optional[str]


@dataclass
class DeclareVariableCommand(Command):
    """DECLARE [VARIABLE] name [type] [DEFAULT expr] (reference: SQL
    session variables, sqlcat CreateVariable + analysis
    ResolveSetVariable / ColumnResolutionHelper variable fallback)."""

    name: str
    dtype: Optional[object] = None      # DataType
    default_expr: Optional[object] = None  # Expression
    replace: bool = False


@dataclass
class SetVariableCommand(Command):
    name: str
    value_expr: object = None  # Expression


@dataclass
class DropVariableCommand(Command):
    name: str
    if_exists: bool = False


@dataclass
class AnalyzeTableCommand(Command):
    """ANALYZE TABLE t COMPUTE STATISTICS [FOR COLUMNS a, b | FOR ALL
    COLUMNS] (reference: AnalyzeTableCommand / AnalyzeColumnCommand,
    sqlx/command/AnalyzeColumnCommand.scala - row count + per-column
    ndv/min/max/nulls persisted for the CBO)."""

    name: str
    columns: Optional[list] = None  # None -> all columns


@dataclass
class InsertIntoCommand(Command):
    name: str
    query: LogicalPlan
    overwrite: bool = False


@dataclass
class UpdateCommand(Command):
    """UPDATE t SET c = e, ... [WHERE cond] (reference: v2 DML,
    sqlcat/plans/logical/v2Commands.scala UpdateTable) - executed
    set-based: one projection `IF(cond, new, old)` per column, then the
    target table is rewritten."""

    name: str
    assignments: list  # [(column_name, Expression)]
    condition: object = None


@dataclass
class DeleteCommand(Command):
    """DELETE FROM t [WHERE cond] (reference: DeleteFromTable)."""

    name: str
    condition: object = None


@dataclass
class MergeClause:
    kind: str                 # "update" | "delete" | "insert"
    extra: object = None      # additional AND condition
    assignments: list = field(default_factory=list)
    insert_cols: list = field(default_factory=list)
    insert_vals: list = field(default_factory=list)
    insert_star: bool = False


@dataclass
class MergeCommand(Command):
    """MERGE INTO target USING source ON cond WHEN ... (reference:
    MergeIntoTable). Set-based: matched rows rewrite via a left_outer
    join against the source, unmatched source rows insert via left_anti."""

    name: str
    target: LogicalPlan
    source: LogicalPlan
    condition: object
    matched: list          # [MergeClause] kind update/delete
    not_matched: list      # [MergeClause] kind insert


def run_command(session, cmd: Command):
    """Execute a command; returns a DataFrame of result rows."""
    import pyarrow as pa

    from ..api.dataframe import DataFrame
    from ..errors import AnalysisException
    from .logical import WithCTE

    # a command's embedded query (CTAS/INSERT/EXPLAIN/MERGE source) can
    # carry WithCTE materializations - resolve them the same way
    # session.sql does for plain queries, or analysis would hit the
    # unresolved __cte_mat_* placeholder relations
    for fname, val in list(vars(cmd).items()):
        if isinstance(val, WithCTE):
            setattr(cmd, fname, session._materialize_ctes(val))

    def df_of(table: pa.Table) -> DataFrame:
        return session.createDataFrame(table)

    from ..errors import NotPortedError

    if isinstance(cmd, CacheTableCommand):
        raise NotPortedError(
            f"{'UNCACHE' if cmd.uncache else 'CACHE'} TABLE (the block "
            "store and result cache, A12)")
    if isinstance(cmd, ExplainCommand) and cmd.analyze:
        raise NotPortedError("EXPLAIN ANALYZE (its phase times and "
                             "metrics snapshot, A12)")

    if isinstance(cmd, CreateViewCommand):
        if not cmd.replace and session.catalog.tableExists(cmd.name):
            raise AnalysisException(
                f"Temp view {cmd.name} already exists",
                error_class="TEMP_TABLE_OR_VIEW_ALREADY_EXISTS")
        plan = cmd.query
        if not cmd.materialize:
            # a plan-stored view must not reference itself - resolution
            # would recurse forever (reference: CheckAnalysis
            # RECURSIVE_VIEW; Spark prohibits v AS SELECT ... FROM v).
            # Subquery-expression plans count too (… WHERE x IN
            # (SELECT … FROM v)).
            from ..plan.subquery import SubqueryExpression
            from .logical import UnresolvedRelation as _UR

            full = cmd.name.lower()

            def check_plan(p):
                for n in p.iter_nodes():
                    # exact-name match only: salesdb.v inside view v is a
                    # DIFFERENT relation, not a self-reference
                    if isinstance(n, _UR) and \
                            ".".join(n.name_parts).lower() == full:
                        raise AnalysisException(
                            f"Recursive view {cmd.name} detected: the "
                            "view body references the view itself",
                            error_class="RECURSIVE_VIEW")
                    for e in n.expressions():
                        for x in e.iter_nodes():
                            if isinstance(x, SubqueryExpression):
                                check_plan(x.plan)

            check_plan(plan)
        if cmd.materialize:
            df = DataFrame(session, plan)
            table = df.toArrow()
            wh = session.catalog_.external
            if wh is not None:
                # managed table in the warehouse
                wh.save_table(cmd.name, table,
                              mode="overwrite" if cmd.replace else "error")
                return df_of(pa.table({"result": pa.array([], pa.string())}))
            attrs = list(df.query_execution.analyzed.output)
            from .logical import LocalRelation

            plan = LocalRelation(attrs, table)
        session.catalog_.register(cmd.name, plan)
        return df_of(pa.table({"result": pa.array([], pa.string())}))

    if isinstance(cmd, DropRelationCommand):
        dropped = session.catalog_.drop(cmd.name)
        if not dropped and session.catalog_.external is not None:
            dropped = session.catalog_.external.drop_table(cmd.name)
        if not dropped and not cmd.if_exists:
            raise AnalysisException(
                f"Table or view not found: {cmd.name}",
                error_class="TABLE_OR_VIEW_NOT_FOUND")
        return df_of(pa.table({"result": pa.array([], pa.string())}))

    if isinstance(cmd, InsertIntoCommand):
        df = DataFrame(session, cmd.query)
        table = df.toArrow()
        wh = session.catalog_.external
        if wh is not None and cmd.name in wh.list_tables():
            target = wh.lookup(cmd.name)
            names = [a.name for a in target.output]
            if table.num_columns != len(names):
                raise AnalysisException(
                    f"INSERT INTO {cmd.name}: {table.num_columns} columns "
                    f"provided, table has {len(names)}")
            table = table.rename_columns(names)  # positional, like the ref
            wh.save_table(cmd.name, table,
                          mode="overwrite" if cmd.overwrite else "append")
            return df_of(pa.table({"result": pa.array([], pa.string())}))
        # temp view append: concat into the registered relation
        from .logical import LocalRelation

        existing = session.catalog_.lookup(cmd.name.split("."))
        if not isinstance(existing, LocalRelation):
            raise AnalysisException(
                f"INSERT INTO requires a saved table or materialized view: "
                f"{cmd.name}")
        table = table.rename_columns(existing.table.column_names)
        merged = table if cmd.overwrite else pa.concat_tables(
            [existing.table, table], promote_options="permissive")
        session.catalog_.register(
            cmd.name, LocalRelation(list(existing.attrs), merged))
        return df_of(pa.table({"result": pa.array([], pa.string())}))

    if isinstance(cmd, (UpdateCommand, DeleteCommand, MergeCommand)):
        return _run_dml(session, cmd, df_of)

    if isinstance(cmd, ShowTablesCommand):
        names = session.catalog_.list_tables()
        return df_of(pa.table({
            "namespace": pa.array([""] * len(names)),
            "tableName": pa.array(names),
            "isTemporary": pa.array([True] * len(names)),
        }))

    if isinstance(cmd, ShowFunctionsCommand):
        from ..expr.registry import filter_names

        return df_of(pa.table(
            {"function": pa.array(filter_names(cmd.pattern))}))

    if isinstance(cmd, DescribeCommand):
        plan = session.catalog_.lookup(cmd.name.split("."))
        from ..api.dataframe import DataFrame as DF

        analyzed = DF(session, plan).query_execution.analyzed
        return df_of(pa.table({
            "col_name": pa.array([a.name for a in analyzed.output]),
            "data_type": pa.array([a.dtype.simple_string()
                                   for a in analyzed.output]),
            "comment": pa.array([None] * len(analyzed.output), pa.string()),
        }))

    if isinstance(cmd, ExplainCommand):
        from ..api.dataframe import DataFrame as DF

        text = DF(session, cmd.query).query_execution.explain_string()
        return df_of(pa.table({"plan": pa.array([text])}))

    if isinstance(cmd, SetCommand):
        if cmd.key is None:
            from ..config import registry

            items = sorted(registry().items())
            return df_of(pa.table({
                "key": pa.array([k for k, _ in items]),
                "value": pa.array([str(session.conf.get(k))
                                   for k, _ in items]),
            }))
        if cmd.value is not None:
            session.conf.set(cmd.key, cmd.value)
        return df_of(pa.table({
            "key": pa.array([cmd.key]),
            "value": pa.array([str(session.conf.get(cmd.key))]),
        }))

    if isinstance(cmd, (DeclareVariableCommand, SetVariableCommand,
                        DropVariableCommand)):
        from ..expr.expressions import Literal

        varstore = session.catalog_.variables
        key = cmd.name.lower()
        if isinstance(cmd, DropVariableCommand):
            if key not in varstore and not cmd.if_exists:
                raise AnalysisException(f"variable {cmd.name} not found")
            varstore.pop(key, None)
            return df_of(pa.table({"variable": pa.array([cmd.name])}))
        if isinstance(cmd, SetVariableCommand) and key not in varstore:
            raise AnalysisException(
                f"variable {cmd.name} not declared (DECLARE it first)")
        if isinstance(cmd, DeclareVariableCommand) and key in varstore \
                and not cmd.replace:
            raise AnalysisException(
                f"variable {cmd.name} already exists "
                "(DECLARE OR REPLACE to overwrite)",
                error_class="VARIABLE_ALREADY_EXISTS")
        expr = cmd.default_expr \
            if isinstance(cmd, DeclareVariableCommand) else cmd.value_expr
        # the variable's declared type is sticky: assignments cast to it
        # (reference: SetVariable casts to the variable's type)
        target_dt = cmd.dtype if isinstance(cmd, DeclareVariableCommand) \
            else varstore[key].dtype
        if expr is None:
            value, dt = None, target_dt
        else:
            from ..expr.expressions import Alias, Cast
            from .logical import OneRowRelation, Project

            if target_dt is not None:
                expr = Cast(expr, target_dt)
            table = DataFrame(session, Project(
                [Alias(expr, "v")], OneRowRelation())).toArrow()
            value = table.column(0)[0].as_py() if table.num_rows else None
            from ..columnar.arrow import schema_from_arrow

            dt = target_dt if target_dt is not None else \
                schema_from_arrow(table.schema).fields[0].dataType
        varstore[key] = Literal(value, dt) if dt is not None \
            else Literal(value)
        return df_of(pa.table({
            "variable": pa.array([cmd.name]),
            "value": pa.array([None if value is None else str(value)]),
        }))

    if isinstance(cmd, AnalyzeTableCommand):
        from ..api.dataframe import DataFrame as _DF
        from .logical import LocalRelation, LogicalRelation
        from .stats import compute_table_stats

        plan = session.catalog_.lookup([cmd.name])
        table = _DF(session, plan).toArrow()
        stats = compute_table_stats(table, cmd.columns)
        # attach to the catalog plan's relation leaf so estimate()
        # (plan/stats.py) sees it wherever the view is spliced - only
        # when the "table" IS one relation (a multi-relation view's
        # per-leaf stats would be wrong)
        leaves = [n for n in plan.iter_nodes()
                  if isinstance(n, (LocalRelation, LogicalRelation))]
        if len(leaves) == 1:
            leaves[0]._cbo_stats = stats
        session._table_stats[session.catalog_._norm(cmd.name)] = stats
        return df_of(pa.table({
            "table": pa.array([cmd.name]),
            "rows": pa.array([stats.row_count]),
            "columns_analyzed": pa.array([len(stats.col_stats)]),
        }))

    raise AnalysisException(f"unknown command {type(cmd).__name__}")


# ---------------------------------------------------------------------------
# DML execution (UPDATE / DELETE / MERGE) - set-based table rewrites
# ---------------------------------------------------------------------------

def _write_target(session, name: str, new_tbl):
    """Replace a warehouse table or registered temp relation in place."""
    from ..errors import AnalysisException
    from .logical import LocalRelation

    wh = session.catalog_.external
    if wh is not None and name in wh.list_tables():
        target = wh.lookup(name)
        names = [a.name for a in target.output]
        wh.save_table(name, new_tbl.rename_columns(names), mode="overwrite")
        return
    existing = session.catalog_.lookup(name.split("."))
    if not isinstance(existing, LocalRelation):
        raise AnalysisException(
            f"DML requires a saved table or materialized view: {name}")
    new_tbl = new_tbl.rename_columns(existing.table.column_names)
    session.catalog_.register(
        name, LocalRelation(list(existing.attrs), new_tbl))


def _run_dml(session, cmd, df_of):
    import pyarrow as pa

    from ..api.dataframe import DataFrame
    from ..expr.expressions import (
        Alias, And, Cast, EqualNullSafe, If, IsNotNull, IsNull, Literal,
        Not, Or, UnresolvedAttribute, UnresolvedStar,
    )
    from .logical import (
        Filter, Join, Project, SubqueryAlias, UnresolvedRelation,
    )

    def empty_result():
        return df_of(pa.table({"result": pa.array([], pa.string())}))

    if isinstance(cmd, DeleteCommand):
        rel = UnresolvedRelation(cmd.name.split("."))
        if cmd.condition is None:
            plan = Filter(Literal(False), rel)
        else:
            # keep rows where the predicate is false OR unknown; the star
            # keeps the table's columns only, where the reference's bare
            # Filter also returns the columns its rewritten IN subquery
            # joins in, and fails (ROADMAP.md C12)
            plan = Project([UnresolvedStar(None)], Filter(
                Or(Not(cmd.condition), IsNull(cmd.condition)), rel))
        _write_target(session, cmd.name, DataFrame(session, plan).toArrow())
        return empty_result()

    if isinstance(cmd, UpdateCommand):
        rel = UnresolvedRelation(cmd.name.split("."))
        attrs = DataFrame(session, rel).query_execution.analyzed.output
        amap = {n.lower(): e for n, e in cmd.assignments}
        proj = []
        for a in attrs:
            old = UnresolvedAttribute([a.name])
            if a.name.lower() in amap:
                newe = amap[a.name.lower()]
                e = newe if cmd.condition is None \
                    else If(cmd.condition, newe, old)
                proj.append(Alias(Cast(e, a.dtype), a.name))
            else:
                proj.append(Alias(old, a.name))
        new_tbl = DataFrame(session, Project(proj, rel)).toArrow()
        _write_target(session, cmd.name, new_tbl)
        return empty_result()

    # ---- MERGE -----------------------------------------------------------
    talias = cmd.target.alias
    target_attrs = DataFrame(session,
                             cmd.target).query_execution.analyzed.output

    matched_ref = IsNotNull(UnresolvedAttribute(["__merge_m"]))

    def base_cond(cl, matched_flag):
        c = matched_flag
        if cl.extra is not None:
            c = And(c, EqualNullSafe(cl.extra, Literal(True)))
        return c

    def effective(clauses, matched_flag):
        """First-match-wins: clause i fires iff its condition holds AND no
        earlier clause's does."""
        eff, prior = [], None
        for cl in clauses:
            c = base_cond(cl, matched_flag)
            if prior is not None:
                c = And(c, Not(prior))
            eff.append(c)
            prior = c if prior is None else Or(prior, c)
        return eff

    # matched side: target LEFT OUTER source(+flag). The target gets a
    # host-assigned row id so multi-source matches are detectable - the
    # reference raises MERGE_CARDINALITY_VIOLATION when a target row that
    # an UPDATE/DELETE clause would touch matches more than one source row
    # instead of silently duplicating it. The join runs ONCE: the update
    # projection, row id, matched flag, and delete condition are computed
    # in a single pass, then the cardinality check and delete filter
    # happen host-side on the materialized result.
    from ..errors import ExecutionError
    from ..expr.expressions import AttributeReference
    from ..types import int64 as _i64
    from .logical import LocalRelation

    tgt_tbl = DataFrame(session, cmd.target).toArrow()
    if not cmd.matched:
        # insert-only MERGE: the matched side is the target unchanged (no
        # cardinality constraint applies - reference behavior)
        tables = [tgt_tbl]
    else:
        rid_tbl = tgt_tbl.append_column(
            "__merge_rid", pa.array(range(tgt_tbl.num_rows), pa.int64()))
        rid_attrs = [AttributeReference(a.name, a.dtype, True)
                     for a in target_attrs] + \
            [AttributeReference("__merge_rid", _i64, False)]
        target_rel = SubqueryAlias(talias, LocalRelation(rid_attrs, rid_tbl)) \
            if talias else LocalRelation(rid_attrs, rid_tbl)

        src_flag = Project([UnresolvedStar(None),
                            Alias(Literal(True), "__merge_m")], cmd.source)
        joined = Join(target_rel, src_flag, "left_outer", cmd.condition)

        eff = effective(cmd.matched, matched_ref)
        del_cond = None
        for cl, c in zip(cmd.matched, eff):
            if cl.kind == "delete":
                del_cond = c if del_cond is None else Or(del_cond, c)
        proj = []
        for a in target_attrs:
            old = UnresolvedAttribute([talias, a.name])
            e = old
            for cl, c in reversed(list(zip(cmd.matched, eff))):
                if cl.kind != "update":
                    continue
                am = {n.lower(): x for n, x in cl.assignments}
                if a.name.lower() in am:
                    e = If(c, am[a.name.lower()], e)
            proj.append(Alias(Cast(e, a.dtype), a.name))
        aux = [Alias(UnresolvedAttribute(["__merge_rid"]), "__merge_rid"),
               Alias(matched_ref, "__merge_mf")]
        if del_cond is not None:
            aux.append(Alias(del_cond, "__merge_del"))
        out = DataFrame(session, Project(proj + aux, joined)).toArrow()

        rids = [r for r, m in zip(out.column("__merge_rid").to_pylist(),
                                  out.column("__merge_mf").to_pylist()) if m]
        if len(rids) != len(set(rids)):
            raise ExecutionError(
                "MERGE_CARDINALITY_VIOLATION: a target row of the MERGE "
                "matched more than one source row; rewrite the source to "
                "have at most one match per target row")
        if del_cond is not None:
            keep = pa.array([d is not True for d in
                             out.column("__merge_del").to_pylist()])
            out = out.filter(keep)
        tables = [out.select([a.name for a in target_attrs])]

    # not-matched side: source LEFT ANTI target -> inserts
    if cmd.not_matched:
        anti = Join(cmd.source, cmd.target, "left_anti", cmd.condition)
        src_attrs = DataFrame(session,
                              cmd.source).query_execution.analyzed.output
        ins_eff = effective(cmd.not_matched, Literal(True))
        for cl, c in zip(cmd.not_matched, ins_eff):
            branch = anti if (cl.extra is None and len(cmd.not_matched) == 1) \
                else Filter(c, anti)
            if cl.insert_star:
                proj_i = [Alias(Cast(UnresolvedAttribute([s.name]), a.dtype),
                                a.name)
                          for s, a in zip(src_attrs, target_attrs)]
            else:
                cmap = {n.lower(): v for n, v in zip(cl.insert_cols,
                                                     cl.insert_vals)}
                proj_i = [Alias(Cast(cmap.get(a.name.lower(),
                                              Literal(None)), a.dtype),
                                a.name)
                          for a in target_attrs]
            tables.append(
                DataFrame(session, Project(proj_i, branch)).toArrow())

    new_tbl = pa.concat_tables(tables, promote_options="permissive")
    _write_target(session, cmd.name, new_tbl)
    return df_of(pa.table({"result": pa.array([], pa.string())}))
