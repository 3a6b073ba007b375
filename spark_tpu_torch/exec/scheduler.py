"""Stage-DAG scheduler (the port's copy of the stage part of
`spark_tpu/exec/scheduler.py`).

The physical plan is cut into stages at shuffle and broadcast exchanges
(`build_stage_graph`, the role of DAGScheduler.createShuffleMapStage):
each stage's root is an exchange (a map stage) or the result subtree, and
an exchange nested below becomes a `_StageOutput` leaf standing for its
stage's materialised partitions. `DAGScheduler.run` materialises one
ready stage at a time (all of its parent stages done), under AQE the
stages that feed a shuffled join's build side first, and after each stage
re-plans the stages not yet run with the sizes it observed
(physical/adaptive.replan_stages: a build side under the broadcast
threshold demotes its join). A failed stage is re-run once
(`max_attempts=2`; deterministic re-execution replays its subtree), and
the metrics count `scheduler.stages_completed` and
`scheduler.stage_retries`. With spark.tpu.debug.validateBatches set, each
stage's result is checked by `columnar/validate.maybe_validate` before the
stage counts as completed, as the reference does.

A whole-tier program (physical/whole_query.WholeQueryExec) holds its plan
as no child, so it is one stage. Stages run one after another, and a
stage's partitions one after another on the device's current stream: a
captured program is not reentrant, so the reference's `par_map` lanes are
not ported (A12). The executor registry, health tracker and barrier are
A13's.

Dynamic partition pruning across stages: a join's build side runs before
its probe side (HashJoinExec.execute does so inside one stage). Where the
probe-side scans that the build side prunes sit in another stage, the
build side's stages run first and the join installs its split filters as
soon as its build side is materialised, before those scans run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..columnar.validate import maybe_validate
from ..physical.operators import PhysicalPlan
from .context import ExecContext


@dataclass
class Stage:
    stage_id: int
    root: PhysicalPlan           # subtree with exchanges as leaves
    parents: list["Stage"] = field(default_factory=list)
    attempts: int = 0
    result: list | None = None   # materialized partitions

    def __hash__(self):
        return self.stage_id


def build_stage_graph(plan: PhysicalPlan) -> tuple[Stage, list[Stage]]:
    """Cut the physical plan at exchange boundaries. Each stage's root is
    an exchange or the result subtree; nested exchanges become
    _StageOutput leaves wired to their parent stages."""
    from ..physical.exchange import BroadcastExchangeExec, ShuffleExchangeExec

    counter = [0]
    stages: list[Stage] = []

    def convert(node: PhysicalPlan, parent_list: list[Stage]) -> PhysicalPlan:
        if isinstance(node, (ShuffleExchangeExec, BroadcastExchangeExec)):
            sub_parents: list[Stage] = []
            new_child = convert(node.child, sub_parents)
            counter[0] += 1
            st = Stage(counter[0], node.with_new_children([new_child]),
                       sub_parents)
            stages.append(st)
            parent_list.append(st)
            return _StageOutput(st, node.output)
        return node.map_children(lambda c: convert(c, parent_list))

    root_parents: list[Stage] = []
    root_plan = convert(plan, root_parents)
    counter[0] += 1
    result_stage = Stage(counter[0], root_plan, root_parents)
    stages.append(result_stage)
    return result_stage, stages


class _StageOutput(PhysicalPlan):
    """Leaf standing for a parent stage's materialized output."""

    child_fields = ()

    def __init__(self, stage: Stage, attrs):
        self.stage = stage
        self.attrs = attrs

    @property
    def output(self):
        return self.attrs

    def output_partitioning(self):
        from ..physical.partitioning import UnknownPartitioning

        n = len(self.stage.result) if self.stage.result is not None else 1
        return UnknownPartitioning(n)

    def execute(self, ctx):
        if self.stage.result is None:
            raise RuntimeError(
                f"parent stage {self.stage.stage_id} not materialized")
        return self.stage.result

    def simple_string(self):
        return f"StageOutput(#{self.stage.stage_id})"


def _stage_leaves(root: PhysicalPlan) -> list[_StageOutput]:
    return [n for n in root.iter_nodes() if isinstance(n, _StageOutput)]


def _reachable_stages(result_stage: Stage) -> list[Stage]:
    """Stages transitively referenced from the result stage via
    _StageOutput leaves (replanning can orphan stages; orphans never
    run)."""
    seen: dict[int, Stage] = {}
    work = [result_stage]
    while work:
        st = work.pop()
        if st.stage_id in seen:
            continue
        seen[st.stage_id] = st
        for leaf in _stage_leaves(st.root):
            work.append(leaf.stage)
    return list(seen.values())


def _close_over_parents(build: list[Stage]) -> set[int]:
    out: set[int] = set()
    while build:
        st = build.pop()
        if st.stage_id in out:
            continue
        out.add(st.stage_id)
        build.extend(leaf.stage for leaf in _stage_leaves(st.root))
    return out


def _build_side_stage_ids(stages: list[Stage], done: set[int]) -> set[int]:
    """Stage ids feeding the build (right) side of a not-yet-broadcast
    hash join: materializing those first gives AQE demotion its shot."""
    from ..physical.operators import HashJoinExec

    build: list[Stage] = []
    for st in stages:
        if st.stage_id in done:
            continue
        for n in st.root.iter_nodes():
            if isinstance(n, HashJoinExec) and not n.is_broadcast and \
                    isinstance(n.right, _StageOutput):
                build.append(n.right.stage)
    # the whole build-side chain runs before any probe-side shuffle
    return _close_over_parents(build)


def _dpp_joins(stages: list[Stage], done: set[int]):
    """(join, build stage) of each unrun join that prunes probe-side
    scans from a build side materialised in another stage."""
    from ..physical.operators import HashJoinExec

    for st in stages:
        if st.stage_id in done:
            continue
        for n in st.root.iter_nodes():
            if isinstance(n, HashJoinExec) and n.dpp_targets and \
                    isinstance(n.right, _StageOutput):
                yield n, n.right.stage


def _install_stage_dpp(stages: list[Stage], done: set[int],
                       ctx: ExecContext) -> None:
    for join, build in _dpp_joins(stages, done):
        if build.stage_id in done and build.result is not None:
            join._install_dpp_filters(build.result, ctx)


class DAGScheduler:
    """Runs a stage graph with per-stage retry (a stage is the unit of
    recovery; deterministic re-execution replays the subtree)."""

    def __init__(self, ctx: ExecContext, max_attempts: int = 2):
        self.ctx = ctx
        self.max_attempts = max_attempts

    def run(self, plan: PhysicalPlan) -> list:
        from ..physical.adaptive import aqe_replanning_enabled, replan_stages

        result_stage, _ = build_stage_graph(plan)
        done: set[int] = set()
        adaptive = aqe_replanning_enabled(self.ctx)

        # materialize one ready stage at a time and re-plan the remainder
        # with observed sizes after each completion; stages the re-plan
        # inlined or replaced drop out of the reachable set and never run
        while result_stage.stage_id not in done:
            needed = _reachable_stages(result_stage)
            ready = [st for st in needed
                     if st.stage_id not in done
                     and all(leaf.stage.stage_id in done
                             for leaf in _stage_leaves(st.root))]
            if not ready:
                raise RuntimeError("stage graph stalled (cycle?)")
            # potential broadcast build sides first, so a small side can
            # demote its join before the probe shuffle runs; a build side
            # that prunes probe scans runs first too
            first = _close_over_parents(
                [b for _, b in _dpp_joins(needed, done)])
            if adaptive:
                first |= _build_side_stage_ids(needed, done)
            ready.sort(key=lambda s: (s.stage_id not in first, s.stage_id))
            st = ready[0]
            self._run_stage(st)
            done.add(st.stage_id)
            if st is not result_stage:
                if adaptive:
                    replan_stages(needed, done, self.ctx)
                _install_stage_dpp(needed, done, self.ctx)
        return result_stage.result

    def _run_stage(self, stage: Stage) -> None:
        last_err: Exception | None = None
        for attempt in range(self.max_attempts):
            stage.attempts = attempt + 1
            try:
                stage.result = stage.root.execute(self.ctx)
                maybe_validate(stage.result, self.ctx,
                               f"stage-{stage.stage_id}")
                self.ctx.metrics.add("scheduler.stages_completed")
                return
            except Exception as e:  # deterministic retry (lineage)
                last_err = e
                self.ctx.metrics.add("scheduler.stage_retries")
        raise last_err
