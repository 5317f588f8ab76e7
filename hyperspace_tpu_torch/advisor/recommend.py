"""Cost-ranked index recommendation over the captured workload
(counterpart of ``hyperspace_tpu/advisor/recommend.py``).

For every candidate group, the what-if planner runs against every
captured plan over the group's tables, and the benefit adds up:

    benefit = sum over matching records of
              observed latency x (1 - rewritten bytes / baseline bytes)

so a candidate is worth what the workload would have saved with the index
built: weighted by frequency, aware of coverage (what-if runs the real
selection search), and zero for a candidate whose rewrite never fires.
Sketch sets promise no bytes before a build: their benefit is 0, and they
rank by static applicability and support behind any covering candidate
with benefit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from . import workload
from .candidates import CandidateGroup, _covered_by_existing, generate
from .whatif import prepare_baseline, what_if_plan


@dataclass
class Recommendation:
    """One ranked proposal: its configs are built together (a join pair
    pays only as a pair)."""

    rank: int
    kind: str                      # "filter" | "join" | "sketch"
    names: Tuple[str, ...]
    configs: Tuple[object, ...]    # IndexConfig | DataSkippingIndexConfig
    tables: Tuple[Tuple[Tuple[str, ...], str], ...]  # (root_paths, format)
    predicted_benefit_s: float
    predicted_speedup: float
    support: int
    queries_matched: int
    record_indices: Tuple[int, ...] = ()


@dataclass
class AdvisorReport:
    recommendations: List[Recommendation] = field(default_factory=list)
    candidates_evaluated: int = 0
    records_considered: int = 0

    def explain(self) -> str:
        lines = ["=== Index Recommendations ===",
                 f"Workload records considered: {self.records_considered}",
                 f"Candidate groups evaluated: {self.candidates_evaluated}"]
        if not self.recommendations:
            lines.append("No recommendations (capture a workload first: "
                         "hyperspace.tpu.advisor.capture.enabled=true).")
        for r in self.recommendations:
            lines.append(f"#{r.rank} [{r.kind}] {', '.join(r.names)}: "
                         f"predicted benefit {r.predicted_benefit_s:.4f}s over "
                         f"{r.queries_matched} matched queries "
                         f"(predicted speedup {r.predicted_speedup:.2f}x, "
                         f"support {r.support})")
            for cfg in r.configs:
                if hasattr(cfg, "indexed_columns"):
                    lines.append(f"    create_index: indexed={list(cfg.indexed_columns)} "
                                 f"included={list(cfg.included_columns)}")
                else:
                    lines.append("    create_index (sketches): "
                                 + ", ".join(f"{s.kind}({s.column})" for s in cfg.sketches))
        return "\n".join(lines)


def _tables_overlap(group: CandidateGroup, record) -> bool:
    return bool({s.root_paths for s in group.specs}
                & {s.root_paths for s in record.scan_shapes})


def _evaluate(session, group: CandidateGroup, records, baseline_for, entry_cache,
              actives) -> Recommendation:
    configs = tuple(s.config for s in group.specs)
    config_tables = {s.config.index_name: s.root_paths for s in group.specs}
    # A join pair counts only where every side no existing index serves
    # applied: a one-sided filter rewrite must not credit the whole pair.
    required = {s.config.index_name for s in group.specs
                if not _covered_by_existing(s, actives)}
    benefit = 0.0
    total_before = total_after = 0
    matched: List[int] = []
    for i, record in enumerate(records):
        if record.plan is None or not _tables_overlap(group, record):
            continue
        outcome = what_if_plan(session, record.plan, configs, config_tables=config_tables,
                               baseline=baseline_for(i), entry_cache=entry_cache)
        if group.kind == "sketch":
            if any(outcome.sketch_applicable.values()):
                matched.append(i)
            continue
        if not outcome.applied:
            continue
        if group.kind == "join" and not required <= set(outcome.applied):
            continue
        matched.append(i)
        total_before += outcome.cost_before_bytes
        total_after += outcome.cost_after_bytes
        if outcome.cost_before_bytes > 0:
            ratio = outcome.cost_after_bytes / outcome.cost_before_bytes
            benefit += record.latency_s * max(0.0, 1.0 - ratio)
    speedup = (total_before / total_after) if (matched and total_after > 0) else 1.0
    return Recommendation(
        rank=0, kind=group.kind, names=tuple(s.config.index_name for s in group.specs),
        configs=configs, tables=tuple((s.root_paths, s.file_format) for s in group.specs),
        predicted_benefit_s=benefit, predicted_speedup=speedup, support=group.support,
        queries_matched=len(matched), record_indices=tuple(matched))


def recommend(session, top_k: int = 5) -> AdvisorReport:
    """Candidate groups ranked by predicted benefit (confirmed by what-if),
    the same for the same workload and sources. Pure planning: nothing is
    built and the index log store is untouched."""
    from ..index.constants import States
    records = workload.log_for(session).snapshot()
    groups = generate(session, records)
    # One baseline per record that some group matches, made on first need;
    # one hypothetical entry per (config, relation).
    baselines: list = [None] * len(records)

    def baseline_for(i: int):
        if baselines[i] is None:
            baselines[i] = prepare_baseline(session, records[i].plan)
        return baselines[i]

    entry_cache: dict = {}
    actives = session.index_collection_manager.get_indexes([States.ACTIVE])
    recos = [_evaluate(session, g, records, baseline_for, entry_cache, actives)
             for g in groups]
    # Benefit, then matched queries (a sketch set's benefit is 0), then
    # support, then names; groups that applied nowhere are cut.
    recos.sort(key=lambda r: (-r.predicted_benefit_s, -r.queries_matched, -r.support, r.names))
    recos = [r for r in recos if r.queries_matched > 0][:max(0, top_k)]
    for i, r in enumerate(recos):
        r.rank = i + 1
    report = AdvisorReport(recommendations=recos, candidates_evaluated=len(groups),
                           records_considered=len(records))
    from ..telemetry.events import AdvisorRecommendationEvent
    from ..telemetry.logging import log_event
    log_event(session, AdvisorRecommendationEvent(
        message=f"{len(recos)} recommendation(s) from {len(records)} workload record(s)",
        recommended=[n for r in recos for n in r.names],
        candidates_evaluated=len(groups), records_considered=len(records)))
    return report


def build_recommendation(hyperspace, recommendation: Recommendation) -> None:
    """Build one recommendation's configs through the normal create path
    (this one DOES write index data and log entries). A config an existing
    ACTIVE index covers is skipped: a half-covered join pair builds only
    its missing side."""
    from ..index.constants import States
    from .candidates import CandidateSpec
    session = hyperspace.session
    actives = session.index_collection_manager.get_indexes([States.ACTIVE])
    for cfg, (root_paths, file_format) in zip(recommendation.configs, recommendation.tables):
        if _covered_by_existing(CandidateSpec(cfg, root_paths, file_format), actives):
            continue
        df = session.read.format(file_format).load(*root_paths)
        hyperspace.create_index(df, cfg)
