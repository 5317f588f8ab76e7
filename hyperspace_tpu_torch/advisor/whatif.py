"""What-if planning: would this index rewrite the plan, without building it?
(counterpart of ``hyperspace_tpu/advisor/whatif.py``).

A *hypothetical* IndexLogEntry is assembled from an IndexConfig and a live
Scan as actions/create.py assembles a real one (source content,
signature, derived-dataset descriptor), except that its content holds one
synthetic FileInfo whose size is the cost model's predicted index size
(cost.predicted_index_size_bytes). The rankers' size comparisons, the
score optimizer's index-bytes tie-break and cost.plan_cost_bytes all read
``index_files_size_in_bytes``, so they rank hypotheticals beside real
indexes with no special case.

Hypothetical entries reach the ScoreBasedIndexPlanOptimizer through its
``candidates_for`` hook (rules/score_optimizer.py, rules/join_rule.py,
rules/filter_rule.py): a candidate map that merges the real
CandidateIndexCollector output with them, so the chosen plan is the one
``Session.optimize`` would pick if the indexes existed. They stay
function-local values: no log manager, data file, metadata cache or
executor ever sees one, and the index log store's bytes are the same
after any number of what-if and recommend calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import DataSkippingIndexConfig, IndexConfig
from ..exceptions import HyperspaceException
from ..index.log_entry import (Content, CoveringIndex, Directory, FileIdTracker, FileInfo,
                               Hdfs, IndexLogEntry, LogicalPlanFingerprint, Relation,
                               Signature, Source, SourcePlan)
from ..index.signatures import IndexSignatureProvider
from ..plan import expr as E
from ..plan.nodes import Filter, IndexScan, LogicalPlan, Scan
from ..schema import Schema
from . import cost
from .constants import AdvisorConstants


def build_hypothetical_entry(session, config: IndexConfig,
                             scan: Scan) -> Optional[IndexLogEntry]:
    """A metadata-only ACTIVE entry for ``config`` over ``scan``'s relation,
    or None when the config's columns do not resolve there."""
    from ..index.constants import States
    from ..util.resolver import resolve_all
    relation = scan.relation
    names = relation.schema.names
    cs = session.hs_conf.case_sensitive()
    try:
        indexed = resolve_all(names, config.indexed_columns, cs)
        included = resolve_all(names, config.included_columns, cs)
    except HyperspaceException:
        return None
    tracker = FileIdTracker()
    source_content = Content.from_leaf_files(relation.all_files(), tracker)
    rel_meta = Relation(rootPaths=list(relation.root_paths), data=Hdfs(source_content),
                        dataSchema=relation.schema, fileFormat=relation.file_format,
                        options=dict(relation.options))
    provider = IndexSignatureProvider()
    fingerprint = LogicalPlanFingerprint([Signature(provider.name(), provider.signature(scan))])
    predicted = cost.predicted_index_size_bytes(relation, len(indexed) + len(included))
    derived = CoveringIndex(
        indexed_columns=indexed, included_columns=included,
        schema=Schema([relation.schema.field(c) for c in indexed + included]),
        num_buckets=session.hs_conf.num_bucket_count(),
        properties={AdvisorConstants.HYPOTHETICAL_PROPERTY: "true"})
    content = Content(Directory("/", files=[
        FileInfo(AdvisorConstants.HYPOTHETICAL_FILE_NAME, predicted, 0, 0)]))
    entry = IndexLogEntry.create(config.index_name, derived, content,
                                 Source(SourcePlan([rel_meta], fingerprint)),
                                 {AdvisorConstants.HYPOTHETICAL_PROPERTY: "true"})
    entry.state = States.ACTIVE
    return entry


def sketch_statically_applicable(plan: LogicalPlan, config: DataSkippingIndexConfig,
                                 table: Optional[Tuple[str, ...]] = None) -> bool:
    """Whether some Filter conjunct is a literal compare the sketch kind
    could refute on its column (the metadata-only half of prunability;
    the rest needs built sketch tables). ``table`` pins the candidate to
    its table: only Filters over that table count."""
    from .workload import _classify_conjunct
    equality, rng = set(), set()

    def over_pinned_table(node: LogicalPlan) -> bool:
        if table is None:
            return True
        return any(tuple(leaf.relation.root_paths) == table
                   for leaf in node.collect_leaves() if hasattr(leaf, "relation"))

    def visit(node: LogicalPlan):
        if isinstance(node, Filter) and over_pinned_table(node):
            for conj in E.split_conjunctive_predicates(node.condition):
                classified = _classify_conjunct(conj)
                if classified is not None:
                    (equality if classified[0] == "equality" else rng).add(classified[1])
        for c in node.children:
            visit(c)

    visit(plan)
    for s in config.sketches:
        if s.kind == "MinMax" and s.column in (equality | rng):
            return True
        if s.kind in ("BloomFilter", "ValueList") and s.column in equality:
            return True
    return False


@dataclass
class WhatIfOutcome:
    """One what-if pass over one plan."""

    applied: Tuple[str, ...]           # hypothetical names in the plan
    applied_existing: Tuple[str, ...]  # real indexes the plan also uses
    cost_before_bytes: int
    cost_after_bytes: int
    plan_before: str
    plan_after: str
    sketch_applicable: Dict[str, bool]

    @property
    def rewritten(self) -> bool:
        return bool(self.applied)

    @property
    def predicted_speedup(self) -> float:
        if self.cost_after_bytes <= 0:
            return 1.0
        return self.cost_before_bytes / self.cost_after_bytes

    def explain(self) -> str:
        lines = ["=== What-If Analysis ==="]
        if self.applied:
            lines.append("Hypothetical indexes applied: " + ", ".join(self.applied))
        else:
            lines.append("No hypothetical index would rewrite this plan.")
        if self.applied_existing:
            lines.append("Existing indexes in the plan: " + ", ".join(self.applied_existing))
        lines.append(f"Input bytes: {self.cost_before_bytes} -> {self.cost_after_bytes} "
                     f"(predicted speedup {self.predicted_speedup:.2f}x)")
        for name, ok in sorted(self.sketch_applicable.items()):
            lines.append(f"Sketch set '{name}': "
                         + ("statically applicable (prunability needs a build)"
                            if ok else "no refutable predicate in this plan"))
        lines.append("")
        lines.append("--- Plan without the hypothetical indexes ---")
        lines.append(self.plan_before)
        lines.append("--- Plan with the hypothetical indexes ---")
        lines.append(self.plan_after)
        return "\n".join(lines)


@dataclass
class WhatIfBaseline:
    """The config-independent half of a what-if pass over one plan: the
    normalized tree, the REAL candidate map, today's plan and its cost.
    ``recommend`` prices many candidate groups against one record, so it
    makes this once per record."""

    norm: LogicalPlan
    base: dict
    before_plan: LogicalPlan
    cost_before_bytes: int
    # cost.filter_selectivity_map over the normalized plan: one map prices
    # the plans before and after the rewrite.
    selectivities: Optional[Dict[Tuple[Tuple[str, ...], str], float]] = None


def prepare_baseline(session, plan: LogicalPlan,
                     include_existing: bool = True) -> WhatIfBaseline:
    from ..rules.apply_hyperspace import active_indexes
    from ..rules.index_filters import CandidateIndexCollector, ReasonCollector
    from ..rules.score_optimizer import ScoreBasedIndexPlanOptimizer
    from ..serving import fingerprint as fp

    norm = fp.normalize(plan)
    if session.hs_conf.join_reorder_enabled():
        # As Session.optimize: reorder after normalization and before the
        # index rules, so a rewrite is priced on the tree that would run. A
        # diagnostic pass; the session keeps the chain records of the last
        # executed reorder.
        from ..optimizer.join_order import reorder_joins
        saved = session._last_join_order
        norm = reorder_joins(session, norm, diagnostic=True)
        session._last_join_order = saved
    real: List[IndexLogEntry] = []
    if include_existing:
        real = [e for e in active_indexes(session) if e.derivedDataset.kind == "CoveringIndex"]
    ctx = ReasonCollector(enabled=False, silent=True)
    base = CandidateIndexCollector.collect(session, norm, real, ctx)
    before_plan = ScoreBasedIndexPlanOptimizer().apply(session, norm, base, ctx)
    selectivities = cost.filter_selectivity_map(session, norm)
    return WhatIfBaseline(norm, base, before_plan,
                          cost.plan_cost_bytes(before_plan, selectivities), selectivities)


def what_if_plan(session, plan: LogicalPlan, configs, include_existing: bool = True,
                 config_tables: Optional[Dict[str, Tuple[str, ...]]] = None,
                 baseline: Optional[WhatIfBaseline] = None,
                 entry_cache: Optional[dict] = None) -> WhatIfOutcome:
    """Run the index selection again with hypothetical entries for
    ``configs`` beside the real candidates. Pure planning: no telemetry,
    no usage count, nothing persisted.

    ``config_tables`` (index name -> root paths) pins a config to its table;
    without it a config goes to every scan whose schema resolves its
    columns. ``baseline``: prepare_baseline(...) when pricing many config
    sets against one plan. ``entry_cache``: a dict shared across calls
    memoizing the hypothetical entries per (config name, relation)."""
    from ..rules.index_filters import ReasonCollector
    from ..rules.score_optimizer import ScoreBasedIndexPlanOptimizer

    if baseline is None:
        baseline = prepare_baseline(session, plan, include_existing)
    norm = baseline.norm
    covering_cfgs = [c for c in configs if isinstance(c, IndexConfig)]
    sketch_cfgs = [c for c in configs if isinstance(c, DataSkippingIndexConfig)]

    merged = {k: (scan, list(entries)) for k, (scan, entries) in baseline.base.items()}
    hypo_names: List[str] = []
    for leaf in norm.collect_leaves():
        if not isinstance(leaf, Scan):
            continue
        if not session.source_provider_manager.is_supported_relation(leaf):
            continue
        for cfg in covering_cfgs:
            pinned = (config_tables or {}).get(cfg.index_name)
            if pinned is not None and tuple(leaf.relation.root_paths) != pinned:
                continue
            if entry_cache is not None:
                cache_key = (cfg.index_name, id(leaf.relation))
                if cache_key not in entry_cache:
                    entry_cache[cache_key] = build_hypothetical_entry(session, cfg, leaf)
                entry = entry_cache[cache_key]
            else:
                entry = build_hypothetical_entry(session, cfg, leaf)
            if entry is None:
                continue
            scan, entries = merged.get(id(leaf), (leaf, []))
            merged[id(leaf)] = (scan, entries + [entry])
            hypo_names.append(entry.name)
    after_plan = ScoreBasedIndexPlanOptimizer().apply(
        session, norm, merged, ReasonCollector(enabled=False, silent=True))

    used = {leaf.index_entry.name for leaf in after_plan.collect_leaves()
            if isinstance(leaf, IndexScan)}
    return WhatIfOutcome(
        applied=tuple(sorted(used & set(hypo_names))),
        applied_existing=tuple(sorted(used - set(hypo_names))),
        cost_before_bytes=baseline.cost_before_bytes,
        cost_after_bytes=cost.plan_cost_bytes(after_plan, baseline.selectivities),
        plan_before=baseline.before_plan.tree_string(),
        plan_after=after_plan.tree_string(),
        sketch_applicable={c.index_name: sketch_statically_applicable(
            norm, c, (config_tables or {}).get(c.index_name)) for c in sketch_cfgs})


def what_if(session, plan: LogicalPlan, configs) -> WhatIfOutcome:
    """``Hyperspace.what_if``: one what-if pass and its event."""
    outcome = what_if_plan(session, plan, configs)
    from ..telemetry.events import AdvisorWhatIfEvent
    from ..telemetry.logging import log_event
    log_event(session, AdvisorWhatIfEvent(
        message="what-if analysis " + ("rewrote the plan" if outcome.rewritten
                                       else "did not rewrite the plan"),
        index_names=[getattr(c, "index_name", "?") for c in configs],
        applied_names=list(outcome.applied)))
    return outcome
