"""Result-cache keys (counterpart of ``hyperspace_tpu/serving/fingerprint.py``).

A cached result may be served only if executing the query now would give
the same table. The key pins every input the answer depends on:

1. the plan fingerprint: the plan after the deterministic normalization
   (filter pushdown, column pruning), written out with every operator's
   full detail, so ``select().filter()`` and ``filter().select()`` of one
   query share an entry;
2. the source signature: (size, mtime, path) of every file the plan's
   relations list, stat'ed now;
3. the index log versions: (name, latest log id, md5 of that entry's
   bytes) of every index under the system path, while hyperspace is
   enabled. A create, refresh, optimize, delete or restore changes them;
4. the conf hash: the session conf and the hyperspace switch.

A stale key is never reached again; nothing expires by time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..plan.nodes import (Aggregate, BucketUnion, Filter, IndexScan, Join, Limit, LogicalPlan,
                          Project, Scan, Sort, Union, Window)
from ..util import hashing


@dataclass(frozen=True)
class ResultCacheKey:
    plan_fingerprint: str
    source_signature: str
    index_versions: Tuple[Tuple[str, int, str], ...]
    config_hash: str

    def digest(self) -> str:
        """A short stable form for explain."""
        return hashing.md5_hex((self.plan_fingerprint, self.source_signature,
                                self.index_versions, self.config_hash))[:12]


def _node_detail(plan: LogicalPlan) -> Optional[str]:
    """One node written out in full (``tree_string`` hides a Project's
    expressions). None for a node this module does not know: the plan is
    then not cacheable rather than wrongly keyed."""
    if isinstance(plan, Scan):
        rel = plan.relation
        return (f"Scan[{rel.file_format};{','.join(rel.root_paths)};"
                f"{sorted(rel.options.items())}]")
    if isinstance(plan, IndexScan):
        e = plan.index_entry
        return (f"IndexScan[{e.name};{e.log_version};{sorted(plan.deleted_file_ids)};"
                f"{sorted(plan.appended_files)};{plan.use_bucket_spec}]")
    if isinstance(plan, Filter):
        return f"Filter[{plan.condition!r}]"
    if isinstance(plan, Project):
        return "Project[" + ";".join(repr(e) for e in plan.exprs) + "]"
    if isinstance(plan, Join):
        return f"Join[{plan.join_type};{plan.condition!r}]"
    if isinstance(plan, Aggregate):
        return f"Aggregate[{plan.group_cols};" + ";".join(repr(a) for a in plan.aggs) + "]"
    if isinstance(plan, Window):
        return "Window[" + ";".join(f"{n}={w!r}" for n, w in plan.wexprs) + "]"
    if isinstance(plan, Sort):
        return f"Sort[{plan.orders}]"
    if isinstance(plan, Limit):
        return f"Limit[{plan.n}]"
    if isinstance(plan, (Union, BucketUnion)):
        return plan.node_name
    return None


def _serialize(plan: LogicalPlan, out: List[str]) -> bool:
    detail = _node_detail(plan)
    if detail is None:
        return False
    out.append(f"({detail}")
    for c in plan.children:
        if not _serialize(c, out):
            return False
    out.append(")")
    return True


def normalize(plan: LogicalPlan) -> LogicalPlan:
    """The environment-free prefix of ``Session.optimize``: filter pushdown
    and column pruning. The hyperspace rewrite and partition pruning depend
    on the environment, which the other key parts pin."""
    from ..rules.column_pruning import prune_columns
    from ..rules.pushdown import push_filters
    return prune_columns(push_filters(plan))


def plan_fingerprint(plan: LogicalPlan,
                     normalized: Optional[LogicalPlan] = None) -> Optional[str]:
    """The fingerprint of ``plan``; pass ``normalized`` (= normalize(plan))
    when it is at hand."""
    parts: List[str] = []
    if not _serialize(normalized if normalized is not None else normalize(plan), parts):
        return None
    return hashing.md5_hex("".join(parts))


def source_signature(plan: LogicalPlan) -> Optional[str]:
    """(size, mtime, path) of every file of every file-based leaf. Sizes and
    mtimes are stat'ed now; the file list is the relation's own, which is
    what execution reads."""
    parts = []
    for leaf in plan.collect_leaves():
        relation = getattr(leaf, "relation", None)
        if relation is None:
            return None
        for path, size, mtime in relation.all_file_infos():
            parts.append(f"{size}{mtime}{path}")
    return hashing.md5_hex("".join(parts))


def index_versions(session) -> Tuple[Tuple[str, int, str], ...]:
    """(name, latest log id, entry-bytes md5) per index, read from the op
    logs (not through the TTL index cache: another process's refresh must
    change the key at once). Empty while hyperspace is disabled."""
    if not session.is_hyperspace_enabled():
        return ()
    return session.index_collection_manager.latest_log_ids()


# Conf families left out of the key: the serving knobs (this cache's own
# budgets and floors), telemetry, robustness, fusion, the buffer pool
# (pool on and off answer alike), artifacts and cluster. Hashing them would
# orphan warm entries on every such tweak. Fusion steers one answer, as
# in the JAX package, whose key leaves it out too: a global aggregate of a
# nullable column over no kept rows is NULL fused and 0.0 (or a far end)
# staged, so a cached answer crosses a fusion.enabled switch (ROADMAP
# queue C 24).
_UNHASHED_PREFIXES = ("serving.", "hyperspace.tpu.serving.", "hyperspace.tpu.telemetry.",
                      "hyperspace.tpu.robustness.", "hyperspace.tpu.execution.fusion.",
                      "hyperspace.tpu.execution.bufferPool.", "hyperspace.tpu.artifacts.",
                      "hyperspace.tpu.cluster.")


def config_hash(session) -> str:
    """The session conf (but for the families above) and the hyperspace
    switch."""
    items = [(k, v) for k, v in sorted(session.conf.as_dict().items())
             if not k.startswith(_UNHASHED_PREFIXES)]
    return hashing.md5_hex((items, session.is_hyperspace_enabled()))


def compute_key(session, plan: LogicalPlan,
                normalized: Optional[LogicalPlan] = None) -> Optional[ResultCacheKey]:
    """The full key, or None when the plan is not soundly cacheable."""
    fp = plan_fingerprint(plan, normalized)
    if fp is None:
        return None
    sig = source_signature(normalized if normalized is not None else plan)
    if sig is None:
        return None
    return ResultCacheKey(fp, sig, index_versions(session), config_hash(session))


def estimate_recompute_bytes(optimized: LogicalPlan) -> int:
    """The input bytes the plan would read again: source file sizes for a
    relation leaf, the index files (and Hybrid Scan's appended files) for
    an index leaf. The admission floor and the frontend's byte budget read
    it."""
    from ..index.statistics import IndexStatistics
    from ..util import file_utils
    total = 0
    for leaf in optimized.collect_leaves():
        relation = getattr(leaf, "relation", None)
        if relation is not None:
            total += sum(size for _, size, _ in relation.all_file_infos())
        elif isinstance(leaf, IndexScan):
            total += IndexStatistics.from_entry(leaf.index_entry).index_size_bytes
            for f in leaf.appended_files:
                try:
                    total += file_utils.file_info_triple(f)[1]
                except OSError:
                    pass
    return total
