"""Op-log compaction and vacuum (counterpart of
``hyperspace_tpu/streaming/compaction.py``).

Every action appends two entries to its op log, and every streaming commit
two to its table's log and two to each index log it lands a delta in.
``compact()`` bounds that: for every log whose tip is stable it writes one
checkpoint entry (a copy of the tip carrying ``compactionGeneration`` and
``compactedThrough``) at a new id, deletes the superseded entry files, and
vacuums the index data versions no remaining entry references
(``robustness/recovery._vacuum_orphan_versions``, which also empties the
buffer pool, so no cached read names a deleted file).

The checkpoint lands at a new id with new bytes, so the result cache's
(latest id, entry md5) component changes by construction. Every state in
between is a valid log: a crash before the checkpoint leaves the log as it
was, one during the deletes leaves superseded entries the next compact()
folds.

Operator action, as ``recover()`` and ``vacuum_index``: the version vacuum
deletes bytes a reader planned on a stale entry could still need, so run
it in a quiet window.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..index.constants import STABLE_STATES, IndexConstants
from ..index.log_entry import IndexLogEntry
from ..index.log_manager import IndexLogManager
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from .constants import StreamingConstants as SC


def compact(session, names: Optional[List[str]] = None) -> Dict:
    """Compact every op log under the session's system path (indexes and
    streaming table logs, the latter named ``streaming:<key>``), or just
    ``names``. Returns {compacted, skipped, errors}; one wrecked log does
    not stop the sweep."""
    summary: Dict = {"compacted": {}, "skipped": {}, "errors": {}}
    root = session.hs_conf.system_path()
    min_entries = session.hs_conf.streaming_compaction_min_entries()
    for name, path in _log_dirs(root):
        if names is not None and name not in names \
                and name.replace("streaming:", "", 1) not in names:
            continue
        try:
            with _trace.maintenance_trace(session, "compact"), \
                    _trace.span(SN.INGEST_COMPACT) as sp:
                _compact_one(session, name, path, min_entries, summary)
                if sp is not None and name in summary["compacted"]:
                    sp.attrs["folded"] = summary["compacted"][name]["entries_folded"]
        except Exception as e:
            summary["errors"][name] = f"{type(e).__name__}: {e}"
    session.index_collection_manager.clear_cache()
    return summary


def _log_dirs(root: str) -> List[tuple]:
    """(display name, directory) of every op log under the system path."""
    out: List[tuple] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if name == SC.STREAMING_DIR:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(os.path.join(path, IndexConstants.HYPERSPACE_LOG)):
            out.append((name, path))
    sroot = os.path.join(root, SC.STREAMING_DIR)
    if os.path.isdir(sroot):
        for name in sorted(os.listdir(sroot)):
            path = os.path.join(sroot, name)
            if os.path.isdir(os.path.join(path, IndexConstants.HYPERSPACE_LOG)):
                out.append((f"streaming:{name}", path))
    return out


def _compact_one(session, name: str, path: str, min_entries: int, summary: Dict) -> None:
    mgr = IndexLogManager(path)
    latest_id = mgr.get_latest_id()
    if latest_id is None:
        summary["skipped"][name] = "empty log"
        return
    tip = mgr._get_log_lenient(latest_id)
    if tip is None or tip.state not in STABLE_STATES:
        summary["skipped"][name] = "tip is transient (live action or wreck); recover() first"
        return
    superseded = sorted(i for i in mgr.get_all_ids() if i < latest_id)
    if len(superseded) < min_entries:
        summary["skipped"][name] = (f"{len(superseded)} superseded entries below "
                                    "streaming.compaction.minEntries")
        return
    generation = int(tip.properties.get(SC.COMPACTION_GENERATION_PROPERTY, "0")) + 1
    checkpoint = IndexLogEntry.from_json(tip.to_json())
    checkpoint.properties[SC.COMPACTION_GENERATION_PROPERTY] = str(generation)
    checkpoint.properties[SC.COMPACTED_THROUGH_PROPERTY] = str(latest_id)
    checkpoint.timestamp = int(time.time() * 1000)
    if not mgr.write_log(latest_id + 1, checkpoint):
        summary["skipped"][name] = "lost the log id race to a concurrent action"
        return
    mgr.create_latest_stable_log(latest_id + 1)
    folded = sum(1 for i in superseded + [latest_id] if mgr.delete_log(i))
    from ..robustness.recovery import _vacuum_orphan_versions
    orphans = _vacuum_orphan_versions(mgr, path)
    summary["compacted"][name] = {"entries_folded": folded, "generation": generation,
                                  "versions_vacuumed": len(orphans)}
    from ..telemetry.events import StreamingCompactionEvent
    from ..telemetry.logging import log_event
    log_event(session, StreamingCompactionEvent(
        message=f"folded {folded} op-log entries into checkpoint generation {generation}",
        subject=name, entries_folded=folded, generation=generation,
        versions_vacuumed=len(orphans)))
