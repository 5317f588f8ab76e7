"""Crash recovery: op-log rollback and orphaned data-version vacuum
(counterpart of ``hyperspace_tpu/robustness/recovery.py``).

A crashed action leaves only a transient log state; queries keep serving
the last stable entry. The sweep a fresh session runs over a lake another
process died in:

- every index whose latest log entry is transient is rolled back to its
  last stable state through CancelAction;
- index data versions (``v__=<n>``) that no ACTIVE or DELETED entry
  references are the dead action's partial output, and are deleted;
- the streaming tier's table logs are undone or redone, and staging
  leftovers swept (streaming/ingest.recover_streaming).

Operator action: a transient entry left by a crash cannot be told from
one a live action holds, so run the sweep only while no other process
mutates the lake.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from ..index.constants import STABLE_STATES, IndexConstants, States
from ..index.data_manager import IndexDataManager
from ..index.log_manager import IndexLogManager
from . import faults as _faults

# v__=<n> anywhere in a content file path names the entry's data version.
_VERSION_RE = re.compile(re.escape(IndexConstants.INDEX_VERSION_DIRECTORY_PREFIX) + r"=(\d+)")


def recover_indexes(session, names: Optional[List[str]] = None) -> Dict:
    """Sweep every index under the session's system path (or just
    ``names``): roll back transient states, vacuum orphaned versions, and
    (for a whole sweep) resolve the streaming tier. Per-index failures are
    collected under ``errors``."""
    summary: Dict = {"scanned": [], "cancelled": [], "vacuumed": {}, "errors": {}}
    root = session.hs_conf.system_path()
    if not os.path.isdir(root):
        return summary
    for name in sorted(os.listdir(root)):
        if names is not None and name not in names:
            continue
        index_path = os.path.join(root, name)
        if not os.path.isdir(os.path.join(index_path, IndexConstants.HYPERSPACE_LOG)):
            continue
        summary["scanned"].append(name)
        try:
            recover_index(session, index_path, name, summary)
        except Exception as e:
            summary["errors"][name] = f"{type(e).__name__}: {e}"
    if names is None:
        try:
            from ..streaming.ingest import recover_streaming
            recover_streaming(session, summary)
        except Exception as e:
            summary["errors"]["_streaming"] = f"{type(e).__name__}: {e}"
    if summary["cancelled"] or summary["vacuumed"]:
        # A sweep that found wrecks is the incident record (another process
        # died mid-action): a flight-recorder anomaly for the post-mortem.
        from ..telemetry.flight_recorder import note_anomaly
        note_anomaly("crash.recovery", f"cancelled={summary['cancelled']} "
                                       f"vacuumed={sorted(summary['vacuumed'])}")
    return summary


def recover_index(session, index_path: str, name: str,
                  summary: Optional[Dict] = None) -> Dict:
    """Recover one index directory; see :func:`recover_indexes`."""
    if summary is None:
        summary = {"scanned": [name], "cancelled": [], "vacuumed": {}, "errors": {}}
    mgr = IndexLogManager(index_path)
    latest_id = mgr.get_latest_id()
    if latest_id is None:
        return summary
    latest = mgr._get_log_lenient(latest_id)
    if latest is not None and latest.state not in STABLE_STATES:
        from ..actions.lifecycle import CancelAction
        CancelAction(session, mgr, IndexDataManager(index_path)).run()
        summary["cancelled"].append(name)
        _faults.note(recovered_indexes=1)
    orphans = _vacuum_orphan_versions(mgr, index_path)
    if orphans:
        summary["vacuumed"][name] = orphans
        _faults.note(vacuumed_orphans=len(orphans))
    return summary


def _referenced_versions(mgr: IndexLogManager) -> set:
    """Data versions any parseable ACTIVE or DELETED entry commits to, over
    the existing ids (sparse after compaction)."""
    referenced: set = set()
    for log_id in mgr.get_all_ids():
        entry = mgr._get_log_lenient(log_id)
        if entry is None or entry.state not in (States.ACTIVE, States.DELETED):
            continue
        try:
            files = entry.content.files
        except Exception:
            continue  # a content-less entry constrains nothing
        for f in files:
            for m in _VERSION_RE.finditer(f):
                referenced.add(int(m.group(1)))
    return referenced


def _vacuum_orphan_versions(mgr: IndexLogManager, index_path: str) -> List[int]:
    """Delete the data versions no entry references (``IndexDataManager
    .delete`` also empties the buffer pool, so no cached read outlives its
    files)."""
    if mgr.get_latest_id() is None:
        return []
    referenced = _referenced_versions(mgr)
    dm = IndexDataManager(index_path)
    orphans = [v for v in dm.get_all_version_ids() if v not in referenced]
    for v in orphans:
        dm.delete(v)
    return orphans
