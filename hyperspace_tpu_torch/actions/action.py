"""Transactional action framework: the 2-phase protocol over the op log
(counterpart of ``hyperspace_tpu/actions/action.py``). Every index
mutation runs as

    validate() → begin(): write transient state at baseId+1
               → op():    do the work
               → end():   write final state at baseId+2, refresh latestStable

Concurrency control is optimistic: the transient write fails if another
action already claimed baseId+1. ``NoChangesException`` from validate()
makes the action a no-op that returns quietly. Every run emits its event
(``event(message)``) when it starts and when it succeeds, records a no-op
or fails, through the session's event logger.
"""

from __future__ import annotations

import time
from typing import Optional

from ..exceptions import HyperspaceException, NoChangesException
from ..index.log_entry import IndexLogEntry
from ..index.log_manager import IndexLogManager
from ..parallel import io as pio
from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..telemetry.events import HyperspaceEvent
from ..telemetry.logging import get_logger


class Action:
    transient_state: str = ""
    final_state: str = ""

    def __init__(self, session, log_manager: IndexLogManager):
        self.session = session
        self.log_manager = log_manager
        self._base_id: Optional[int] = None

    @property
    def base_id(self) -> int:
        if self._base_id is None:
            latest = self.log_manager.get_latest_id()
            self._base_id = -1 if latest is None else latest
        return self._base_id

    @property
    def end_id(self) -> int:
        return self.base_id + 2

    @property
    def log_entry(self) -> IndexLogEntry:
        """The entry to persist; evaluated at begin() and again at end(), so
        create-style actions can reflect work done by op()."""
        raise NotImplementedError

    def validate(self) -> None:
        pass

    def op(self) -> None:
        raise NotImplementedError

    def event(self, message: str) -> HyperspaceEvent:
        raise NotImplementedError

    def run(self) -> None:
        logger = get_logger(self.session.hs_conf.event_logger_class())
        # Reads under this action (sketch builds, chunk streams, the spill
        # merge) take the session's io conf, and its sketch reductions and
        # mesh builds the session's length classes; the fault scope arms
        # the session's robustness.faults.* conf for exactly this run.
        from .. import shapes
        try:
            logger.log_event(self.event("Operation started."))
            with shapes.use_conf(self.session.hs_conf), pio.use_session(self.session), \
                    _faults.scope_for(self.session.hs_conf):
                self.validate()
                self._begin()
                _faults.fault_point(_fn.ACTION_OP)
                self.op()
                self._end()
            logger.log_event(self.event("Operation succeeded."))
        except NoChangesException as e:
            logger.log_event(self.event(f"No-op operation recorded: {e}"))
        except Exception as e:
            logger.log_event(self.event(f"Operation failed: {e}"))
            raise

    def _begin(self) -> None:
        entry = self.log_entry
        entry.state = self.transient_state
        self._save_entry(self.base_id + 1, entry)

    def _end(self) -> None:
        entry = self.log_entry
        entry.state = self.final_state
        if not self.log_manager.delete_latest_stable_log():
            raise HyperspaceException("Could not delete latest stable log")
        self._save_entry(self.end_id, entry)
        self.log_manager.create_latest_stable_log(self.end_id)

    def _save_entry(self, log_id: int, entry: IndexLogEntry) -> None:
        entry.timestamp = int(time.time() * 1000)
        if not self.log_manager.write_log(log_id, entry):
            raise HyperspaceException(
                "Could not acquire proper state; another concurrent operation "
                f"may be running on this index (log id {log_id} exists)")
