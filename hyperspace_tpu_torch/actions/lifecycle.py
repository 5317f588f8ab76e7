"""State-transition actions (counterpart of
``hyperspace_tpu/actions/lifecycle.py``):

  Delete  -- ACTIVE → DELETED (soft; queries stop considering the index)
  Restore -- DELETED → ACTIVE
  Vacuum  -- DELETED → DOESNOTEXIST (removes every index data version)
  Cancel  -- a transient state left by an action that died (a refresh
             stuck in REFRESHING, say) back to the last stable entry
"""

from __future__ import annotations

from typing import Optional

from ..exceptions import HyperspaceException
from ..index.constants import STABLE_STATES, States
from ..index.data_manager import IndexDataManager
from ..index.log_entry import IndexLogEntry
from ..index.log_manager import IndexLogManager
from ..telemetry import events as _ev
from .action import Action


class _TransitionAction(Action):
    """An action whose entry is the latest stable entry with a new state."""

    expected_states = ()

    def __init__(self, session, log_manager: IndexLogManager,
                 data_manager: Optional[IndexDataManager] = None):
        super().__init__(session, log_manager)
        self.data_manager = data_manager
        self._prev: Optional[IndexLogEntry] = None

    @property
    def prev_entry(self) -> IndexLogEntry:
        if self._prev is None:
            entry = self.log_manager.get_latest_stable_log()
            if entry is None:
                raise HyperspaceException("No stable log entry found")
            self._prev = entry
        return self._prev

    def validate(self) -> None:
        if self.prev_entry.state not in self.expected_states:
            raise HyperspaceException(
                f"{type(self).__name__} is only supported in states "
                f"{self.expected_states}; index is {self.prev_entry.state}")

    @property
    def log_entry(self) -> IndexLogEntry:
        return IndexLogEntry.from_json(self.prev_entry.to_json())

    def op(self) -> None:
        pass


class DeleteAction(_TransitionAction):
    transient_state = States.DELETING
    final_state = States.DELETED
    expected_states = (States.ACTIVE,)

    def event(self, message: str) -> _ev.DeleteActionEvent:
        return _ev.DeleteActionEvent(message=message, index_name=self.prev_entry.name)


class RestoreAction(_TransitionAction):
    transient_state = States.RESTORING
    final_state = States.ACTIVE
    expected_states = (States.DELETED,)

    def event(self, message: str) -> _ev.RestoreActionEvent:
        return _ev.RestoreActionEvent(message=message, index_name=self.prev_entry.name)


class VacuumAction(_TransitionAction):
    transient_state = States.VACUUMING
    final_state = States.DOESNOTEXIST
    expected_states = (States.DELETED,)

    def op(self) -> None:
        for version in self.data_manager.get_all_version_ids():
            self.data_manager.delete(version)

    def event(self, message: str) -> _ev.VacuumActionEvent:
        return _ev.VacuumActionEvent(message=message, index_name=self.prev_entry.name)


class CancelAction(_TransitionAction):
    """Roll a stuck transient state back to the last stable entry: begin
    and end write the stable entry with its own state as the final one,
    so latestStable points past the wreck."""

    transient_state = States.CANCELLING
    final_state = ""  # the stable entry's state, set in validate().

    @property
    def prev_entry(self) -> IndexLogEntry:
        if self._prev is None:
            entry = self.log_manager.get_latest_stable_log()
            if entry is None:
                # A first create that never committed: the only stable
                # state to return to is DOESNOTEXIST.
                latest = self.log_manager.get_latest_log()
                if latest is None:
                    raise HyperspaceException("No log entry found for index")
                entry = IndexLogEntry.from_json(latest.to_json())
                entry.state = States.DOESNOTEXIST
            self._prev = entry
        return self._prev

    def validate(self) -> None:
        latest = self.log_manager.get_latest_log()
        if latest is None:
            raise HyperspaceException("No log entry found for index")
        if latest.state in STABLE_STATES:
            raise HyperspaceException(
                f"Cancel is not needed: index is in stable state {latest.state}")
        self.final_state = self.prev_entry.state

    def event(self, message: str) -> _ev.CancelActionEvent:
        return _ev.CancelActionEvent(message=message, index_name=self.prev_entry.name)
