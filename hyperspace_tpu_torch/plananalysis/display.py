"""Display modes for explain output (counterpart of
``hyperspace_tpu/plananalysis/display.py``): plain text, console and HTML
share one line buffer; each mode has its newline and the tags around a
highlighted (changed) plan line."""

from __future__ import annotations

import html as _html
from typing import List


class DisplayMode:
    """Rendering policy: newline and highlight delimiters."""

    new_line = "\n"
    highlight_begin = ""
    highlight_end = ""

    def escape(self, text: str) -> str:
        return text

    def wrap(self, body: str) -> str:
        return body


class PlainTextMode(DisplayMode):
    """No decoration: stable output for golden files and logs."""


class ConsoleMode(DisplayMode):
    """ANSI highlight for terminals (changed subtrees in yellow)."""

    highlight_begin = "\033[93m"
    highlight_end = "\033[0m"


class HTMLMode(DisplayMode):
    """Escaped text, <br> newlines and <b> highlights, inside <pre>."""

    new_line = "<br>"
    highlight_begin = "<b>"
    highlight_end = "</b>"

    def escape(self, text: str) -> str:
        return _html.escape(text)

    def wrap(self, body: str) -> str:
        return f"<pre>{body}</pre>"


_MODES = {
    "plaintext": PlainTextMode,
    "console": ConsoleMode,
    "html": HTMLMode,
}


def get_mode(name) -> DisplayMode:
    if isinstance(name, DisplayMode):
        return name
    cls = _MODES.get(str(name).lower())
    if cls is None:
        raise ValueError(f"Unknown display mode {name!r}; one of {sorted(_MODES)}")
    return cls()


class BufferStream:
    """Lines written through a DisplayMode."""

    def __init__(self, mode: DisplayMode):
        self.mode = mode
        self._lines: List[str] = []

    def write_line(self, text: str = "", highlight: bool = False) -> None:
        body = self.mode.escape(text)
        if highlight and text.strip():
            body = self.mode.highlight_begin + body + self.mode.highlight_end
        self._lines.append(body)

    def build(self) -> str:
        return self.mode.wrap(self.mode.new_line.join(self._lines))
