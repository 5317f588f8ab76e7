"""OpenMetrics text exposition of the process metrics registry
(counterpart of ``hyperspace_tpu/telemetry/exposition.py``).

- :func:`flatten`: the numeric leaves of a ``Hyperspace.metrics()``
  snapshot as one flat ``{dotted.path: number}`` dict (also the engine of
  ``Hyperspace.metrics_delta()``);
- :func:`render_text`: OpenMetrics text exposition (the Prometheus scrape
  format): counters as ``_total``-suffixed counter families, gauges as
  gauges, histograms as per-quantile gauges, every collector's numeric
  leaves as gauges, terminated by ``# EOF``;
- :func:`start_http_exporter` / :func:`stop_http_exporter`: an opt-in
  scrape endpoint (``GET /metrics``) on 127.0.0.1 only. Its listener
  thread comes from parallel/io.py's daemon spawner.

Metric names come from the frozen telemetry/metric_names.py registry;
the exposition sanitizes them to the OpenMetrics grammar (``hst_`` prefix,
dots to underscores).
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "hst_"


def _sanitize(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    return _PREFIX + out


def flatten(snapshot: dict, prefix: str = "") -> Dict[str, float]:
    """Every numeric leaf of a (possibly nested) snapshot dict as
    ``{dotted.path: float}``. Booleans count (0/1); strings, lists and
    None are skipped — they are labels, not measurements."""
    out: Dict[str, float] = {}
    for key, value in snapshot.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, bool):
            out[path] = float(value)
        elif isinstance(value, (int, float)):
            out[path] = float(value)
        elif isinstance(value, dict):
            out.update(flatten(value, path))
    return out


def delta(before: dict, after: dict) -> Dict[str, float]:
    """Numeric leaves that CHANGED between two snapshots (after -
    before; keys that vanished count as going to 0)."""
    b = flatten(before)
    a = flatten(after)
    out: Dict[str, float] = {}
    for k, v in a.items():
        d = v - b.get(k, 0.0)
        if d != 0.0:
            out[k] = d
    for k, v in b.items():
        if k not in a and v != 0.0:
            out[k] = -v
    return out


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_text(snapshot: dict, worker: str = "") -> str:
    """OpenMetrics text exposition of one registry/metrics() snapshot.

    Family names are first-wins in emission order (registry counters,
    then gauges, then histogram quantiles, then collector leaves), so a
    family is never emitted twice (the OpenMetrics grammar forbids it).

    A non-empty ``worker`` stamps every sample with a ``worker="<id>"``
    label (the cluster identity that keeps two workers' series apart);
    empty, the text is the unlabelled format."""
    lines = []
    seen = set()
    labels = f'{{worker="{_escape_label(worker)}"}}' if worker else ""

    def emit(name: str, mtype: str, value: float,
             help_text: str = "") -> None:
        if name in seen:
            return
        seen.add(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        sample = name + ("_total" if mtype == "counter" else "")
        lines.append(f"{sample}{labels} {_fmt(value)}")

    for name in sorted(snapshot.get("counters", {})):
        emit(_sanitize(name), "counter",
             snapshot["counters"][name],
             f"Process counter {name}")
    for name in sorted(snapshot.get("gauges", {})):
        emit(_sanitize(name), "gauge", snapshot["gauges"][name],
             f"Process gauge {name}")
    for name in sorted(snapshot.get("histograms", {})):
        hist = snapshot["histograms"][name] or {}
        for leaf, value in sorted(flatten(hist).items()):
            emit(_sanitize(f"{name}.{leaf}"), "gauge", value,
                 f"Live histogram {name} {leaf}")
    collectors = snapshot.get("collectors", {}) or {}
    for cname in sorted(collectors):
        payload = collectors[cname]
        if not isinstance(payload, dict):
            continue
        for leaf, value in sorted(flatten(payload).items()):
            emit(_sanitize(f"{cname}.{leaf}"), "gauge", value,
                 f"Collector {cname} {leaf}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def registry_text() -> str:
    """Exposition of the bare process registry (no session-scoped
    collectors): what the HTTP endpoint serves when its governing session
    is gone."""
    from .metrics import get_registry
    return render_text(get_registry().snapshot())


# ---------------------------------------------------------------------------
# Opt-in localhost HTTP scrape endpoint.
# ---------------------------------------------------------------------------

_SERVER = None
_SERVER_LOCK = threading.Lock()

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _session_text(session) -> str:
    """The full Hyperspace.metrics_text() surface when the governing
    session is alive (weakly held), else the bare registry."""
    if session is None:
        return registry_text()
    from ..api import Hyperspace
    return Hyperspace(session).metrics_text()


def start_http_exporter(session, port: Optional[int] = None) -> int:
    """Start (or return) the process scrape endpoint on
    ``127.0.0.1:<port>`` — ``port=None`` reads
    ``telemetry.export.httpPort`` and raises while it is 0 (off, the
    default); an EXPLICIT ``port=0`` binds an ephemeral port. Returns
    the bound port. Localhost-only by construction: exposure beyond the
    host is a reverse proxy's job, not an embedded server's."""
    import weakref
    from http.server import BaseHTTPRequestHandler, HTTPServer

    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            # Idempotent while up: the live endpoint's port, whatever
            # this call asked for (one exporter per process).
            return _SERVER.server_address[1]
        if port is None:
            port = session.hs_conf.telemetry_export_http_port()
            if port == 0:
                # Conf 0 means OFF (the documented default) — only an
                # EXPLICIT port=0 argument asks for an ephemeral bind.
                from ..exceptions import HyperspaceException
                raise HyperspaceException(
                    "hyperspace.tpu.telemetry.export.httpPort is 0 "
                    "(off); set it, or pass an explicit port "
                    "(0 = ephemeral) to serve_metrics")

        session_ref = weakref.ref(session)

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server contract)
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    body = _session_text(session_ref()).encode("utf-8")
                except Exception as e:  # a broken collector: say so
                    self.send_error(500, f"exposition failed: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam stderr

        server = HTTPServer(("127.0.0.1", int(port)), _Handler)
        from ..parallel import io as pio
        pio.spawn_daemon("hst-metrics-http", server.serve_forever)
        _SERVER = server
        return server.server_address[1]


def stop_http_exporter() -> None:
    """Shut the scrape endpoint down (idempotent)."""
    global _SERVER
    with _SERVER_LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.shutdown()
        server.server_close()
