"""Conf-gated stdlib-HTTP exporter: /metrics (Prometheus) + /status (JSON).

Counterpart of ``spark_rapids_tpu/obs/server.py``: stdlib-only
(http.server), bound to localhost by default, and started as a daemon
thread so a dying process never hangs on it. ``/metrics`` serves
Prometheus text exposition 0.0.4 of the whole metric catalog (every
family renders its HELP/TYPE header even before the first sample);
``/status`` serves the operator view ``tools/tpu_top.py`` renders, with
the reference's key set: live queries with per-op progress, the HBM
watermark vs the shared budget, the ledger's heap block, the watchdog's
alert history. ``serve`` and ``program_cache`` are ``null``: the port
has no serving scheduler and no AOT program cache yet (ROADMAP.md item
26), and ``hbm.reserved_bytes`` is 0 (no admission reservations).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .progress import ProgressTracker
from .registry import MetricsRegistry
from .watchdog import Watchdog

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def build_status(registry: MetricsRegistry, progress: ProgressTracker,
                 watchdog: Optional[Watchdog]) -> dict:
    """The /status payload (also called directly by tests: everything in
    it must be plain-JSON serializable)."""
    from ..memory.catalog import BufferCatalog

    cat = BufferCatalog.get()
    m = cat.metrics
    budget = cat.budget
    hbm = {
        "device_bytes": cat.device_bytes,
        "peak_device_bytes": m.peak_device_bytes,
        "spilled_bytes": m.spilled_bytes,
        # no serving scheduler, so no admission reservations
        "reserved_bytes": 0,
        "budget_bytes": budget,
        "pressure": (cat.device_bytes / budget) if budget else None,
    }
    # environment provenance (envinfo): a live operator must be able to
    # tell at a glance whether the numbers on screen come from the card
    from .. import envinfo

    return {
        "queries": progress.status(),
        "queries_live": progress.live_count(),
        "env": envinfo.environment_info(),
        "hbm": hbm,
        # per-buffer HBM ledger (memory/ledger.py): live bytes broken
        # down by owning op, top owners, and the leak sentinel's tally —
        # all zeros while the ledger is unarmed
        "heap": cat.ledger.status_block(),
        "serve": None,
        "program_cache": None,
        "alerts": [a.to_json() for a in watchdog.alerts()]
        if watchdog is not None else [],
        "metrics": registry.snapshot(),
    }


class MetricsServer:
    """Daemon-thread HTTP server over one registry/progress/watchdog."""

    def __init__(self, registry: MetricsRegistry,
                 progress: ProgressTracker,
                 watchdog: Optional[Watchdog] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.progress = progress
        self.watchdog = watchdog
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, PROM_CONTENT_TYPE,
                                   outer.registry.render_prometheus()
                                   .encode())
                    elif path == "/status":
                        body = json.dumps(build_status(
                            outer.registry, outer.progress,
                            outer.watchdog)).encode()
                        self._send(200, "application/json", body)
                    elif path == "/healthz":
                        self._send(200, "text/plain", b"ok\n")
                    else:
                        self._send(404, "text/plain",
                                   b"try /metrics or /status\n")
                except Exception as e:  # pragma: no cover - scrape races
                    try:
                        self._send(500, "text/plain",
                                   f"error: {e}\n".encode())
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="srtpu-metrics-http", daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
