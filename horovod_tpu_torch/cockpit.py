"""Live cluster cockpit: a loopback HTTP endpoint streaming the
coordinator's causal step attribution.

Own copy of ``horovod_tpu/cockpit.py``, with the same routes, payloads and
SSE framing, so the repo's renderer ``tools/hvd_top.py`` reads either
package.  Rank 0 only, 127.0.0.1 only, off by default (``HOROVOD_COCKPIT=1``
turns it on): the same trust boundary as the autopilot's policy channel,
since anything that reaches the coordinator host's loopback interface is
already inside the job.  Four routes:

  /metrics   Prometheus text exposition (the ``hvd_*`` families
             ``hvd.metrics_prometheus()`` renders), scrape-ready.
  /state     One JSON snapshot (schema ``cockpit-state-v1``): elastic
             generation, per-tenant accounting, straggler windows,
             migration counters, and the last-N per-step phase breakdowns
             with dominant-phase / dominant-rank attribution.
  /history   The fleet-telemetry plane's long-horizon view
             (``fleethistory-v1``): downsampled sample rings plus the
             anomaly sentinel's log.
  /events    Server-sent events: one ``data:`` line per completed step
             (summaries diffed from the fleet view) plus any instants
             published by the runtime (autopilot decisions, migrations,
             aborts).  Clients that lag are dropped, never blocked on.

The server takes plain callables (``metrics_fn``/``state_fn``) instead of a
``HorovodContext`` so tests can drive it with a stub coordinator, and the
elastic driver can keep one port across re-formations: an SSE client
reconnects to the same address when a generation replaces rank 0's
process, or when a surviving rank 0 re-initializes in the same process
(its context stops the server in ``shutdown`` before the re-init binds the
port again).
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from .utils.logging import get_logger

log = get_logger()

# A lagging SSE client buffers this many events before being dropped: the
# cockpit must never apply backpressure to the training job.
_CLIENT_QUEUE_MAX = 256


class CockpitServer:
    """Loopback HTTP server for the live cockpit.

    ``metrics_fn() -> str`` renders the Prometheus exposition;
    ``state_fn() -> dict`` builds the /state snapshot (must contain a
    ``"steps"`` list of per-step dicts with a ``"step"`` key for the SSE
    differ to work).  ``port=0`` binds an ephemeral loopback port; pass the
    driver-assigned HOROVOD_COCKPIT_PORT to keep the address stable across
    elastic re-formations.  ``instants_fn() -> list`` (the port's addition)
    returns the runtime's instants since its last call; the poll loop
    publishes each one to the SSE clients.
    """

    def __init__(self, metrics_fn: Callable[[], str],
                 state_fn: Callable[[], dict],
                 port: int = 0, host: str = "127.0.0.1",
                 poll_interval_s: float = 0.25,
                 history_fn: Optional[Callable[[], dict]] = None,
                 instants_fn: Optional[Callable[[], List[dict]]] = None):
        self._metrics_fn = metrics_fn
        self._state_fn = state_fn
        self._history_fn = history_fn
        self._instants_fn = instants_fn
        self._host = host
        self._port = port
        self._poll_interval_s = poll_interval_s
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._clients_mu = threading.Lock()
        self._clients: List["queue.Queue[str]"] = []
        self._last_step_seen = -1

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        """Bind and serve; returns the bound port."""
        if self._httpd is not None:
            return self._port
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Route table lives in the closure so the handler stays stateless.
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    server._respond_text(self, server._safe_metrics(),
                                         "text/plain; version=0.0.4")
                elif path == "/state":
                    server._respond_text(
                        self, json.dumps(server._safe_state()),
                        "application/json")
                elif path == "/history":
                    server._respond_text(
                        self, json.dumps(server._safe_history()),
                        "application/json")
                elif path == "/events":
                    server._serve_sse(self)
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):  # noqa: D102
                pass  # stay out of the training job's stderr

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-cockpit",
            daemon=True)
        self._serve_thread.start()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="hvd-cockpit-poll", daemon=True)
        self._poll_thread.start()
        log.info("cockpit serving on http://%s:%d (/metrics /state /events)",
                 self._host, self._port)
        return self._port

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=2.0)
            self._serve_thread = None
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2.0)
            self._poll_thread = None
        with self._clients_mu:
            clients, self._clients = self._clients, []
        for q in clients:
            try:
                q.put_nowait("")  # sentinel: wake the writer so it exits
            except queue.Full:
                pass

    @property
    def port(self) -> int:
        return self._port

    # -- event publication --------------------------------------------------
    def publish(self, event: Dict) -> None:
        """Push one instant (autopilot / migrate / abort / ...) to every
        connected SSE client.  Never blocks: a full client queue drops the
        event for that client only."""
        line = json.dumps(event)
        with self._clients_mu:
            clients = list(self._clients)
        for q in clients:
            try:
                q.put_nowait(line)
            except queue.Full:
                pass

    # -- internals ----------------------------------------------------------
    def _safe_metrics(self) -> str:
        try:
            return self._metrics_fn()
        except Exception as exc:  # noqa: BLE001 - surface, don't crash
            return f"# cockpit metrics error: {exc}\n"

    def _safe_state(self) -> dict:
        try:
            return self._state_fn()
        except Exception as exc:  # noqa: BLE001
            return {"error": str(exc)}

    def _safe_history(self) -> dict:
        # No history_fn (stub coordinators, plane disabled) serves {} —
        # hvd_top.py renders the dimmed panel, never an error page.
        if self._history_fn is None:
            return {}
        try:
            return self._history_fn() or {}
        except Exception as exc:  # noqa: BLE001
            return {"error": str(exc)}

    def _safe_instants(self) -> List[dict]:
        if self._instants_fn is None:
            return []
        try:
            return list(self._instants_fn() or [])
        except Exception:  # noqa: BLE001 - the stream must go on
            return []

    def _poll_loop(self) -> None:
        """Publish the runtime's new instants, then diff the fleet step
        list and publish a summary per new step."""
        while not self._stop.wait(self._poll_interval_s):
            with self._clients_mu:
                has_clients = bool(self._clients)
            if not has_clients:
                continue
            for event in self._safe_instants():
                self.publish(event)
            state = self._safe_state()
            for step in state.get("steps") or []:
                sid = step.get("step", -1)
                if sid > self._last_step_seen:
                    self._last_step_seen = sid
                    self.publish(dict(step, type="step"))

    def _respond_text(self, handler: BaseHTTPRequestHandler, body: str,
                      content_type: str) -> None:
        data = body.encode()
        handler.send_response(200)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _serve_sse(self, handler: BaseHTTPRequestHandler) -> None:
        q: "queue.Queue[str]" = queue.Queue(maxsize=_CLIENT_QUEUE_MAX)
        with self._clients_mu:
            self._clients.append(q)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.end_headers()
            # An immediate hello so clients can tell "connected" from
            # "waiting for the first step".
            handler.wfile.write(b": cockpit stream open\n\n")
            handler.wfile.flush()
            while not self._stop.is_set():
                try:
                    line = q.get(timeout=1.0)
                except queue.Empty:
                    # Keep-alive comment: lets dead connections surface as
                    # write errors instead of lingering forever.
                    handler.wfile.write(b": keep-alive\n\n")
                    handler.wfile.flush()
                    continue
                if not line:  # stop() sentinel
                    break
                handler.wfile.write(b"data: " + line.encode() + b"\n\n")
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away; normal
        finally:
            with self._clients_mu:
                if q in self._clients:
                    self._clients.remove(q)


# Step-trace plane tag -> /state name (step_trace.h: -1 unknown, 0
# eager, 1 gspmd).  A fleet record without a "plane" key degrades to "?"
# as -1 does.
_PLANE_NAMES = {0: "eager", 1: "gspmd"}


def _tag_steps_with_plane(fleet: List[dict]) -> List[dict]:
    """Normalize each fleet record's numeric plane tag to its name,
    tolerating records (old .so, old coordinator) without one."""
    out = []
    for f in fleet:
        f = dict(f or {})
        f["plane"] = _PLANE_NAMES.get(f.get("plane"), "?")
        out.append(f)
    return out


def build_state_fn(ctx) -> Callable[[], dict]:
    """The production /state builder over a ``HorovodContext``: elastic
    generation, tenants, straggler windows, migration counters, and the
    fleet's last-N step breakdowns (rank 0's step-trace ring), each
    tagged with the data plane that ran it."""
    import os

    def state() -> dict:
        metrics = {}
        trace = {}
        try:
            metrics = ctx.core.metrics() or {}
        except Exception:  # noqa: BLE001 - snapshot must not crash
            pass
        try:
            trace = ctx.core.step_trace() or {}
        except Exception:  # noqa: BLE001
            pass
        try:
            gen = int(os.environ.get("HOROVOD_ELASTIC_GENERATION", "0"))
        except ValueError:
            gen = 0
        return {
            "schema": "cockpit-state-v1",
            "rank": ctx.cfg.rank,
            "world": ctx.cfg.size,
            "elastic_generation": gen,
            "tenants": metrics.get("tenants") or {},
            "straggler_report": metrics.get("straggler_report") or {},
            "cluster": metrics.get("cluster") or [],
            "migration": {
                k: metrics.get(k, 0)
                for k in ("migrate_events_total", "migrate_bytes_total",
                          "migrate_fallbacks_total")
            },
            "steps": _tag_steps_with_plane(trace.get("fleet") or []),
            "phases": trace.get("phases") or [],
        }

    return state


class AutopilotInstants:
    """The autopilot decisions the coordinator recorded since the last
    call, as SSE instants.

    The reference's cockpit documents "instants published by the runtime
    (autopilot decisions, ...)" but nothing publishes them: a decision
    reaches only the flight recorder, the ``autopilot_decisions_total``
    counter and the timeline.  This reads the flight ring (type
    ``autopilot``: a = action code, b = subject rank) whenever the counter
    moved, and returns each new record once.  Records older than the
    watcher (an earlier generation's) are not replayed."""

    def __init__(self, core):
        self._core = core
        try:
            self._count = self._decisions()
            self._seq = max((int(row[1]) for row in self._rows()),
                            default=-1)
        except Exception:  # noqa: BLE001 - a core without the records
            self._count, self._seq = 0, -1

    def _decisions(self) -> int:
        counters = (self._core.metrics() or {}).get("counters") or {}
        return int(counters.get("autopilot_decisions_total", 0))

    def _rows(self) -> List[list]:
        rec = self._core.flight_record() or {}
        code = next((int(k) for k, v in (rec.get("types") or {}).items()
                     if v == "autopilot"), None)
        return [row for row in rec.get("events") or [] if row[2] == code]

    def __call__(self) -> List[dict]:
        count = self._decisions()
        if count == self._count:
            return []
        self._count = count
        from .runner.autopilot import ACTION_NAMES

        out = []
        for ts_us, seq, _, _, action, rank in self._rows():
            if seq <= self._seq:
                continue
            self._seq = seq
            out.append({"type": "autopilot",
                        "action": ACTION_NAMES.get(action, "unknown"),
                        "action_code": action, "rank": rank, "seq": seq,
                        "ts_us": ts_us})
        return out


def maybe_start_cockpit(ctx) -> Optional[CockpitServer]:
    """Start the cockpit when configured (rank 0 + HOROVOD_COCKPIT on);
    returns None otherwise.  Failure to bind is a warning, never fatal —
    observability must not take down the job."""
    cfg = ctx.cfg
    if not getattr(cfg, "cockpit_enabled", False) or cfg.rank != 0:
        return None

    def metrics_text() -> str:
        from .utils.metrics import render_prometheus
        return render_prometheus(ctx.core.metrics() or {})

    def history() -> dict:
        return ctx.core.fleet_history() or {}

    server = CockpitServer(metrics_text, build_state_fn(ctx),
                           port=getattr(cfg, "cockpit_port", 0) or 0,
                           history_fn=history,
                           instants_fn=AutopilotInstants(ctx.core))
    try:
        server.start()
    except OSError as exc:
        log.warning("cockpit failed to bind 127.0.0.1:%s (%s); disabled",
                    cfg.cockpit_port, exc)
        return None
    return server
