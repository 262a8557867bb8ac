"""Telemetry HTTP server: /metrics, /healthz, /slo, /debug/traces,
/debug/profile (DESIGN.md §8.5).

A stdlib ``ThreadingHTTPServer`` on a daemon thread — no new
dependencies — turning the in-process ``Obs`` bundle into the
scrapeable surface a multi-process cluster needs (ROADMAP "scale-out"):

- ``GET /metrics``   Prometheus text exposition, rolling-window gauges
  included. Rendering is snapshot-atomic per instrument (one locked
  ``state()`` read per histogram), so a scrape never observes a torn
  registry — a ``_count`` that disagrees with its bucket vector.
- ``GET /healthz``   JSON aggregation of registered health sources
  (ShardRouter replica rotation, ingest WAL/compactor liveness).
  Status ``ok``/``degraded`` answer 200, ``down`` answers 503, so a
  load balancer can act on the code alone.
- ``GET /slo``       JSON of every objective's burn state (§8.4).
- ``GET /debug/traces``  JSON dump of the tracer's retained traces.
- ``GET /debug/profile?ms=N``  opt-in ``torch.profiler`` capture: writes
  a trace of the next N ms (default 500, clamped to 1-10 000) under the
  server's ``profile_dir``. 409 when profiling wasn't enabled, 423
  while another capture is running, 500 when the capture fails.

Handlers only *read* instruments (capture aside); nothing here is on a
query path. The server binds loopback by default — operators proxy it,
the repo never exposes raw telemetry on all interfaces by accident.

A copy of ``repro.obs.server``: the same routes, status codes and JSON
payloads. Where it differs:

- ``/debug/profile`` is a ``torch.profiler`` capture in place of
  ``jax.profiler.trace``. Its activities are the CPU, plus CUDA when the
  server's ``device`` is a card (``start_telemetry`` passes the
  searcher's). The trace is a Chrome trace file,
  ``profile_dir/torch-<pid>-<ns>.pt.trace.json``, and the answer adds its
  path (``file``) and the capturing thread's native id (``thread``) to
  the reference's ``captured_ms`` and ``dir``.
- Which threads a capture covers. When the process's first profiler
  session starts on a thread other than the one where Kineto registered
  its client (the main thread), it prints ``External init callback must
  run in same thread as registerClient`` and records none of the
  process's CPU ops. So a server with a ``profile_dir`` runs one empty
  session on the thread that builds it (``init_profiler``, once a
  process for each set of activities; build it on the main thread), and
  every capture asks for ``profile_all_threads``: it records the torch
  ops of every thread of the process (the service's batcher, the
  router's shard pool, the prefetchers' loaders), and CUPTI records the
  card's kernels and copies whoever launched them.
- A session starts and stops with ``repro_torch.device.LAUNCHES`` held
  alone: no engine upload, launch or readback in flight and the card's
  queue drained. Started or stopped while other threads launch, a
  session on the card records no kernel in about one capture of four to
  eight (ROADMAP C16). Device work outside the search engine (the LM's)
  does not hold the gate.
- The ingest health probe reports a store's root as a string
  (``os.fspath``). The reference puts ``store.root`` in the JSON as it
  was given, so a store opened from a ``pathlib.Path`` makes every
  ``/healthz`` answer 500 (``TypeError``: not JSON serializable) once an
  ingest pipeline is attached, that is, exactly while the store is
  written to (ROADMAP C14).
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.device import LAUNCHES

HealthSource = Callable[[], Dict]

_STATUS_RANK = {"ok": 0, "degraded": 1, "down": 2}

# activity sets (tuples of names) whose first profiler session this
# process has run; Kineto's client registration is process-wide
_PROFILER_READY: set = set()
_PROFILER_LOCK = threading.Lock()


def aggregate_health(components: Dict[str, Dict]) -> str:
    """Worst-of component statuses (missing/invalid counts as down)."""
    worst = "ok"
    for comp in components.values():
        s = comp.get("status", "down")
        if s not in _STATUS_RANK:       # an unknown status is not healthy
            s = "down"
        if _STATUS_RANK[s] > _STATUS_RANK[worst]:
            worst = s
    return worst


def router_health_source(router) -> HealthSource:
    """ShardRouter replica rotation -> health component. A shard with
    every replica out of rotation cannot serve: ``down``. Any replica
    out while a sibling covers it: ``degraded``."""
    def probe() -> Dict:
        health = router.health()          # [[in_rotation per replica]]
        dead_shards = [s for s, row in enumerate(health) if not any(row)]
        down_reps = sum(not ok for row in health for ok in row)
        status = ("down" if dead_shards
                  else "degraded" if down_reps else "ok")
        return {"status": status,
                "shards": len(health),
                "replicas_down": down_reps,
                "dead_shards": dead_shards,
                "failovers": router.failovers,
                "rotation": health}
    return probe


def ingest_health_source(pipelines_fn: Callable[[], List]) -> HealthSource:
    """Ingest pipeline liveness: WAL open + compactor thread alive for
    every live pipeline. ``pipelines_fn`` is called per probe so a
    pipeline attached after the server started is still covered."""
    def probe() -> Dict:
        pipes = [p for p in pipelines_fn() if p is not None]
        detail = []
        status = "ok"
        for p in pipes:
            closed = bool(getattr(p, "_closed", False))
            compactor = getattr(p, "_compactor", None)
            wants_compactor = bool(getattr(p.cfg, "auto_compact", False))
            compactor_ok = (not wants_compactor
                            or (compactor is not None and
                                compactor.is_alive()))
            if closed or not compactor_ok:
                status = "down" if closed else "degraded"
            root = os.fspath(getattr(p.store, "root", "?"))
            detail.append({"root": root,
                           "closed": closed,
                           "compactor_alive": bool(
                               compactor is not None and
                               compactor.is_alive()),
                           "wal_seq": getattr(p.wal, "last_seq", None),
                           "memtable_docs": len(p.memtable)})
        return {"status": status, "pipelines": len(pipes),
                "detail": detail}
    return probe


def register_searcher_health(server: "TelemetryServer", searcher) -> None:
    """Wire whichever health surfaces ``searcher`` exposes: a cluster
    session's router, or a store session's ingest pipeline(s)."""
    router = getattr(searcher, "router", None)
    if router is not None:
        server.add_health_source("router", router_health_source(router))
        server.add_health_source(
            "ingest", ingest_health_source(router.ingest_pipelines))
    elif hasattr(searcher, "ingest"):
        server.add_health_source(
            "ingest",
            ingest_health_source(lambda: [getattr(searcher, "ingest",
                                                  None)]))


def profiler_activities(device=None) -> List:
    """What a capture records: the CPU, plus CUDA when ``device`` is a
    card."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def init_profiler(activities, device=None) -> None:
    """Run the process's first profiler session for ``activities`` on the
    calling thread, once, with the launch gate held alone (``device``'s
    queue drained): on the thread where Kineto registered its client (the
    main thread, where torch was loaded), a capture later started on any
    other thread (an HTTP handler's) records every thread's work without
    the ``External init callback`` error. On the card the first session
    also loads CUPTI, which takes seconds."""
    import torch.profiler
    key = tuple(sorted(a.name for a in activities))
    with _PROFILER_LOCK:
        if key in _PROFILER_READY:
            return
        with LAUNCHES.quiesced(device):
            with torch.profiler.profile(activities=activities):
                pass
        _PROFILER_READY.add(key)


class TelemetryServer:
    """The live scrape surface for one ``Obs`` bundle. ``port=0`` binds
    an ephemeral port (tests); the bound one is ``self.port``. With a
    ``profile_dir``, the profiler is initialised on the calling thread
    (``init_profiler``) for ``device``'s activities."""

    def __init__(self, obs, *, host: str = "127.0.0.1", port: int = 0,
                 slo_monitor=None, profile_dir: Optional[str] = None,
                 prefix: str = "repro", device=None):
        self.obs = obs
        self.slo_monitor = slo_monitor
        self.profile_dir = profile_dir
        self.prefix = prefix
        self._device = device
        self._activities = profiler_activities(device)
        if profile_dir:
            init_profiler(self._activities, device)
        self._health_sources: Dict[str, HealthSource] = {}
        self._health_lock = threading.Lock()
        self._profile_lock = threading.Lock()
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet: scrapes are periodic
                pass

            def do_GET(self):
                try:
                    server._route(self)
                except BrokenPipeError:     # scraper went away mid-write
                    pass
                except Exception as e:      # a probe must never kill the
                    try:                    # serving thread
                        self.send_error(500, explain=repr(e))
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"telemetry-:{self.port}")
        self._thread.start()

    # -- wiring --------------------------------------------------------
    def add_health_source(self, name: str, source: HealthSource) -> None:
        with self._health_lock:
            self._health_sources[name] = source

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing -------------------------------------------------------
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(h.path)
        path = parsed.path.rstrip("/") or "/"
        if path == "/metrics":
            body = self.obs.registry.to_prometheus(
                prefix=self.prefix, include_windows=True)
            self._send(h, 200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            status, payload = self.healthz()
            self._send_json(h, 200 if status != "down" else 503, payload)
        elif path == "/slo":
            self._send_json(h, 200, self.slo_snapshot())
        elif path == "/debug/traces":
            self._send_json(h, 200, {
                "schema": "repro-traces-v1",
                "traces": self.obs.tracer.export()})
        elif path == "/debug/profile":
            self._profile(h, parse_qs(parsed.query))
        else:
            self._send_json(h, 404, {
                "error": f"no route {path!r}",
                "routes": ["/metrics", "/healthz", "/slo",
                           "/debug/traces", "/debug/profile"]})

    # -- endpoint bodies (callable without HTTP for tests/summaries) ---
    def healthz(self):
        with self._health_lock:
            sources = dict(self._health_sources)
        components: Dict[str, Dict] = {}
        for name, probe in sources.items():
            try:
                components[name] = probe()
            except Exception as e:          # a broken probe is itself a
                components[name] = {"status": "down",   # health signal
                                    "error": repr(e)}
        status = aggregate_health(components) if components else "ok"
        return status, {"status": status, "components": components}

    def slo_snapshot(self) -> Dict:
        if self.slo_monitor is None:
            return {"slos": [], "note": "no SLO objectives configured"}
        return {"slos": [s.to_dict() for s in self.slo_monitor.evaluate()]}

    def _profile(self, h, query: Dict) -> None:
        if not self.profile_dir:
            self._send_json(h, 409, {
                "error": "profiling disabled: start the server with "
                         "profile_dir (search_serve --profile-dir)"})
            return
        ms = max(1, min(int(query.get("ms", ["500"])[0]), 10_000))
        if not self._profile_lock.acquire(blocking=False):
            self._send_json(h, 423, {"error": "capture already running"})
            return
        try:
            path = self.capture(ms)
        except Exception as e:
            self._send_json(h, 500, {"error": f"profiler failed: {e!r}"})
            return
        finally:
            self._profile_lock.release()
        self._send_json(h, 200, {"captured_ms": ms, "dir": self.profile_dir,
                                 "file": path,
                                 "thread": threading.get_native_id()})

    def capture(self, ms: int) -> str:
        """One ``torch.profiler`` session of ``ms`` milliseconds over
        every thread of the process, written as a Chrome trace under
        ``profile_dir``; returns the file's path. The session starts and
        stops with the launch gate held alone (ROADMAP C16). The caller
        holds the capture lock."""
        import torch.profiler
        os.makedirs(self.profile_dir, exist_ok=True)
        name = f"torch-{os.getpid()}-{time.time_ns()}.pt.trace.json"
        path = os.path.join(self.profile_dir, name)
        prof = torch.profiler.profile(
            activities=self._activities,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
        with LAUNCHES.quiesced(self._device):
            prof.start()
        try:
            time.sleep(ms / 1e3)
        finally:
            with LAUNCHES.quiesced(self._device):
                prof.stop()
        prof.export_chrome_trace(path)
        return path

    # -- plumbing ------------------------------------------------------
    @staticmethod
    def _send(h, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    @classmethod
    def _send_json(cls, h, code: int, payload) -> None:
        cls._send(h, code, json.dumps(payload, indent=1),
                  "application/json")


def searcher_device(searcher):
    """The device a serving target scores on: an engine's ``device``, a
    store session's engine's or a cluster session's router's (None when
    it has none)."""
    for obj in (searcher, getattr(searcher, "engine", None),
                getattr(searcher, "router", None)):
        dev = getattr(obj, "device", None)
        if dev is not None:
            return dev
    return None


def start_telemetry(searcher, *, port: int = 0, host: str = "127.0.0.1",
                    slo_monitor=None,
                    profile_dir: Optional[str] = None) -> TelemetryServer:
    """One-call wiring for any serving target: build a server on the
    searcher's ``Obs`` bundle and register its health surfaces."""
    obs = getattr(searcher, "obs", None)
    if obs is None:
        raise ValueError("searcher has no obs bundle to serve")
    server = TelemetryServer(obs, host=host, port=port,
                             slo_monitor=slo_monitor,
                             profile_dir=profile_dir,
                             device=searcher_device(searcher))
    register_searcher_health(server, searcher)
    return server
