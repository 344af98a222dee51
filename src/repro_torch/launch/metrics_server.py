"""Background HTTP thread serving the Prometheus-style text exposition
(port of ``repro.launch.metrics_server``).

Pass ``metrics_port=<port>`` to ``GNNServer`` and a daemon
``ThreadingHTTPServer`` starts next to the serving stack on 127.0.0.1,
answering

* ``GET /metrics``  — ``MetricsRegistry.render()`` (pull callbacks run per
  scrape, so the plan counters and cache infos are fresh);
* ``GET /healthz``  — ``ok\\n``, for liveness probes.

``port=0`` binds an ephemeral port; the real one is ``server.port``.
Stdlib only.

``python -m repro_torch.launch.metrics_server --smoke`` is the self-test:
stand up a registry with one of each instrument kind, scrape it over HTTP,
and assert every family round-trips through ``parse_exposition``.
"""
from __future__ import annotations

import argparse
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

__all__ = ["MetricsServer"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve ``render()`` output from a daemon thread until ``close()``."""

    def __init__(self, render: Callable[[], str], *, port: int = 0,
                 host: str = "127.0.0.1"):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] == "/healthz":
                    body = b"ok\n"
                elif self.path.split("?", 1)[0] == "/metrics":
                    try:
                        body = outer.render().encode()
                    except Exception as e:  # noqa: BLE001 — scrape must
                        self.send_error(500, str(e))  # never wedge serving
                        return
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr noise
                pass

        self.render = render
        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}/metrics"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="metrics-server")
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


# ---------------------------------------------------------------------------
# Self-test: registry → HTTP → parse → assert families
# ---------------------------------------------------------------------------

def smoke() -> int:
    import urllib.request

    from repro_torch.serve.metrics import MetricsRegistry, parse_exposition

    reg = MetricsRegistry()
    reg.counter("requests_total", "smoke counter").inc(3, outcome="served")
    reg.gauge("lane", "smoke gauge").set(2.0, lane="0", field="queue_depth")
    reg.histogram("request_latency_seconds", "smoke histogram").observe(
        0.012, exemplar="smoke-1", **{"class": "interactive"})
    reg.connect_kernel_stats()
    srv = MetricsServer(reg.render, port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(
                srv.url.replace("/metrics", "/healthz"), timeout=10) as resp:
            assert resp.read() == b"ok\n"
    finally:
        srv.close()
    fams = parse_exposition(text)
    required = ["neurachip_requests_total", "neurachip_lane",
                "neurachip_request_latency_seconds"]
    missing = [f for f in required if not fams.get(f, {}).get("samples")]
    if missing:
        print(f"metrics smoke FAILED: missing families {missing}")
        return 1
    hist = fams["neurachip_request_latency_seconds"]
    exemplars = [ex for (_n, _l, _v, ex) in hist["samples"] if ex]
    assert exemplars and exemplars[0][0] == "smoke-1", "exemplar lost"
    print(f"metrics smoke OK: {len(fams)} families, "
          f"{sum(len(f['samples']) for f in fams.values())} samples "
          f"scraped from {srv.url}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="stand up a registry, scrape it over HTTP, "
                         "assert families round-trip")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
