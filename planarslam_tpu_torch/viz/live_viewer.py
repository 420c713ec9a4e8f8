"""Live map viewer — the reference Viewer's RUNTIME role.

The reference opens a Pangolin window on a thread and redraws the map every
frame (`src/Viewer.cc:37-165`, MapDrawer passes `src/MapDrawer.cc:29-233`);
a headless TPU host has no GL, so the live view is a localhost HTTP
endpoint instead: `LiveViewer` serves the interactive canvas viewer
(viz/html_viewer.py) at `http://127.0.0.1:<port>/` and the page polls
`/map.json` once a second, redrawing IN PLACE (camera pose, layer toggles
and zoom survive updates). The tracking loop calls `update(map, traj)`
whenever the map changes (every keyframe is the natural cadence — the same
granularity at which the reference's MapDrawer sees new content).

Zero dependencies: python stdlib http.server on a daemon thread; payload
snapshots are taken synchronously in `update` (numpy reads of the host map
arrays, ~1 ms) so the serving thread never touches SLAM state.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from planarslam_tpu_torch.viz.html_viewer import map_payload, render_html

_EMPTY = {"points": [], "lines": [], "planes": [], "frusta": [],
          "covis": [], "loops": [], "traj": []}


class LiveViewer:
    def __init__(self, port: int = 8765, host: str = "127.0.0.1"):
        self._payload = json.dumps(_EMPTY).encode()
        self._html = render_html(_EMPTY, live=True).encode()
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body, ctype = viewer._html, "text/html"
                elif path == "/map.json":
                    with viewer._lock:
                        body = viewer._payload
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]  # resolved if port=0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def update(self, slam_map, trajectory: np.ndarray | None = None) -> None:
        """Snapshot the current map for the next poll (call per keyframe)."""
        payload = json.dumps(map_payload(slam_map, trajectory)).encode()
        with self._lock:
            self._payload = payload

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
