"""Web status page (reference ``--web-status`` flag, SURVEY.md §5.5
``[verify]`` — present in some revisions).  Serves a small HTML summary
and a JSON endpoint from the on-disk experiment state.

Copy of ``spearmint_tpu/harness/status.py`` on the port's
``ExperimentGrid``: the same page and the same JSON."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from spearmint_tpu_torch.store.experiment import STATE_NAMES, ExperimentGrid


def _snapshot(expt_dir: str) -> dict:
    grid = ExperimentGrid(expt_dir)
    counts = {name: int(np.sum(grid.status == i))
              for i, name in enumerate(STATE_NAMES)}
    best_val, best_id = grid.get_best()
    return {
        "counts": counts,
        "best_value": None if best_id < 0 else best_val,
        "best_job": best_id,
        "best_params": None if best_id < 0 else grid.unit_to_list(best_id),
        "grid_points": int(grid.grid.shape[0]),
    }


def serve_status(expt_dir: str, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            try:
                snap = _snapshot(expt_dir)
            except Exception as e:  # racing a grid write
                self.send_response(503)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            if self.path.startswith("/json"):
                body = json.dumps(snap, indent=1).encode()
                ctype = "application/json"
            else:
                rows = "".join(
                    f"<tr><td>{k}</td><td>{v}</td></tr>"
                    for k, v in snap["counts"].items()
                )
                body = (
                    "<html><body><h2>spearmint-tpu experiment</h2>"
                    f"<p>best: {snap['best_value']} "
                    f"(job {snap['best_job']}, "
                    f"params {snap['best_params']})</p>"
                    f"<table border=1>{rows}</table>"
                    "<p><a href='/json'>json</a></p></body></html>"
                ).encode()
                ctype = "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
