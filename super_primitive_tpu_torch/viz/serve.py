"""Small standard-library server for the live viewer.

    python -m super_primitive_tpu_torch.viz.serve RUN_DIR [--port 8765]

Port of ``super_primitive_tpu/viz/serve.py``.  Serves the run directory
(``live.html`` and the ``live.json`` that ``viz.live.LiveViz`` writes) and
turns the page's ``POST /pause`` into the ``pause`` marker file that
:meth:`LiveViz.checkpoint` polls: a POST creates it, the next removes it.
Every response carries ``Cache-Control: no-store``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

from .live import PAUSE_MARKER


class LiveHandler(SimpleHTTPRequestHandler):
    def do_POST(self):
        if self.path.lstrip("/").split("?")[0] != "pause":
            self.send_error(404)
            return
        marker = os.path.join(self.directory, PAUSE_MARKER)
        if os.path.exists(marker):
            os.remove(marker)
            paused = False
        else:
            open(marker, "w").close()
            paused = True
        body = json.dumps({"paused": paused}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def end_headers(self):
        # the polling page must never read a cached live.json
        self.send_header("Cache-Control", "no-store")
        super().end_headers()

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(directory: str, port: int = 8765) -> ThreadingHTTPServer:
    """A threading server for ``directory`` on ``port`` (0: any free one);
    the caller runs ``serve_forever`` and ``shutdown``."""
    handler = functools.partial(LiveHandler, directory=directory)
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve a live-viewer run directory")
    ap.add_argument("dir")
    ap.add_argument("--port", type=int, default=8765)
    args = ap.parse_args(argv)
    httpd = serve(args.dir, args.port)
    print(f"live viewer: http://localhost:{args.port}/live.html (serving {args.dir})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
