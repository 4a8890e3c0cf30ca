"""HTTP bridge: expose videoquery_torch.testing.fake_api.FakeAPI over a
real socket so the production HTTPTransport/ActionClient path is exercised
end-to-end (loader CLI, broker service, curl). Routes mirror
service/client.py's DRF route table.

A copy of ``videoquery/testing/serve_fake_api.py`` for the port.

Run: python -m videoquery_torch.testing.serve_fake_api [port]
Port 8123, token `testtoken123`. A background thread seeds a query a few
seconds after features stop arriving (so the broker has work).
"""
import io
import json
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from videoquery_torch.testing.fake_api import FakeAPI

TOKEN = "testtoken123"
api = FakeAPI()
lock = threading.Lock()


def coerce(v):
    if isinstance(v, str):
        if re.fullmatch(r"-?\d+", v):
            return int(v)
        if v in ("true", "True"):
            return True
        if v in ("false", "False"):
            return False
    return v


def parse_multipart(body, ctype):
    m = re.search(r'boundary="?([^";]+)"?', ctype)
    fields = {}
    if not m:
        return fields
    boundary = m.group(1).encode()
    for part in body.split(b"--" + boundary):
        if b"Content-Disposition" not in part:
            continue
        head, _, val = part.partition(b"\r\n\r\n")
        name = re.search(rb'name="([^"]+)"', head)
        if not name:
            continue
        val = val.rstrip(b"\r\n-")
        if re.search(rb'filename="', head):
            fields[name.group(1).decode()] = io.BytesIO(val)
        else:
            fields[name.group(1).decode()] = coerce(val.decode())
    return fields


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _params_from_body(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(n)
        ctype = self.headers.get("Content-Type", "")
        if "multipart" in ctype:
            return parse_multipart(body, ctype)
        if "json" in ctype:
            return json.loads(body or b"{}")
        return {k: coerce(v[0]) for k, v in
                parse_qs(body.decode(errors="replace")).items()}

    def _route(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        qparams = {k: coerce(v[0]) for k, v in parse_qs(url.query).items()}

        if parts == ["api-token-auth"] and self.command == "POST":
            creds = self._params_from_body()
            if creds.get("username") and creds.get("password"):
                return self._send({"token": TOKEN})
            return self._send({"error": "bad credentials"}, 400)

        if self.headers.get("Authorization") != f"Token {TOKEN}":
            return self._send({"detail": "auth required"}, 401)

        if parts == ["docs"]:
            return self._send({"title": "Fake Video Query API"})

        try:
            with lock:
                # nested query-state routes: query-state/compute-new/ etc.
                if len(parts) == 2 and parts[0] == "query-state":
                    out = api.action(["query-state", parts[1], "list"], {})
                elif len(parts) == 1 and self.command == "GET":
                    out = api.action([parts[0], "list"], qparams)
                elif len(parts) == 1 and self.command == "POST":
                    out = api.action([parts[0], "create"],
                                     self._params_from_body())
                elif len(parts) == 2 and self.command == "GET":
                    out = api.action([parts[0], "read"],
                                     {"id": int(parts[1]), **qparams})
                elif len(parts) == 2 and self.command == "PATCH":
                    p = self._params_from_body()
                    p["id"] = int(parts[1])
                    out = api.action([parts[0], "partial_update"], p)
                elif (len(parts) == 3 and self.command == "GET"
                      and parts[2] == "features"):
                    out = api.action([parts[0], "features"],
                                     {"id": int(parts[1]), **qparams})
                else:
                    return self._send({"detail": "no route"}, 404)
        except KeyError as exc:
            return self._send({"detail": f"not found: {exc}"}, 404)
        return self._send(out)

    do_GET = do_POST = do_PATCH = _route


def seeder():
    """Seed one query over everything once features stop growing."""
    last = -1
    while True:
        time.sleep(2.0)
        with lock:
            n = len(api.features)
            if n and n == last and not api.queries:
                clip_ids = sorted({f["video_clip"]
                                   for f in api.features.values()})
                ss = api.add_search_set("all", clip_ids)
                video_id = api.video_clips[clip_ids[0]]["video"]
                q = api.add_query("demo-query", video_id,
                                  api.video_clips[clip_ids[0]]["clip"],
                                  clip_ids[0], ss["id"],
                                  max_matches_for_review=10)
                print(f"[seeder] created query {q['id']} over "
                      f"{len(clip_ids)} clips", flush=True)
            last = n


if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8123
    threading.Thread(target=seeder, daemon=True).start()
    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"fake API on http://127.0.0.1:{port}/", flush=True)
    srv.serve_forever()
