"""REST API for watermarking (the port's counterpart of
``examples/web_api_integration.py``).

Endpoints:
  GET  /health            -> {"status": "ok", ...}
  POST /watermark/embed   multipart: file=<audio>, watermark=<hex|bits|int>
                          -> watermarked WAV bytes
  POST /watermark/detect  multipart: file=<audio>
                          -> {"watermark": "...", "confidence": 0.97}
  POST /watermark/locate  multipart: file=<audio>
                          -> {"presence_ratio": 0.93, "mask_downsampled": [...]}

Uses Flask when it is installed, else the stdlib ``http.server`` (raw
request bodies instead of multipart; :func:`handle` answers its requests).
One WaveVerify instance serves every request.

Run:  python -m waveverify_torch.examples.web_api_integration
          [--checkpoint PATH] [--device cuda|cpu] [--port 8080]
"""

import argparse
import io
import json
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from waveverify_torch import WatermarkID, WaveVerify

wv: Optional[WaveVerify] = None  # set by main()


def _parse_watermark(value: str) -> WatermarkID:
    value = value.strip()
    if set(value) <= {"0", "1"} and len(value) == 16:
        return WatermarkID.custom(value)
    if value.lower().startswith("0x"):
        return WatermarkID.custom(int(value, 16))
    return WatermarkID.custom(int(value))


def _embed_bytes(audio_bytes: bytes, watermark: str) -> bytes:
    with tempfile.NamedTemporaryFile(suffix=".wav") as fin, \
            tempfile.NamedTemporaryFile(suffix=".wav") as fout:
        fin.write(audio_bytes)
        fin.flush()
        wv.embed(fin.name, _parse_watermark(watermark), fout.name)
        return Path(fout.name).read_bytes()


def _detect_bytes(audio_bytes: bytes) -> dict:
    with tempfile.NamedTemporaryFile(suffix=".wav") as fin:
        fin.write(audio_bytes)
        fin.flush()
        wm, conf = wv.detect(fin.name)
    return {"watermark": wm.to_hex(), "bits": wm.to_bits(),
            "confidence": round(conf, 4)}


def _locate_bytes(audio_bytes: bytes) -> dict:
    with tempfile.NamedTemporaryFile(suffix=".wav") as fin:
        fin.write(audio_bytes)
        fin.flush()
        mask = wv.locate(fin.name)
    ds = mask[:: max(len(mask) // 200, 1)]
    return {"presence_ratio": round(float((mask > 0.5).mean()), 4),
            "mask_downsampled": [round(float(v), 3) for v in ds]}


HEALTH = {"status": "ok", "framework": "waveverify_torch"}


def handle(method: str, path: str, body: bytes = b""
           ) -> Tuple[int, str, bytes]:
    """One request of the stdlib server: (status, content type, body).
    ``POST /watermark/embed?watermark=0xBEEF`` takes the raw WAV body."""
    def js(obj, code=200):
        return code, "application/json", json.dumps(obj).encode()

    if method == "GET":
        return js(HEALTH) if path == "/health" else js({"error": "not found"}, 404)
    try:
        if path.startswith("/watermark/embed"):
            q = parse_qs(urlparse(path).query)
            return 200, "audio/wav", _embed_bytes(body, q.get("watermark", ["0"])[0])
        if path == "/watermark/detect":
            return js(_detect_bytes(body))
        if path == "/watermark/locate":
            return js(_locate_bytes(body))
        return js({"error": "not found"}, 404)
    except Exception as e:  # noqa: BLE001 - reported to the client
        return js({"error": str(e)}, 500)


def run_flask(port: int) -> None:
    from flask import Flask, jsonify, request, send_file

    app = Flask("waveverify_torch")

    @app.get("/health")
    def health():
        return jsonify(HEALTH)

    @app.post("/watermark/embed")
    def embed():
        f = request.files["file"]
        out = _embed_bytes(f.read(), request.form.get("watermark", "0"))
        return send_file(io.BytesIO(out), mimetype="audio/wav",
                         download_name="watermarked.wav")

    @app.post("/watermark/detect")
    def detect():
        return jsonify(_detect_bytes(request.files["file"].read()))

    @app.post("/watermark/locate")
    def locate():
        return jsonify(_locate_bytes(request.files["file"].read()))

    app.run(host="0.0.0.0", port=port)


def run_stdlib(port: int) -> None:
    """Dependency-free server: raw-body endpoints (no multipart)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, method: str, body: bytes = b"") -> None:
            code, ctype, out = handle(method, self.path, body)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_GET(self):
            self._reply("GET")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            self._reply("POST", self.rfile.read(n))

    print(f"stdlib server on :{port} (POST raw WAV bodies; "
          f"embed: /watermark/embed?watermark=0xBEEF)")
    HTTPServer(("0.0.0.0", port), Handler).serve_forever()


def main(argv: Optional[List[str]] = None) -> None:
    global wv
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)

    wv = WaveVerify(checkpoint_path=args.checkpoint, device=args.device)
    try:
        import flask  # noqa: F401
    except ImportError:
        run_stdlib(args.port)
    else:
        run_flask(args.port)


if __name__ == "__main__":
    main()
