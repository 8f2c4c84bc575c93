"""Model worker: HTTP generation endpoint + heartbeat.

Capability parity with reference llava/serve/model_worker.py:44-245: queue
semaphore, heartbeat thread to the controller, base64 image decoding, a
generate endpoint wrapping the model, and step-streamed partial decodes —
for diffusion, "streaming" means emitting the denoise trajectory (the
verbose history), which the reference's AR TextIteratorStreamer cannot do.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

HEART_BEAT_INTERVAL = 15


class DecodeBatcher:
    """Micro-batching for concurrent requests: the denoise loop is
    weight-read-bound (8B weights per step regardless of batch), so
    merging requests that arrive within a small window amortizes the
    weight reads.  The
    reference worker has no batching at all (model_worker.py wraps
    single-request generate).

    Requests are grouped by identical gen_kwargs (one compiled shape per
    group); each group is served through the adapter's
    generate_until_batch (bucket-padded prefixes, merged decode).

    Batch sizes are rounded UP to power-of-2 buckets (1,2,4,...,max_batch)
    by duplicating the last request: every distinct B is a distinct XLA
    graph, and at 8B each compile is minutes — without bucketing, a jittery
    arrival pattern (3 now, 5 next) thrashes the compile cache instead of
    serving.  Decode is weight-read-bound so pad rows are nearly free;
    prefill waste is bounded at <2x and only on partially-filled buckets."""

    def __init__(self, eval_model, max_batch: int = 4,
                 window_ms: float = 20.0):
        self.eval_model = eval_model
        self.max_batch = max_batch
        self.window = window_ms / 1e3
        self.served_sizes: list[tuple[int, int]] = []  # (real, padded)
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def submit(self, text: str, images: list, gen_kwargs: dict) -> str:
        item = {
            "text": text, "images": images, "gen_kwargs": gen_kwargs,
            "done": threading.Event(), "result": None, "error": None,
        }
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    @staticmethod
    def _key(item: dict) -> str:
        return json.dumps(item["gen_kwargs"], sort_keys=True)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
            time.sleep(self.window)  # let concurrent arrivals accumulate
            with self._cv:
                key = self._key(self._queue[0])
                batch = [it for it in self._queue
                         if self._key(it) == key][: self.max_batch]
                for it in batch:
                    self._queue.remove(it)
            try:
                if len(batch) == 1:
                    preds = [self.eval_model.generate_until(
                        batch[0]["text"], batch[0]["images"],
                        batch[0]["gen_kwargs"])]
                    self.served_sizes.append((1, 1))
                else:
                    padded = batch + [batch[-1]] * (
                        self._bucket(len(batch)) - len(batch))
                    preds = self.eval_model.generate_until_batch(
                        [it["text"] for it in padded],
                        [it["images"] for it in padded],
                        batch[0]["gen_kwargs"])
                    self.served_sizes.append((len(batch), len(padded)))
                for it, pred in zip(batch, preds):
                    it["result"] = pred
            except Exception as e:  # noqa: BLE001
                for it in batch:
                    it["error"] = e
            for it in batch:
                it["done"].set()


class ModelWorker:
    def __init__(
        self,
        eval_model,                      # eval.adapter.LavidaEvalModel
        model_name: str = "lavida-llada",
        controller_addr: Optional[str] = None,
        worker_addr: Optional[str] = None,
        limit_concurrency: int = 2,
        decode_batch: int = 0,           # >1 enables micro-batching
        batch_window_ms: float = 20.0,
    ):
        self.eval_model = eval_model
        self.model_name = model_name
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.semaphore = threading.Semaphore(
            max(limit_concurrency, decode_batch))
        self.queue_length = 0
        self.batcher = (
            DecodeBatcher(eval_model, max_batch=decode_batch,
                          window_ms=batch_window_ms)
            if decode_batch > 1 else None
        )
        if controller_addr and worker_addr:
            self.register()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    # ------------------------------------------------------------------

    def _post_controller(self, path: str, payload: dict):
        req = urllib.request.Request(
            self.controller_addr + path, json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def status(self) -> dict:
        return {
            "model_names": [self.model_name],
            "speed": 1.0,
            "queue_length": self.queue_length,
        }

    def register(self):
        self._post_controller("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    def _heartbeat_loop(self):
        while True:
            time.sleep(HEART_BEAT_INTERVAL)
            try:
                self._post_controller("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length,
                })
            except Exception:
                try:
                    self.register()
                except Exception:
                    pass

    # ------------------------------------------------------------------

    def generate(self, params: dict) -> dict:
        self.queue_length += 1
        try:
            with self.semaphore:
                images = []
                for b64 in params.get("images", []):
                    from PIL import Image

                    images.append(
                        Image.open(io.BytesIO(base64.b64decode(b64)))
                    )
                text = params.get("prompt", "")
                gen_kwargs = params.get("gen_kwargs", {})
                t0 = time.perf_counter()
                if self.batcher is not None:
                    out = self.batcher.submit(text, images, gen_kwargs)
                else:
                    out = self.eval_model.generate_until(
                        text, images, gen_kwargs)
                return {
                    "text": out,
                    "error_code": 0,
                    "latency_s": time.perf_counter() - t0,
                }
        except Exception as e:  # noqa: BLE001
            return {"text": "", "error_code": 1, "error": str(e)}
        finally:
            self.queue_length -= 1

    def openai_chat(self, payload: dict) -> dict:
        """OpenAI-compatible /v1/chat/completions (the sglang_worker
        analogue, reference llava/serve/sglang_worker.py): messages with
        text and image_url (data: URIs) content parts."""
        text_parts: list[str] = []
        images: list[str] = []
        for msg in payload.get("messages", []):
            if msg.get("role") != "user":
                continue
            content = msg.get("content", "")
            if isinstance(content, str):
                text_parts.append(content)
                continue
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = part["image_url"]["url"]
                    if url.startswith("data:"):
                        images.append(url.split(",", 1)[1])
        gen_kwargs = {}
        if "max_tokens" in payload:
            gen_kwargs["max_new_tokens"] = int(payload["max_tokens"])
        if payload.get("temperature"):
            gen_kwargs["temperature"] = float(payload["temperature"])
        out = self.generate({
            "prompt": "\n".join(text_parts),
            "images": images,
            "gen_kwargs": gen_kwargs,
        })
        if out.get("error_code"):
            return {"error": {"message": out.get("error", "generation failed")}}
        return {
            "object": "chat.completion",
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out["text"]},
                "finish_reason": "stop",
            }],
            "usage": {"latency_s": out.get("latency_s")},
        }

    def handle(self, path: str, payload: dict) -> dict:
        if path == "/worker_get_status":
            return self.status()
        if path in ("/worker_generate", "/worker_generate_stream"):
            return self.generate(payload)
        if path == "/v1/chat/completions":
            return self.openai_chat(payload)
        return {"error": f"unknown path {path}", "error_code": 1}

    def serve(self, host: str = "0.0.0.0", port: int = 21002):
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                out = worker.handle(self.path, payload)
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # browser chat UI (gradio_web_server analogue)
                from .web import PAGE

                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        print(f"[worker] {self.model_name} listening on {host}:{port}")
        server.serve_forever()


def _load_tokenizer(model_path):
    """Shared by every checkpoint branch (tp and quantized alike) so no
    branch can ship without a tokenizer (a --tp worker used to crash with
    UnboundLocalError here)."""
    import os

    if os.path.exists(os.path.join(model_path, "tokenizer.json")):
        from ..data.tokenizer import load_tokenizer

        return load_tokenizer(model_path)
    return None


def main():
    """`python -m lavida_mod.serve.worker` — the reference's
    `python -m llava.serve.model_worker` analogue (model_worker.py CLI:
    --host/--port/--controller-address/--worker-address/--model-path/
    --limit-model-concurrency), plus micro-batching flags."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--controller-address", default=None)
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--model-name", default="lavida-llada")
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--limit-model-concurrency", type=int, default=2)
    ap.add_argument("--decode-batch", type=int, default=0,
                    help=">1 merges concurrent requests into one batched "
                         "denoise (weight reads amortize)")
    ap.add_argument("--batch-window-ms", type=float, default=20.0)
    ap.add_argument("--int4", action="store_true",
                    help="grouped int4 LM weights (bench.py default; "
                         "~1%% logit rel-err; gate per checkpoint with "
                         "scripts/verify_checkpoint.py).  Default here "
                         "stays weight-only int8 (near-lossless)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision serving (implies --int4): int8 "
                         "LM tree for the compute-bound prefill next to "
                         "the int4 decode tree (+~7.5G device memory "
                         "for the 8B int8 tree)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache + decode attention over it "
                         "(bench --kv8; quality-gate per checkpoint)")
    ap.add_argument("--kv4", action="store_true",
                    help="int4 KV cache (memory headroom; gate with "
                         "verify_checkpoint --kv4-check)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N devices "
                         "(no quantization — LaViDa.shard)")
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny model (no checkpoint; smoke/dev)")
    args = ap.parse_args()
    if args.mixed:
        args.int4 = True  # the mixed split rides the int4 decode tree

    from ..utils.compile_cache import enable as _cc

    _cc()  # 8B serve graphs take minutes to compile cold; cache them

    import jax.numpy as jnp

    from ..config import LaViDaConfig, VisionConfig, tiny_llada_config, \
        tiny_siglip_config
    from ..eval.adapter import LavidaEvalModel
    from ..models.lavida import LaViDa

    if args.tiny or not args.model_path:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        model = LaViDa.random_init(cfg, 0, jnp.float32)
        tokenizer = None
        print("[worker] tiny random model (no checkpoint)")
    elif args.tp > 1:
        # multi-device bf16 serving: shard over the tp mesh instead of
        # quantizing (LaViDa.shard docstring)
        if args.int4 or args.mixed:
            raise SystemExit("--tp is bf16 serving; drop --int4/--mixed")
        if args.kv8 or args.kv4:
            # sharded generate with a quantized KV cache has no parity
            # test
            raise SystemExit("--tp is bf16 serving; drop --kv8/--kv4")
        model = LaViDa.load(args.model_path, host_staging=True)
        model.shard(tp=args.tp)
        tokenizer = _load_tokenizer(args.model_path)
    else:
        # host_staging: quantize host-side, ship via .to_device()
        model = LaViDa.load(args.model_path, host_staging=True)
        model.to_serving_layout(
            quant=("mixed" if args.mixed else
                   "int4" if args.int4 else "int8"))
        tokenizer = _load_tokenizer(args.model_path)

    eval_model = LavidaEvalModel(model, tokenizer,
                                 conv_template=args.conv_template,
                                 kv8=(4 if args.kv4 else args.kv8))
    worker = ModelWorker(
        eval_model, args.model_name,
        controller_addr=args.controller_address,
        worker_addr=args.worker_address,
        limit_concurrency=args.limit_model_concurrency,
        decode_batch=args.decode_batch,
        batch_window_ms=args.batch_window_ms,
    )
    worker.serve(args.host, args.port)


if __name__ == "__main__":
    main()
