"""Video frame pipeline + worker web UI tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.data.video import (
    frames_to_views, load_video_frames, sample_frame_indices,
)


def test_sample_frame_indices():
    assert sample_frame_indices(100, 8) == [0, 12, 25, 37, 50, 62, 75, 87]
    assert sample_frame_indices(3, 8) == [0, 1, 2]


def test_load_gif_and_dir(tmp_path):
    from PIL import Image

    frames = [
        Image.fromarray(
            np.full((40, 40, 3), i * 30, np.uint8)
        )
        for i in range(6)
    ]
    gif = tmp_path / "v.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:])
    out = load_video_frames(str(gif), num_frames=4)
    assert len(out) == 4 and out[0].size == (40, 40)

    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):
        f.save(d / f"{i:03d}.png")
    out = load_video_frames(str(d), num_frames=3)
    assert len(out) == 3


def test_video_encode_path(tmp_path):
    from lavida_mod.config import (
        LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
    )
    from lavida_mod.data import SigLIPImageProcessor
    from lavida_mod.models import multimodal as mm
    from PIL import Image

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    frames = [Image.new("RGB", (60, 60), (i * 40, 0, 0)) for i in range(4)]
    views = frames_to_views(frames, SigLIPImageProcessor(size=56))
    assert views.shape == (4, 3, 56, 56)
    block = mm.encode_video(params, cfg, jnp.asarray(views))
    # 4 frames x (2x2 pooled from 4x4) 4 tokens + 1 newline
    assert block.shape == (4 * 4 + 1, cfg.llada.d_model)

    # splices like an image block
    ids = np.array([5, -200, 6])
    embeds, _ = mm.splice_embeddings(params, cfg, ids, [block])
    assert embeds.shape[0] == 2 + block.shape[0]


def test_worker_serves_web_ui():
    import json
    import threading
    import time
    import urllib.request

    from lavida_mod.serve.worker import ModelWorker

    class FakeEval:
        def generate_until(self, text, images, gen_kwargs=None):
            return "ok"

    w = ModelWorker(FakeEval(), "m")
    t = threading.Thread(target=w.serve, args=("127.0.0.1", 19321),
                         daemon=True)
    t.start()
    time.sleep(0.5)
    with urllib.request.urlopen("http://127.0.0.1:19321/") as r:
        page = r.read().decode()
    assert "LaViDa" in page and "worker_generate" in page
    req = urllib.request.Request(
        "http://127.0.0.1:19321/worker_generate",
        json.dumps({"prompt": "hi"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as r:
        out = json.loads(r.read())
    assert out["text"] == "ok" and out["error_code"] == 0


def test_openai_chat_endpoint():
    import base64
    import io
    import json
    import threading
    import time
    import urllib.request

    from PIL import Image

    from lavida_mod.serve.worker import ModelWorker

    class FakeEval:
        def generate_until(self, text, images, gen_kwargs=None):
            return f"saw {len(images)} image(s): {text[:20]}"

    w = ModelWorker(FakeEval(), "m")
    threading.Thread(target=w.serve, args=("127.0.0.1", 19322),
                     daemon=True).start()
    time.sleep(0.5)
    buf = io.BytesIO()
    Image.new("RGB", (10, 10)).save(buf, "PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    body = {
        "model": "m",
        "max_tokens": 8,
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url",
             "image_url": {"url": f"data:image/png;base64,{b64}"}},
        ]}],
    }
    req = urllib.request.Request(
        "http://127.0.0.1:19322/v1/chat/completions",
        json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as r:
        out = json.loads(r.read())
    assert out["choices"][0]["message"]["content"].startswith("saw 1")
    assert out["object"] == "chat.completion"


def test_video_av_path_gated():
    """mp4-family files route to the pyav decoder; without `av` installed
    the error is loud and actionable (reference degrades the same way
    without decord, llava/utils.py:21-23)."""
    import pytest

    from lavida_mod.data.video import load_video_frames

    try:
        import av  # noqa: F401

        pytest.skip("av present; decode path exercised implicitly")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pyav"):
        load_video_frames("/tmp/nonexistent.mp4")


def test_register_worker_cli():
    """`python -m lavida_mod.serve.register_worker` analogue of the
    reference's llava/serve/register_worker.py: posts a manual
    registration to a live controller."""
    import sys
    import threading
    import time
    from unittest import mock

    from lavida_mod.serve import register_worker
    from lavida_mod.serve.controller import Controller

    c = Controller()
    t = threading.Thread(target=c.serve, args=("127.0.0.1", 19327),
                         daemon=True)
    t.start()
    # manual registration posts worker_status=None, so the controller
    # queries the WORKER's /worker_get_status (reference semantics) —
    # run a minimal fake worker
    import http.server
    import json as _json

    class FakeWorker(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = _json.dumps(
                {"model_names": ["m"], "speed": 1.0, "queue_length": 0}
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 19328), FakeWorker)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    time.sleep(0.5)
    argv = ["register_worker",
            "--controller-address", "http://127.0.0.1:19327",
            "--worker-name", "http://127.0.0.1:19328"]
    with mock.patch.object(sys, "argv", argv):
        register_worker.main()
    assert "http://127.0.0.1:19328" in c.worker_info
    srv.shutdown()
