"""Worker micro-batching (serve/worker.py::DecodeBatcher): concurrent
requests within the window merge into one batched decode; mismatched
gen_kwargs stay in separate groups; errors propagate per batch."""

import threading
import time

from lavida_mod.serve.worker import DecodeBatcher, ModelWorker


class FakeEval:
    def __init__(self):
        self.batch_sizes = []
        self.single_calls = 0
        self.lock = threading.Lock()

    def generate_until(self, text, images, gen_kwargs=None):
        with self.lock:
            self.single_calls += 1
        return f"one:{text}"

    def generate_until_batch(self, texts, images, gen_kwargs=None):
        with self.lock:
            self.batch_sizes.append(len(texts))
        time.sleep(0.01)
        return [f"batch:{t}" for t in texts]


def _submit_concurrent(batcher, reqs):
    results = [None] * len(reqs)

    def run(i, text, kw):
        results[i] = batcher.submit(text, [], kw)

    threads = [threading.Thread(target=run, args=(i, t, kw))
               for i, (t, kw) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return results


def test_concurrent_requests_merge():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(4)])
    assert sorted(res) == [f"batch:q{i}" for i in range(4)]
    assert ev.batch_sizes == [4]
    assert ev.single_calls == 0


def test_mismatched_kwargs_split_groups():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=300)
    res = _submit_concurrent(b, [
        ("a", {"max_new_tokens": 8}),
        ("b", {"max_new_tokens": 8}),
        ("c", {"max_new_tokens": 32}),
    ])
    assert res[0] == "batch:a" and res[1] == "batch:b"
    # the lone kwargs group goes through the single path
    assert res[2] == "one:c"
    assert ev.batch_sizes == [2]
    assert ev.single_calls == 1


def test_single_request_uses_single_path():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=10)
    assert b.submit("solo", [], {}) == "one:solo"
    assert ev.batch_sizes == [] and ev.single_calls == 1


def test_error_propagates():
    class Boom(FakeEval):
        def generate_until(self, *a, **k):
            raise RuntimeError("boom")

    b = DecodeBatcher(Boom(), max_batch=2, window_ms=10)
    try:
        b.submit("x", [], {})
        raise AssertionError("expected RuntimeError")
    except RuntimeError as e:
        assert "boom" in str(e)


def test_worker_routes_through_batcher():
    ev = FakeEval()
    w = ModelWorker(ev, "m", decode_batch=4, batch_window_ms=300)
    out = [None, None]

    def call(i):
        out[i] = w.generate({"prompt": f"p{i}", "gen_kwargs": {}})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert {out[0]["text"], out[1]["text"]} == {"batch:p0", "batch:p1"}
    assert ev.batch_sizes == [2]


def test_batch_padded_to_power_of_two_bucket():
    """3 concurrent requests serve as a 4-row padded batch (last request
    duplicated): every distinct B is a distinct XLA graph and 8B compiles
    are minutes, so the batcher bounds the compiled shapes to
    {1,2,4,...,max_batch}.  Results map back to the 3 real requests."""
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=8, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(3)])
    assert sorted(res) == [f"batch:q{i}" for i in range(3)]
    assert ev.batch_sizes == [4]          # padded to the bucket
    assert b.served_sizes == [(3, 4)]     # (real, padded) occupancy stat


def test_bucket_capped_at_max_batch():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=3, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(3)])
    assert sorted(res) == [f"batch:q{i}" for i in range(3)]
    assert ev.batch_sizes == [3]          # never padded past max_batch
