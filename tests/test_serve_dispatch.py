"""Controller dispatch-logic tests (no sockets)."""

import time

from lavida_mod.serve.controller import Controller, WorkerInfo


def _mk(ctrl, name, queue, speed=1.0, models=("m",)):
    ctrl.worker_info[name] = WorkerInfo(
        list(models), speed, queue, True, time.time()
    )


def test_shortest_queue_dispatch():
    c = Controller("shortest_queue")
    _mk(c, "w1", queue=5)
    _mk(c, "w2", queue=1)
    _mk(c, "w3", queue=9)
    assert c.get_worker_address("m") == "w2"
    # queue incremented on dispatch
    assert c.worker_info["w2"].queue_length == 2
    # speed normalization: fast worker with longer queue can win
    c2 = Controller("shortest_queue")
    _mk(c2, "slow", queue=1, speed=0.1)
    _mk(c2, "fast", queue=4, speed=10.0)
    assert c2.get_worker_address("m") == "fast"


def test_lottery_respects_model_filter():
    c = Controller("lottery")
    _mk(c, "a", queue=0, models=("x",))
    _mk(c, "b", queue=0, models=("m",))
    for _ in range(10):
        assert c.get_worker_address("m") == "b"
    assert c.get_worker_address("nope") == ""


def test_stale_worker_removal():
    c = Controller()
    _mk(c, "old", queue=0)
    c.worker_info["old"].last_heart_beat = time.time() - 10_000
    _mk(c, "new", queue=0)
    c.remove_stale_workers()
    assert "old" not in c.worker_info and "new" in c.worker_info
    assert c.list_models() == ["m"]


def test_heartbeat_updates_queue():
    c = Controller()
    _mk(c, "w", queue=0)
    assert c.receive_heart_beat("w", 7)
    assert c.worker_info["w"].queue_length == 7
    assert not c.receive_heart_beat("ghost", 1)
