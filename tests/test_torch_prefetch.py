"""The port's background prefetch (``pnpflow_tpu_torch/data/prefetch.py``):
order, a bounded queue, the producer released on an early stop, errors
raised in the consumer, and batches moved to a device."""

import threading
import time

import numpy as np
import pytest
import torch

from pnpflow_tpu_torch.data.prefetch import (
    PrefetchIterator, prefetch, to_device)


def _batches(n):
    for i in range(n):
        yield np.full((2, 3), i, np.float32), np.zeros(2, np.int32)


class _Counting:
    """An iterable that records how far its producer got."""

    def __init__(self, n):
        self.n, self.made = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.made += 1
            yield i, None

    def __len__(self):
        return self.n


def test_order_and_length():
    it = PrefetchIterator(list(_batches(5)), depth=2)
    assert len(it) == 5
    assert [int(x[0, 0]) for x, _ in it] == [0, 1, 2, 3, 4]
    assert [int(x[0, 0]) for x, _ in it] == [0, 1, 2, 3, 4]   # re-iterable


def test_queue_is_bounded_and_early_stop_releases_the_producer():
    src = _Counting(1000)
    before = threading.active_count()
    for i, _ in PrefetchIterator(src, depth=2):
        if i == 1:
            time.sleep(0.3)          # let the producer fill the queue
            assert src.made <= 2 + 2 + 1
            break
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before
    assert src.made < 10


def test_producer_errors_are_raised_in_the_consumer():
    def bad():
        yield np.zeros(1), None
        raise OSError("decode failed")

    got = []
    with pytest.raises(OSError, match="decode failed"):
        for x, _ in PrefetchIterator(bad()):
            got.append(x)
    assert len(got) == 1


def test_images_move_to_the_device_labels_stay():
    it = prefetch(list(_batches(3)), device="cpu")
    out = list(it)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x, _ in out)
    assert all(isinstance(y, np.ndarray) for _, y in out)
    assert [int(x[0, 0]) for x, _ in out] == [0, 1, 2]
    t = to_device(np.arange(4, dtype=np.float32)[::2], None)
    assert torch.equal(t, torch.tensor([0.0, 2.0]))


def test_prefetch_wraps_a_dict_of_loaders():
    loaders = prefetch({"train": list(_batches(2)), "val": None})
    assert loaders["val"] is None
    assert isinstance(loaders["train"], PrefetchIterator)
    assert len(list(loaders["train"])) == 2


def test_the_producer_makes_the_batch_card_current(monkeypatch):
    """A new thread starts on card 0: the producer enters the card the
    batches go to before it makes them, and a bare ``cuda`` is the
    consumer's current card (card 1 here; the CUDA calls are stood in
    for, so this runs without a card)."""
    import contextlib

    from pnpflow_tpu_torch.data import prefetch as pf

    current = threading.local()

    @contextlib.contextmanager
    def device(d):
        before = getattr(current, "card", None)
        current.card = torch.device(d)
        try:
            yield
        finally:
            current.card = before

    seen = []

    def made_on(n):
        for i in range(n):
            seen.append(getattr(current, "card", None))
            yield np.full((2, 3), i, np.float32), None

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(pf, "to_device",
                        lambda x, d: (torch.from_numpy(x), d))
    for asked in ("cuda", "cuda:1"):
        seen.clear()
        out = list(PrefetchIterator(made_on(3), device=asked))
        card = torch.device("cuda", 1)
        assert seen == [card] * 3, asked
        assert [x[1] for x, _ in out] == [card] * 3, asked
