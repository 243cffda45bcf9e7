"""Queued inference.

Port of `aidet_tpu/apis/async_inference.py` (`AsyncInferencer` :24,
`async_inference_detector` :67): a submit / drain queue of up to
``depth`` predictions in flight, and an asyncio coroutine.

The port's predict is not asynchronous as the reference's jitted call
is: its RPN NMS (`aidet_tpu_torch.ops.nms`) waits for the card once a
round, so `submit` returns after the host's part of the call, with the
last kernels possibly still running; `drain_one` copies the outputs to
the host.  The queue semantics and the results are the reference's.
"""

from __future__ import annotations

import asyncio
import collections

import numpy as np

from ..data.pipeline import TestPipeline
from .inference import prepare, to_numpy


class AsyncInferencer:
    """Keep up to ``depth`` predictions in flight."""

    def __init__(self, model, depth: int = 2, img_size: int | None = None):
        self.model = model
        self.depth = depth
        self.pipe = TestPipeline(img_size=img_size or model.img_size)
        self._queue: collections.deque = collections.deque()

    def submit(self, img: np.ndarray, tag=None):
        """Enqueue one BGR image.  If the queue is full, the oldest
        result is drained first and returned, else None."""
        drained = None
        if len(self._queue) >= self.depth:
            drained = self.drain_one()
        out = self.model.predict(*prepare(self.model, self.pipe, img))
        self._queue.append((tag, out))
        return drained

    def drain_one(self):
        """(tag, outputs as numpy) of the oldest prediction, or None."""
        if not self._queue:
            return None
        tag, out = self._queue.popleft()
        return tag, to_numpy(out)

    def drain_all(self):
        res = []
        while self._queue:
            res.append(self.drain_one())
        return res


async def async_inference_detector(model, img):
    """Coroutine parity with apis/inference.py:90: the blocking copy to
    the host runs in the default executor so the event loop stays
    free."""
    inf = AsyncInferencer(model, depth=1)
    inf.submit(img)
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, inf.drain_one)
