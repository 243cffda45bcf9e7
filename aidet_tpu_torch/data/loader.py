"""Batched data loader: dataset + pipeline -> numpy batches.

Port of `aidet_tpu/data/loader.py::GroupedLoader` (:22-145): an
epoch-seeded shuffle inside aspect-ratio groups, each group padded to a
batch multiple so that every batch is single-group (`_chunks`, the same
batch indices as the reference for every seed, epoch, shard, shuffle
and drop_last); sharding by whole batches padded to a shard-uniform
count; decode and pipeline in a thread pool; a prefetch thread with a
stop event; the final partial batch padded with its last sample.
Images are read by `imio.imread` (the card's machine has no OpenCV); a
missing file is read as zeros of the image's size, as the reference's
`cv2.imread` returning None is, and logged once.  Batches are numpy;
the train loop pins them and moves them to the card.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .imio import imread
from .pipeline import collate_batch

LOGGER = logging.getLogger("aidet_tpu_torch")


class MissingImages:
    """Reads an image, or zeros of the size its info gives when the file
    is missing (the reference's behaviour), logging each missing file
    once.  Thread-safe."""

    def __init__(self):
        self.seen: set = set()
        self.lock = threading.Lock()

    def read(self, path, info) -> np.ndarray:
        try:
            return imread(path)
        except FileNotFoundError:
            with self.lock:
                first = path not in self.seen
                self.seen.add(path)
            if first:
                LOGGER.warning("image %s is missing: read as zeros", path)
            return np.zeros((info.get("height", 512), info.get("width", 512),
                             3), np.uint8)


class GroupedLoader:
    def __init__(self, dataset, pipeline, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4,
                 num_shards: int = 1, shard_id: int = 0,
                 drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        self.images = MissingImages()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _chunks(self):
        """This shard's list of batch-index chunks for the epoch."""
        n = len(self.dataset)
        idx = np.arange(n)
        bs = self.batch_size
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            flags = getattr(self.dataset, "flag",
                            np.zeros(n, np.uint8))
            # shuffle within aspect-ratio groups, pad each group to a
            # batch multiple so every chunk is single-group, then
            # shuffle the chunk order
            chunks = []
            for g in np.unique(flags):
                sel = idx[flags == g]
                rng.shuffle(sel)
                extra = -len(sel) % bs
                if extra:
                    sel = np.concatenate([sel, sel[:extra]])
                chunks += [sel[i:i + bs]
                           for i in range(0, len(sel), bs)]
            order = rng.permutation(len(chunks))
            chunks = [chunks[i] for i in order]
        else:
            nb = n // bs if self.drop_last and n >= bs \
                else -(-n // bs)
            chunks = [idx[i * bs:(i + 1) * bs] for i in range(nb)]
        if self.num_shards > 1 and chunks:
            # whole batches, padded so that every shard sees the same
            # batch count (the DistributedGroupSampler's invariant)
            extra = -len(chunks) % self.num_shards
            chunks = chunks + chunks[:extra]
            chunks = chunks[self.shard_id::self.num_shards]
        return chunks

    def _load(self, i):
        img = self.images.read(self.dataset.img_path(i),
                               self.dataset.img_infos[i])
        return self.pipeline(img, self.dataset.parse_anns(i))

    def __iter__(self):
        """Yield collated batches, made by a background thread so that
        host decode and augmentation overlap the device's step."""
        import queue

        bs = self.batch_size
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._chunks():
                        samples = list(pool.map(self._load, chunk))
                        while len(samples) < bs:  # pad the final partial
                            samples.append(samples[-1])
                        if not put(collate_batch(samples)):
                            return
            except Exception as e:  # raised on the consumer's thread
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=produce, daemon=True,
                             name="loader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self):
        return len(self._chunks())
