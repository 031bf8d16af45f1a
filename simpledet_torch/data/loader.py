"""Threaded host input pipeline with aspect grouping and rank sharding: a
copy of `simpledet_tpu/data/loader.py`, kept in the port so that it imports
nothing of the JAX package.

Records are sharded per rank, grouped by orientation so that every batch has
one padded shape, shuffled from an explicit seed (seed + epoch), transformed
in a worker thread pool, collated to numpy batches with a `valid` mask (tail
batches padded by repeating the last record) and prefetched. Batches stay on
the host; the caller moves them to the device. Anchor targets are made on the
device inside the train step, not here.
"""
import queue
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from simpledet_torch.data.transforms import apply_transforms

BATCH_KEYS = ("data", "im_info", "gt_bbox", "im_id", "rec_id")


def aspect_group(roidb):
    vertical = [r for r in roidb if r["h"] >= r["w"]]
    horizontal = [r for r in roidb if r["h"] < r["w"]]
    return vertical, horizontal


class Loader:
    """Iterable over collated batches.

    transforms: list of DetectionAugmentation applied per record.
    data_keys/label_keys: which record fields end up in the batch dict.
    Incomplete trailing batches are padded by repeating the last record
    (train) or emitted with a 'valid' mask (eval, pad_last=False -> mask).
    """

    def __init__(self, roidb, transforms, batch_size, *, shuffle=True,
                 num_workers=8, rank=0, num_ranks=1, aspect_grouping=True,
                 keys=("data", "im_info", "gt_bbox"), seed=3, pad_last=True,
                 prefetch=4):
        self.transforms = transforms
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.keys = keys
        self.pad_last = pad_last
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

        # rank shard: equal split + remainder to low ranks
        # (core/detection_input.py:790-810)
        n = len(roidb)
        per = n // num_ranks
        rem = n % num_ranks
        start = rank * per + min(rank, rem)
        end = start + per + (1 if rank < rem else 0)
        self.roidb = roidb[start:end]
        for i, r in enumerate(self.roidb):
            r.setdefault("rec_id", start + i)
        self.aspect_grouping = aspect_grouping
        self._len = None    # batch count is shuffle-invariant; cache it
        self._pool = None   # one ThreadPoolExecutor for the loader lifetime

    def _batches(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        groups = aspect_group(self.roidb) if self.aspect_grouping \
            else [list(self.roidb)]
        all_batches = []
        for g in groups:
            g = list(g)
            if not g:
                continue
            if self.shuffle:
                rng.shuffle(g)
            for i in range(0, len(g), self.batch_size):
                b = g[i:i + self.batch_size]
                if len(b) < self.batch_size:
                    if self.pad_last:
                        b = b + [b[-1]] * (self.batch_size - len(b))
                    # else keep short; collate pads with repeats + mask
                all_batches.append(b)
        if self.shuffle:
            rng.shuffle(all_batches)
        return all_batches

    def __len__(self):
        # analytic count (no batch materialization / shuffle): each aspect
        # group contributes ceil(len/batch) batches whether padded or masked
        if self._len is None:
            groups = aspect_group(self.roidb) if self.aspect_grouping \
                else [self.roidb]
            self._len = sum(-(-len(g) // self.batch_size)
                            for g in groups if len(g))
        return self._len

    def _make(self, records):
        n_valid = len(records)
        records = [apply_transforms(dict(r), self.transforms)
                   for r in records]
        while len(records) < self.batch_size:
            records.append(records[-1])
        batch = {}
        for k in self.keys:
            # configs may or may not rename image->data (RenameRecord)
            src = k if k in records[0] else ("image" if k == "data" else k)
            vals = [np.asarray(r[src]) for r in records]
            batch[k] = np.stack(vals)
        batch["valid"] = np.arange(self.batch_size) < n_valid
        return batch

    def __iter__(self):
        batches = self._batches()
        self.epoch += 1
        if self.num_workers <= 0:
            for b in batches:
                yield self._make(b)
            return

        # one pool for the loader's lifetime (the reference keeps its worker
        # threads across epochs too, core/detection_input.py:713-728);
        # recreating it every epoch paid thread startup per epoch
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_workers)
        pool = self._pool
        futures = queue.Queue()
        depth = min(self.prefetch, len(batches))
        it = iter(batches)
        for _ in range(depth):
            futures.put(pool.submit(self._make, next(it)))
        pending = len(batches) - depth
        while not futures.empty():
            f = futures.get()
            if pending > 0:
                futures.put(pool.submit(self._make, next(it)))
                pending -= 1
            yield f.result()
