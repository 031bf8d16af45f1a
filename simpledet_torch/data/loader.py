"""Threaded host input pipeline with aspect grouping and rank sharding: a
copy of `simpledet_tpu/data/loader.py`, kept in the port so that it imports
nothing of the JAX package.

Records are sharded per rank, grouped by orientation so that every batch has
one padded shape, shuffled from an explicit seed (seed + epoch), transformed
in a worker thread pool, collated to numpy batches with a `valid` mask (tail
batches padded by repeating the last record) and prefetched. Batches stay on
the host; the caller moves them to the device. Anchor targets are made on the
device inside the train step, not here.

Shards may differ in batch count (the remainder of the split goes to the low
ranks, and each shard's aspect groups round up on their own). A rank that
runs a batch more than another enters DDP's and SyncBN's all_reduce alone
and blocks. So every rank computes every rank's count from the whole roidb
(`rank_batch_counts`: the shard bounds and the grouping are deterministic,
so no communication is needed) and runs the least of them an epoch, the
first of its shuffled batches; the JAX package's loader has no such cut.
One rank runs all its batches.
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


def shard_bounds(n, rank, num_ranks):
    """[start, end) of a rank's shard of n records: an equal split, the
    remainder to the low ranks (core/detection_input.py:790-810)."""
    per, rem = divmod(n, num_ranks)
    start = rank * per + min(rank, rem)
    return start, start + per + (1 if rank < rem else 0)


def batch_count(records, batch_size, aspect_grouping=True):
    """Batches an epoch of `records` gives: each aspect group contributes
    ceil(len / batch) whether its tail is padded or masked."""
    groups = aspect_group(records) if aspect_grouping else [records]
    return sum(-(-len(g) // batch_size) for g in groups if len(g))


def rank_batch_counts(roidb, batch_size, num_ranks, aspect_grouping=True):
    """Every rank's batch count an epoch, from the whole roidb."""
    return [batch_count(roidb[slice(*shard_bounds(len(roidb), r, num_ranks))],
                        batch_size, aspect_grouping)
            for r in range(num_ranks)]


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

        start, end = shard_bounds(len(roidb), rank, num_ranks)
        self.roidb = roidb[start:end]
        for i, r in enumerate(self.roidb):
            r.setdefault("rec_id", start + i)
        self.aspect_grouping = aspect_grouping
        self._all, self._rank, self._num_ranks = roidb, rank, num_ranks
        self._counts = None  # the batch counts are shuffle-invariant
        self._pool = None   # one ThreadPoolExecutor for the loader lifetime

    @property
    def rank_counts(self):
        """Every rank's own batch count an epoch."""
        if self._counts is None:
            self._counts = rank_batch_counts(self._all, self.batch_size,
                                             self._num_ranks,
                                             self.aspect_grouping)
        return self._counts

    @property
    def dropped(self):
        """Batches an epoch this rank leaves out to keep in step."""
        return self.rank_counts[self._rank] - len(self)

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
        return all_batches[:len(self)]

    def __len__(self):
        return min(self.rank_counts)

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
