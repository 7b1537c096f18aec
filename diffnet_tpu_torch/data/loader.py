"""Batching iterator over numpy datasets, yielding torch tensors.

Port of ``diffnet_tpu/data/loader.py``. Datasets have ``__len__`` and
``__getitem__`` returning a tuple of channels-last numpy arrays; a dataset
with a callable ``batch(idx)`` (:class:`InMemoryDataset`) assembles a whole
batch in one call instead. The loader moves each batch to `device`, and
with ``prefetch > 0`` assembles the next batches on a background thread.
The shuffle order is the JAX package's: ``np.random.default_rng(seed)
.shuffle`` of ``arange(n)`` once per epoch.

``mesh=`` is the counterpart of the JAX loader's ``sharding=``: every rank
of a :class:`~diffnet_tpu_torch.parallel.Mesh` draws the same permutation
from the seed, takes the same global batch indices and assembles only its
own rows of each batch (its block along the mesh's 'data' axis), so the
ranks' rows together are the JAX loader's global batch. ``batch_size``
stays the global batch size, which 'data' must divide; the Trainer reads
``loader.mesh`` to all-reduce the gradients. With ``space_axis`` each
array of a batch is also cut to this rank's block along that axis over
the mesh's 'space' axis (:func:`~diffnet_tpu_torch.parallel.local_block`;
axis 1, the rows or depth planes of NHWC / NDHWC fields, is JAX's
``P("data", "space", ...)``); without it every 'space' rank of a data row
gets the same rows whole.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..parallel.mesh import local_block, spatial_mesh

__all__ = ["NumpyLoader", "InMemoryDataset"]


class InMemoryDataset:
    """Pre-built arrays as a dataset: ``(inputs[N, ...], forcing[N, ...])``.

    :meth:`batch` gathers a whole batch with the host library's threaded
    row gather (:func:`~diffnet_tpu_torch.utils.native.gather_batch`), one
    call per array."""

    def __init__(self, inputs: np.ndarray, forcing: np.ndarray):
        if len(inputs) != len(forcing):
            raise ValueError(f"{len(inputs)} inputs against "
                             f"{len(forcing)} forcings")
        self.inputs = inputs
        self.forcing = forcing

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, idx):
        return self.inputs[idx], self.forcing[idx]

    def batch(self, idx):
        """A whole batch: equal to stacking ``self[i]`` for ``i in idx``
        (any dataset exposing ``batch`` must keep it so)."""
        from ..utils.native import gather_batch

        idx = np.asarray(idx, np.int64)
        idx = np.where(idx < 0, idx + len(self), idx)
        return (gather_batch(self.inputs, idx),
                gather_batch(self.forcing, idx))


class NumpyLoader:
    """Parameters: dataset; batch_size (the global batch); shuffle
    (reshuffle every epoch); drop_last (drop the trailing partial batch);
    seed (shuffle seed); device (where the batches go, default the CPU);
    prefetch (batches assembled ahead on a background thread, 0 for none);
    mesh (a process mesh: yield this rank's rows of each batch);
    space_axis (with `mesh`: also this rank's block of every array along
    this axis over 'space')."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 42,
                 device: str | torch.device | None = None,
                 prefetch: int = 0, mesh=None, space_axis: int | None = None):
        if mesh is not None and batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{mesh.data} equal blocks along 'data'")
        if space_axis is not None and mesh is None:
            raise ValueError("space_axis splits over a mesh's 'space' axis: "
                             "pass mesh= too")
        self.dataset = dataset
        self.mesh = mesh
        self.space_axis = space_axis
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        if self.prefetch > 0:
            return self._prefetch_iter()
        return self._plain_iter()

    def _prefetch_iter(self):
        """Batches from a producer thread through a bounded queue. The
        producer hands a dataset exception to the consumer, which raises
        it; a consumer that leaves early (``fast_dev_run``) sets the stop
        flag, and the producer, which never blocks on the queue for more
        than 0.1 s, then ends."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._plain_iter():
                    if not put(b):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)
                return
            put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is end:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        """This rank's block of a global batch's indices along 'data'."""
        k = self.mesh.data
        if len(idx) % k:
            raise ValueError(f"a batch of {len(idx)} does not split into {k} "
                             "equal blocks along 'data' (drop_last=True "
                             "drops the partial batch)")
        m = len(idx) // k
        return idx[self.mesh.data_index * m:(self.mesh.data_index + 1) * m]

    def _plain_iter(self) -> Iterator[tuple[torch.Tensor, ...]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        batch_fn = getattr(self.dataset, "batch", None)
        if not callable(batch_fn):
            # an attribute of that name that is no method keeps the
            # per-item path
            batch_fn = None
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.mesh is not None:
                idx = self._rows(idx)
            if batch_fn is not None:
                arrays = tuple(batch_fn(idx))
            else:
                samples = [self.dataset[int(i)] for i in idx]
                arrays = tuple(np.stack([s[k] for s in samples])
                               for k in range(len(samples[0])))
            if self.space_axis is not None and spatial_mesh(self.mesh):
                arrays = tuple(local_block(a, self.mesh, self.space_axis,
                                           "space") for a in arrays)
            yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .to(self.device) for a in arrays)
