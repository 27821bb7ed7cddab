"""Double-buffered staging of host blocks onto the device.

The streamed round (``FedCore.stream_round``) keeps its population on the
host and moves it to the device one stream block at a time. A block is a
dict of CPU tensors (features, labels, weights, ...) that a gather function
builds; :class:`BlockStager` turns it into device tensors.

On the CPU (the caller asked for it) staging is a plain synchronous
conversion when the block is submitted: no pinned memory, no copy stream,
no thread.

On CUDA:

- every staged array has two pinned host buffers and two device buffers
  (slots); block ``i`` uses slot ``i % 2``, so the device holds at most two
  staged blocks;
- the gather writes the block into its pinned slot (casting, e.g. float
  features to bf16, on the host), and the slot is copied to the device with
  ``non_blocking=True`` on a dedicated copy stream, whose event the compute
  stream waits on before the block's first kernel;
- before a slot is reused, the host waits for the slot's previous copy to
  land (its pinned memory is free) and the copy stream waits for the
  compute that read its previous block (its device memory is free);
- the gather, the cast and the copies run on one staging thread, so that
  the next block is prepared while the host thread launches the current
  block's kernels (numpy and torch copies release the GIL).

There is no quiet fallback on CUDA: a failed pin or stream setup raises.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch

# A gathered block: name -> (CPU tensor, dtype to stage it in).
HostBlock = Dict[str, tuple]


class _Slot:
    """One buffer set: pinned host and device tensors per staged array, and
    the events that guard their reuse."""

    def __init__(self, block: HostBlock, device: torch.device):
        self.pinned = {}
        self.dev = {}
        for k, (t, dtype) in block.items():
            pin = torch.empty(t.shape, dtype=dtype, pin_memory=True)
            if not pin.is_pinned():
                raise RuntimeError(f"staging buffer {k!r} is not pinned")
            self.pinned[k] = pin
            self.dev[k] = torch.empty(t.shape, dtype=dtype, device=device)
        self.copied = torch.cuda.Event()   # the slot's H2D copies landed
        self.freed = torch.cuda.Event()    # the compute reading the slot ended
        self.used = False


class BlockStager:
    """Stages gathered host blocks on ``device``; see the module docstring.

    ``submit(i, gather)`` stages block ``i`` (``gather()`` builds it) on
    the staging thread (on the CPU, at once) and returns a handle;
    ``wait(handle)`` returns the block's device tensors, ordered before
    any later kernel of the compute stream; ``release(i)``
    marks the end of the compute that reads block ``i``. Blocks are
    submitted in order, each after the previous one was waited for, and
    block ``i + 2`` only after ``release(i)``. ``staging_s`` sums the
    seconds spent gathering, casting and issuing copies, whichever thread
    ran them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.staging_s = 0.0
        self.staged_bytes: List[int] = []
        self._executor: Optional[ThreadPoolExecutor] = None
        if self.cuda:
            self.compute_stream = torch.cuda.current_stream(device)
            self.copy_stream = torch.cuda.Stream(device)
            self._slots: List[Optional[_Slot]] = [None, None]
            self._executor = ThreadPoolExecutor(1, thread_name_prefix="stream-stage")

    def _stage(self, i: int, gather: Callable[[], HostBlock]):
        t0 = time.perf_counter()
        block = gather()
        self.staged_bytes.append(sum(t.numel() * dtype.itemsize
                                     for t, dtype in block.values()))
        if not self.cuda:
            out = {k: t.to(dtype) for k, (t, dtype) in block.items()}
            self.staging_s += time.perf_counter() - t0
            return out
        slot = self._slots[i % 2]
        if slot is None:
            with torch.cuda.stream(self.compute_stream):
                slot = self._slots[i % 2] = _Slot(block, self.device)
        else:
            # The slot's previous copy must have landed before its pinned
            # memory is overwritten.
            slot.copied.synchronize()
        for k, (t, _) in block.items():
            slot.pinned[k].copy_(t)
        with torch.cuda.stream(self.copy_stream):
            if slot.used:
                # ... and the compute that read its device memory ended.
                self.copy_stream.wait_event(slot.freed)
            for k, pin in slot.pinned.items():
                slot.dev[k].copy_(pin, non_blocking=True)
            slot.copied.record(self.copy_stream)
        slot.used = True
        self.staging_s += time.perf_counter() - t0
        return slot

    def submit(self, i: int, gather: Callable[[], HostBlock]):
        if not self.cuda:
            return self._stage(i, gather)
        return self._executor.submit(self._stage, i, gather)

    def wait(self, handle) -> Dict[str, torch.Tensor]:
        if not self.cuda:
            return handle
        slot = handle.result()
        self.compute_stream.wait_event(slot.copied)
        return slot.dev

    def release(self, i: int) -> None:
        if self.cuda:
            self._slots[i % 2].freed.record(self.compute_stream)

    def close(self) -> None:
        """Join the staging thread; later work on the compute stream is
        ordered after every copy (the slots' memory may be reused)."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self.cuda:
            self.compute_stream.wait_stream(self.copy_stream)
