"""Host batches to a CUDA device through pinned memory on a copy stream.

A copy from pageable host memory cannot run asynchronously: CUDA stages
it through buffers of its own, in order with the kernels queued on the
copy's stream, and the host waits until it is done. `HostStager` owns a
small ring of pinned buffers instead. The host copies a batch's bytes into
the next buffer, a stream of its own copies that buffer to the device, and
the caller's stream waits on the copy's event rather than the host on the
copy.
"""

from __future__ import annotations

import threading

import torch

from facenet_tpu_torch.utils import profiling

# the embedders' callers keep one batch in flight (`evaluate_embeddings`):
# one slot is refilled while the other's copy may still run
SLOTS = 2


class HostStager:
    """Copies host batches to `device`.

    ``stager(images)`` returns `images` on the device, by what they are:

      * a tensor already on the device: `images` itself, with no copy;
      * anything for a device other than CUDA, or a tensor on another CUDA
        device: ``torch.as_tensor(images).to(device, non_blocking=True)``;
      * a host array or tensor for a CUDA device: staged. The host copies
        its bytes into the next of `SLOTS` pinned buffers (span
        ``facenet.h2d.stage``), so the caller may reuse its array as soon as
        the call returns. The copy stream then copies the buffer into a new
        device tensor and records an event, and the current stream waits on
        that event before it reads the tensor.

    A buffer is refilled only after its last copy to the device has
    completed; the host waits for that in span ``facenet.h2d.slot_wait``,
    which it enters only when the copy is still running. A buffer grows to
    the largest batch it has held, and is viewed at each batch's shape and
    dtype. The device tensor comes from the copy stream's memory pool and is
    recorded on the current stream, so its memory is not handed out again
    until the work queued there by then, which reads it, has finished.
    """

    def __init__(self, device):
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = device
        self.stream = None
        if device.type == 'cuda':
            self.stream = torch.cuda.Stream(device)
            self._copied = [torch.cuda.Event() for _ in range(SLOTS)]
        self._buffers = [None] * SLOTS
        self._next = 0
        self._lock = threading.Lock()

    def __call__(self, images):
        if isinstance(images, torch.Tensor) and images.device == self.device:
            return images
        images = torch.as_tensor(images)
        if self.stream is None or images.device.type != 'cpu':
            return images.to(self.device, non_blocking=True)
        with self._lock:
            return self._stage(images)

    def _stage(self, host):
        k = self._next
        self._next = (k + 1) % len(self._buffers)
        copied = self._copied[k]
        if not copied.query():
            with profiling.annotate('facenet.h2d.slot_wait'):
                copied.synchronize()
        nbytes = host.numel() * host.element_size()
        buffer = self._buffers[k]
        if buffer is None or buffer.numel() < nbytes:
            buffer = self._buffers[k] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        slot = buffer[:nbytes].view(host.dtype).view(host.shape)
        with profiling.annotate('facenet.h2d.stage'):
            slot.copy_(host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            out.copy_(slot, non_blocking=True)
            copied.record(self.stream)
        compute.wait_event(copied)
        out.record_stream(compute)
        return out
