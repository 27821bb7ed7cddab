"""The operations a piece of eager PyTorch dispatches, recorded.

The JAX package reads its guarantees off the compiled HLO
(``engine/hlo_stats.py``). Eager PyTorch compiles nothing, but every call
reaches the dispatcher as a sequence of aten operations, which a
``TorchDispatchMode`` sees after autograd and ``vmap`` have turned them
into the operations that really run. :class:`OpRecorder` keeps, for each:

- its name (``aten.mm.default``), the shapes and dtypes of its tensor
  outputs and their bytes;
- the host syncs: the operations in :data:`SYNC_OPS`, which read a value
  back to the host (``aten._local_scalar_dense`` is what ``.item()``,
  ``float(t)`` and ``bool(t)`` reach) or size their output by the data;
- the largest tensor storage an output lives in (an input's, when the
  output is a view of it, as JAX's largest buffer is often a parameter);
- and, through ``parallel/collectives.py``'s ``RECORDER`` hook, each of
  the port's collectives by kind, with the bytes it sends and receives.

What it cannot see on the CPU: a copy between host and card is a no-op
when both are the CPU, so ``.cpu()``, ``.numpy()`` and ``.tolist()`` leave
no operation behind (``analysis/ast_rules.py``'s host-sync rule finds them
in the source, and ``chip_smoke.py`` phase 19 counts every sync on the
card under ``torch.cuda.set_sync_debug_mode``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# Operations that wait for the card: a value read back to the host, or an
# output whose size the data decides.
SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default",
    "aten.nonzero.default",
    "aten.masked_select.default",
})

# The port's collective names (``collectives.BYTES``) and the HLO
# collective kind each one is in the JAX package's compiled round.
JAX_KIND = {
    "psum": "all-reduce", "pmax": "all-reduce", "mp_psum": "all-reduce",
    "ep_psum": "all-reduce", "pp_psum": "all-reduce",
    "psum_scatter": "reduce-scatter", "all_gather": "all-gather",
    "all_to_all": "all-to-all", "pp_hop": "collective-permute",
}


@dataclasses.dataclass
class OpTrace:
    """What one recorded window dispatched."""

    # (name, output shapes, output dtypes) per operation, in order.
    ops: List[Tuple[str, Tuple[Tuple[int, ...], ...], Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    out_bytes: List[int] = dataclasses.field(default_factory=list)
    syncs: int = 0
    # (kind, bytes sent, bytes received) per collective call, in order.
    collectives: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    largest_bytes: int = 0
    largest_op: Optional[str] = None

    @property
    def dtypes(self) -> List[str]:
        return sorted({d for _, _, ds in self.ops for d in ds})

    def collective_bytes(self) -> Dict[str, int]:
        """Bytes sent per collective kind over the window."""
        out: Dict[str, int] = {}
        for kind, sent, _ in self.collectives:
            out[kind] = out.get(kind, 0) + sent
        return out


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class OpRecorder(TorchDispatchMode):
    """``with OpRecorder() as rec: ...`` records into ``rec.trace``. The
    recorder only observes: every operation runs as it would without it."""

    def __init__(self):
        super().__init__()
        self.trace = OpTrace()
        self._prev = None

    def _on_collective(self, kind: str, sent: int, received: int) -> None:
        self.trace.collectives.append((kind, sent, received))

    def __enter__(self):
        from olearning_sim_tpu_torch.parallel import collectives

        self._prev = collectives.RECORDER
        collectives.RECORDER = self._on_collective
        return super().__enter__()

    def __exit__(self, *exc):
        from olearning_sim_tpu_torch.parallel import collectives

        collectives.RECORDER = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        tensors = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        shapes = tuple(tuple(t.shape) for t in tensors)
        dtypes = tuple(_dtype_name(t.dtype) for t in tensors)
        tr = self.trace
        tr.ops.append((name, shapes, dtypes))
        tr.out_bytes.append(sum(t.numel() * t.element_size() for t in tensors))
        if name in SYNC_OPS:
            tr.syncs += 1
        for t in tensors:
            if t.device.type == "meta":
                continue
            n = t.untyped_storage().nbytes()
            if n > tr.largest_bytes:
                tr.largest_bytes, tr.largest_op = n, name
        return out


def first_diff(a: OpTrace, b: OpTrace) -> Optional[str]:
    """Where two traces part, as one line, or None when they dispatched
    the same operations (name, output shapes, dtypes) and collectives."""
    for i in range(max(len(a.ops), len(b.ops))):
        oa = a.ops[i] if i < len(a.ops) else None
        ob = b.ops[i] if i < len(b.ops) else None
        if oa != ob:
            return (f"first diff at operation {i + 1} of {len(a.ops)} vs "
                    f"{len(b.ops)}: {oa!r} vs {ob!r}")
    for i in range(max(len(a.collectives), len(b.collectives))):
        ca = a.collectives[i] if i < len(a.collectives) else None
        cb = b.collectives[i] if i < len(b.collectives) else None
        if ca != cb:
            return f"first diff at collective {i + 1}: {ca!r} vs {cb!r}"
    return None
