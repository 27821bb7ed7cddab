"""Round checkpointer + model-update export, on ``torch.save``.

The port of the JAX package's ``checkpoint/checkpointer.py``, with its
public surface and commit protocol and without orbax. A checkpoint step is
``{"states": {population: ServerState}, "personal": {population: per-client
state}}`` plus a JSON sidecar with the round index and runner history:

- ``<dir>/<step>/tree.pt`` — one ``torch.save`` of the tree's leaves in
  its flattening order, with their paths; restored with
  ``weights_only=True`` into a template's structure (the freshly
  initialised state, as orbax restores into an abstract tree);
- ``<dir>/<step>/meta.json`` — ``{"round_idx", "history"}``;
- ``<dir>/manifests/step-<n>.json`` — one CRC32 + size entry per step file,
  the durable commit point (tmp -> fsync -> replace -> fsync(dir)).

Off the round's critical path, as orbax's async save and JAX's commit
thread keep it: ``save`` queues each CUDA leaf's copy into pinned host
memory on a side stream and returns; a commit thread (at most one in
flight; every other call joins it first) waits for the copies, writes the
step into a temporary directory, renames it into place and lands the
manifest. The round step changes no tensor in place (the server
optimizers of ``engine/algorithms.py`` build new moment tensors), so the
queued copies read the values the save was handed.

Restore verifies the manifest before touching a step: a mismatch (host died
mid-flush, bit rot, the ``checkpoint.corrupt`` chaos point) skips to the
previous good step without reading it, a step with no manifest is attempted
and skipped if unreadable, each skip logged as ``checkpoint_fallback``.
A port checkpoint is not an orbax step: neither package reads the other's.
Model files (:class:`ModelUpdateExporter`) are the interchange format.

Over the mesh's ranks (:attr:`RoundCheckpointer.group`, the runner's world
group: dp, and mp or pp) the runner hands every rank's save the same full
tree (sharded optimizer state gathered to its flat padded layout,
per-client state over the whole population and, under mp, whole); rank 0
writes it, and every rank meets the others at each
commit (:meth:`RoundCheckpointer.wait` agrees on the commit's outcome, so
a failed write raises on every rank) and reads the same step on restore.
As in the JAX package, a step whose leaves do not match the template (a
sharded optimizer state saved at a dp whose padding differs) is unreadable,
and restore falls back past it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.checkpoint.msgpack_wire import (
    msgpack_restore,
    restore_into,
    sorted_tree,
    to_bytes,
)
from olearning_sim_tpu_torch.storage.file_repo import FileRepo
from olearning_sim_tpu_torch.utils.durable import atomic_write_bytes, fsync_dir

_TREE = "tree.pt"
_META = "meta.json"


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a tree of dataclasses, dicts, lists and tuples,
    in field / insertion order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in _flatten(getattr(tree, f.name), path + (f.name,))]
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _flatten(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(template, leaves: Dict[Tuple[str, ...], Any], path: Tuple[str, ...] = ()):
    """The inverse of :func:`_flatten` into ``template``'s structure: tensors
    land on the template leaf's device and must match its shape and dtype."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves, path + (f.name,))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, path + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves, path + (str(i),))
                              for i, v in enumerate(template))
    value = leaves[path]
    if isinstance(template, torch.Tensor):
        if (not isinstance(value, torch.Tensor) or value.shape != template.shape
                or value.dtype != template.dtype):
            raise ValueError(f"checkpoint leaf {'/'.join(path)} does not match the "
                             f"template's {tuple(template.shape)} {template.dtype}")
        return value.to(template.device)
    return value


def _tree_bytes(leaves) -> int:
    """Payload size of the tensor leaves (device or host)."""
    return sum(v.numel() * v.element_size() for _, v in leaves
               if isinstance(v, torch.Tensor))


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    return obj


def _write_durable(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class RoundCheckpointer:
    """Save/restore the full simulation state per round.

    ``save`` is cheap to call every round; ``max_to_keep`` bounds disk use.
    ``restore`` needs the freshly-initialized state as a template (structure,
    shapes, dtypes, devices).
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 task_id: str = "", registry=None):
        """``registry`` — telemetry sink for save/restore bytes and latency
        (defaults to the port's process default registry)."""
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.task_id = task_id
        self.registry = registry
        os.makedirs(directory, exist_ok=True)
        # The in-flight commit (at most one) and the error of the last one
        # that failed, raised by the next wait() or save().
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_error: Optional[BaseException] = None
        self._streams: Dict[torch.device, Any] = {}
        # The group of the ranks that share this directory (set by the
        # runner: every rank of the mesh); None: one process.
        self.group = None

    @property
    def writer(self) -> bool:
        """Whether this rank writes (rank 0 of the group)."""
        return collectives.rank(self.group) == 0

    def _barrier(self) -> None:
        if self.group is not None:
            collectives.agree(False, self.group)

    def _call(self, point: str, fn, *args, **kwargs):
        """``fn`` behind the ``point`` fault-injection point."""
        from olearning_sim_tpu_torch.resilience import faults

        faults.inject(point, context=self.directory, task_id=self.task_id)
        return fn(*args, **kwargs)

    def _step_dir(self, round_idx: int) -> str:
        return os.path.join(self.directory, str(int(round_idx)))

    def _all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    # -------------------------------------------------------------- save
    def save(self, round_idx: int, states: Dict[str, Any],
             personal: Dict[str, Any], history: List[Dict[str, Any]],
             force: bool = False) -> None:
        """``force=True`` overwrites an existing step — the rollback-replay
        path re-saves rounds it re-executes."""
        from olearning_sim_tpu_torch.telemetry import instrument

        meta = {"round_idx": int(round_idx), "history": _jsonable(history)}
        # One commit in flight: the previous step must have landed (and its
        # error, if any, surfaced) before this one is staged.
        self.wait()
        # The writer's view of the directory, taken before its commit of this
        # step can start, decides for every rank.
        if not force and collectives.agree(
                self.writer and os.path.isdir(self._step_dir(round_idx)), self.group):
            raise FileExistsError(f"checkpoint step {round_idx} already exists in "
                                  f"{self.directory}")
        t0 = time.perf_counter()
        leaves = _flatten({"states": states, "personal": personal})
        # Every rank passes the fault point, so an injected failure fails
        # every rank alike; only the writer stages.
        stage = self._stage if self.writer else (lambda _leaves: ([], []))
        staged, events = self._call("checkpoint.save", stage, leaves)
        instrument("ols_checkpoint_save_duration_seconds",
                   self.registry).labels(
            task_id=self.task_id
        ).observe(time.perf_counter() - t0)
        instrument("ols_checkpoint_save_bytes_total",
                   self.registry).labels(
            task_id=self.task_id
        ).inc(_tree_bytes(leaves))
        if self.writer:
            self._start_commit(round_idx, staged, events, meta)
        self._maybe_corrupt(round_idx)

    def _side_stream(self, dev: torch.device):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(device=dev)
        return self._streams[dev]

    def _stage(self, leaves):
        """Queue every CUDA leaf's copy into pinned host memory on a side
        stream that first waits for the work already queued on the leaf's
        stream; host leaves are referenced. Returns the host leaves and the
        events the commit thread waits for."""
        staged, events = [], {}
        for path, v in leaves:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                stream = self._side_stream(v.device)
                if v.device not in events:
                    stream.wait_stream(torch.cuda.current_stream(v.device))
                    events[v.device] = None
                with torch.cuda.stream(stream):
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v, non_blocking=True)
                # The caching allocator must not hand v's memory to the
                # next round while the side stream still reads it.
                v.record_stream(stream)
                v = host
            elif isinstance(v, torch.Tensor):
                v = v.detach()
            elif not (v is None or isinstance(v, (bool, int, float, str))):
                raise TypeError(f"cannot checkpoint leaf {'/'.join(path)} of type "
                                f"{type(v).__name__}")
            staged.append((path, v))
        for dev in events:
            events[dev] = torch.cuda.Event()
            events[dev].record(self._side_stream(dev))
        return staged, list(events.values())

    def _maybe_corrupt(self, round_idx: int) -> None:
        """Chaos hook: the ``checkpoint.corrupt`` injection point simulates
        on-disk corruption by truncating the step's largest payload file
        after a (completed) save — the scenario ``restore``'s fallback
        exists for. No-op unless a fault plan arms it."""
        from olearning_sim_tpu_torch.resilience import faults

        spec = faults.fire("checkpoint.corrupt", context=str(round_idx),
                           round_idx=round_idx, task_id=self.task_id)
        if spec is None:
            return
        # Land the manifest BEFORE truncating, so the corruption is
        # deterministically a post-commit tear (manifest mismatch at
        # restore).
        self._join_commit()
        if not self.writer:
            return
        step_dir = self._step_dir(round_idx)
        largest, size = None, -1
        for dirpath, _dirs, files in os.walk(step_dir):
            for f in files:
                p = os.path.join(dirpath, f)
                s = os.path.getsize(p)
                if s > size:
                    largest, size = p, s
        if largest is not None:
            with open(largest, "r+b") as f:
                f.truncate(max(0, size // 2))

    # ----------------------------------------------------------- commits
    def _start_commit(self, round_idx: int, staged, events, meta) -> None:
        def commit():
            try:
                self._commit(round_idx, staged, events, meta)
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._commit_error = e

        t = threading.Thread(target=commit, name="ckpt-commit", daemon=True)
        t.start()
        self._commit_thread = t

    def _join_commit(self) -> None:
        t, self._commit_thread = self._commit_thread, None
        if t is not None:
            t.join()

    def _commit(self, round_idx: int, staged, events, meta) -> None:
        """The step's write and its durable commit point: wait for the host
        copies, write the step into a temporary directory, rename it into
        place, land the manifest, then drop steps beyond ``max_to_keep``.
        A step without a valid manifest was never committed."""
        for ev in events:
            ev.synchronize()
        tmp = tempfile.mkdtemp(prefix=f".{int(round_idx)}.", dir=self.directory)
        try:
            _write_durable(os.path.join(tmp, _TREE), lambda f: torch.save(
                {"paths": [list(p) for p, _ in staged], "leaves": [v for _, v in staged]}, f))
            _write_durable(os.path.join(tmp, _META),
                           lambda f: f.write(json.dumps(meta).encode("utf-8")))
            fsync_dir(tmp)
            step_dir = self._step_dir(round_idx)
            if os.path.isdir(step_dir):
                # A forced re-save: the old manifest goes first, so that a
                # crash in between leaves a manifest-less step, never a
                # manifest over the wrong files.
                with contextlib.suppress(OSError):
                    os.remove(self._manifest_path(round_idx))
                shutil.rmtree(step_dir)
            os.replace(tmp, step_dir)
            fsync_dir(self.directory)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        atomic_write_bytes(
            self._manifest_path(round_idx),
            json.dumps({"round_idx": int(round_idx),
                        "files": self._step_checksums(round_idx)},
                       sort_keys=True).encode("utf-8"),
        )
        steps = self._all_steps()
        for step in steps[:max(0, len(steps) - self.max_to_keep)]:
            self._delete_step(step)

    def _delete_step(self, step: int) -> None:
        # Step FIRST, manifest second: a manifest-less-but-intact step is
        # still attempted by restore, so the reverse order would let a crash
        # mid-delete resurrect the very checkpoint being deleted. A crash
        # after the step delete merely leaves an orphan manifest, which
        # verification never consults.
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        with contextlib.suppress(OSError):
            os.remove(self._manifest_path(step))

    def _manifest_path(self, round_idx: int) -> str:
        return os.path.join(self.directory, "manifests",
                            f"step-{int(round_idx)}.json")

    def _step_checksums(self, round_idx: int) -> Dict[str, List[int]]:
        """{relative file path: [size, crc32]} over the step directory."""
        step_dir = self._step_dir(round_idx)
        files: Dict[str, List[int]] = {}
        for dirpath, _dirs, names in os.walk(step_dir):
            for name in sorted(names):
                path = os.path.join(dirpath, name)
                crc = 0
                with open(path, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        crc = zlib.crc32(chunk, crc)
                files[os.path.relpath(path, step_dir)] = [
                    os.path.getsize(path), crc
                ]
        return files

    def verify_step(self, round_idx: int) -> Optional[bool]:
        """Manifest verdict for a retained step: ``True`` committed and
        intact, ``False`` torn (manifest/checksum mismatch — never
        deserialize it), ``None`` no manifest (attempt it, and fall back if
        it does not load)."""
        self._join_commit()
        path = self._manifest_path(round_idx)
        if not os.path.isfile(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                manifest = json.load(f)
            expected = manifest["files"]
        except (OSError, ValueError, KeyError):
            return False  # torn manifest: the commit itself is suspect
        return expected == self._step_checksums(round_idx)

    def wait(self) -> None:
        """Block until the in-flight commit has landed; raise its error if
        it failed. Over dp ranks every rank waits here for the writer's
        commit and raises if it failed."""
        self._join_commit()
        err, self._commit_error = self._commit_error, None
        if collectives.agree(err is not None, self.group):
            raise err if err is not None else RuntimeError(
                "checkpoint commit failed on rank 0")

    # ----------------------------------------------------------- restore
    def latest_round(self) -> Optional[int]:
        self._join_commit()
        steps = self._all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int, template, device):
        step_dir = self._step_dir(step)
        tree = torch.load(os.path.join(step_dir, _TREE), map_location=device,
                          weights_only=True)
        with open(os.path.join(step_dir, _META), encoding="utf-8") as f:
            meta = json.load(f)
        paths = [p for p, _ in _flatten(template)]
        saved = [tuple(p) for p in tree["paths"]]
        if saved != paths:
            raise ValueError(f"checkpoint step {step} holds another tree than the template")
        return _rebuild(template, dict(zip(saved, tree["leaves"]))), meta, tree["leaves"]

    def restore(
        self,
        template_states: Dict[str, Any],
        template_personal: Dict[str, Any],
    ) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any], List[Dict[str, Any]]]]:
        """Returns (last_completed_round, states, personal, history), or None
        when no checkpoint exists.

        Tolerant of a truncated/corrupt newest checkpoint: steps are tried
        newest-first, and an unreadable step falls back to the previous
        retained round (logged + counted as ``checkpoint_fallback``) instead
        of raising. Returns None only when NO retained step is readable."""
        from olearning_sim_tpu_torch.resilience import CHECKPOINT_FALLBACK, NON_RETRYABLE
        from olearning_sim_tpu_torch.resilience.events import global_log
        from olearning_sim_tpu_torch.telemetry import instrument

        self._join_commit()
        self._barrier()
        steps = sorted(self._all_steps(), reverse=True)
        if not steps:
            return None
        template = {"states": template_states, "personal": template_personal}
        device = next((v.device for _, v in _flatten(template)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
        log = global_log()
        for step in steps:
            verdict = self.verify_step(step)
            if verdict is False:
                # Torn/partial commit (host died mid-flush, or corruption):
                # skip to the previous good step without deserializing it.
                log.record(
                    CHECKPOINT_FALLBACK, point="checkpoint.manifest",
                    task_id=self.task_id, round_idx=int(step),
                    error="manifest mismatch: torn or corrupt step",
                    remaining_steps=len([s for s in steps if s < step]),
                )
                continue
            t0 = time.perf_counter()
            try:
                try:
                    tree, meta, leaves = self._call(
                        "checkpoint.restore", self._load_step, step, template, device)
                finally:
                    # Per ATTEMPTED step — a slow failed read during
                    # corrupt-checkpoint fallback is exactly the latency
                    # worth seeing.
                    instrument(
                        "ols_checkpoint_restore_duration_seconds",
                        self.registry,
                    ).labels(task_id=self.task_id).observe(
                        time.perf_counter() - t0
                    )
                instrument("ols_checkpoint_restore_bytes_total",
                           self.registry).labels(
                    task_id=self.task_id
                ).inc(_tree_bytes([(None, v) for v in leaves]))
                return (int(meta["round_idx"]), tree["states"], tree["personal"],
                        list(meta["history"]))
            except Exception as e:  # noqa: BLE001 — fall back to older step
                if isinstance(e, NON_RETRYABLE):
                    # A preemption during recovery is process death, not a
                    # corrupt step — it must bubble, not skip valid steps.
                    raise
                log.record(
                    CHECKPOINT_FALLBACK, point="checkpoint.restore",
                    task_id=self.task_id, round_idx=int(step),
                    error=f"{type(e).__name__}: {str(e)[:200]}",
                    remaining_steps=len([s for s in steps if s < step]),
                )
        return None

    def discard_steps_after(self, round_idx: int) -> List[int]:
        """Delete retained steps newer than ``round_idx`` (rollback-replay:
        stale/corrupt future checkpoints must not shadow the replayed
        rounds). Returns the discarded steps."""
        self._join_commit()
        self._barrier()
        discarded = [s for s in self._all_steps() if s > round_idx]
        try:
            if self.writer:
                for step in discarded:
                    self._delete_step(step)
        finally:
            self._barrier()
        return discarded

    def close(self) -> None:
        self._join_commit()


# ---------------------------------------------------------------- model files
def export_model_bytes(params: Any) -> bytes:
    """Serialize a param tree in flax's msgpack wire format. ``params`` is
    the flax-layout tree (``weights.params_to_jax``); its maps are written
    key-sorted, as a JAX export writes the tree ``jax.device_get`` returns."""
    return to_bytes(sorted_tree(params))


def import_model_bytes(template: Any, data: bytes) -> Any:
    """``flax.serialization.from_bytes``: the file's tree in ``template``'s
    structure."""
    return restore_into(template, msgpack_restore(data))


@dataclasses.dataclass
class ModelUpdateExporter:
    """Round-file convention for external-aggregator interop.

    Reference model_update_style: round r>0 downloads
    ``{task_id}_{current_round}_result_model.mnn`` written by the aggregator
    (``utils_run_task.py:327-397``); here the platform itself writes/reads the
    per-round global model through any :class:`FileRepo`.
    """

    repo: FileRepo
    task_id: str
    update_style: str = "{task_id}_{round}_result_model.msgpack"
    # The platform-appropriate temp dir (honors TMPDIR), not a hardcoded
    # "/tmp" that breaks on hosts without one.
    scratch_dir: str = dataclasses.field(default_factory=tempfile.gettempdir)

    def _name(self, round_idx: int) -> str:
        # {current_round} is the reference's placeholder spelling
        # (utils_run_task.py:335); {round} is the JAX package's — accept both.
        return self.update_style.format(
            task_id=self.task_id, round=round_idx, current_round=round_idx
        )

    def export(self, round_idx: int, params: Any) -> str:
        name = self._name(round_idx)
        os.makedirs(self.scratch_dir, exist_ok=True)
        # mkstemp, not a fixed path: a concurrent exporter/loader for the same
        # task+round must never see a partially written or clobbered file.
        fd, local = tempfile.mkstemp(prefix=name + ".", dir=self.scratch_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(export_model_bytes(params))
            if not self.repo.upload_file(local, name):
                raise IOError(f"model export failed: {name}")
        finally:
            if os.path.exists(local):
                os.remove(local)
        return name

    def load(self, round_idx: int, template: Any) -> Any:
        return self.load_path(self._name(round_idx), template)

    def load_path(self, path: str, template: Any) -> Any:
        """Fetch any model file from the repo (round files, warm-start
        ``Model.modelPath``) through the same staging discipline as export."""
        os.makedirs(self.scratch_dir, exist_ok=True)
        fd, local = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".", dir=self.scratch_dir
        )
        os.close(fd)
        try:
            if not self.repo.download_file(path, local):
                raise FileNotFoundError(f"model file not found: {path}")
            with open(local, "rb") as f:
                data = f.read()
        finally:
            if os.path.exists(local):
                os.remove(local)
        return import_model_bytes(template, data)
