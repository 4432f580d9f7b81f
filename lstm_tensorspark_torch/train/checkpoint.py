"""Checkpoints and resume: a training run's whole state, one file a step.

Port of the single-process part of
``lstm_tensorspark_tpu/train/checkpoint.py``: its durability and its
corruption rules, with the port's own file format.

- :func:`atomic_write` writes a writer-unique temporary file, fsyncs it and
  renames it into place; with ``checksum`` the old ``.sha256`` sidecar is
  removed before the rename and the new one written after it, so a crash
  anywhere leaves a payload without a sidecar (read as legacy), never a
  payload beside another's hash.
- :func:`read_verified` checks a file against its sidecar; a file without
  one is accepted as legacy.
- :class:`Checkpointer` keeps ``step_<N>.pt`` files (the newest ``keep``)
  in a directory. :meth:`Checkpointer.restore_latest` quarantines a step
  whose checksum fails, or a legacy file that will not parse (renamed
  ``*.quarantined``, kept), and falls back to the next-newest; it re-raises
  a parse failure of a verified file (the bytes are what was written, so
  the caller's model or optimizer differs: a loud error, not a quarantine),
  never quarantines on an ``OSError`` (transient IO), and tries each step
  at most once.

A file is ``torch.save`` of a plain dict, read back with ``torch.load(...,
weights_only=True)``: ``step``, ``params`` (the leaves in
``train/loop.py::param_leaves`` order), ``opt_state`` (the optimizer's
dict of tensors and lists of tensors), ``carries`` (a list of (h, c) or
None), ``generators`` (the states of the run's random generators: the
dropout masks' Philox states) and ``start_step`` (the data cursor: the
optimizer steps the feed has served). Tensors are saved from the host.

:func:`wire_checkpoint` is the train command's wiring (``--checkpoint-dir``,
``--checkpoint-every``, ``--resume``), shared by the LM and the classifier.

The sharded (multi-process), best-metric (``--keep-best``,
``--resume-best``) and asynchronous (``--async-checkpoint``) parts of the
JAX module are not ported.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import threading

import torch

from ..utils import span

#: the file of a step by format: the port's ``step_<N>.pt`` and the JAX
#: package's ``step_<N>.msgpack`` (read only, ``train/jax_checkpoint.py``);
#: sidecars and quarantined files do not match
SUFFIXES = {"torch": ".pt", "jax": ".msgpack"}


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed its sha256 sidecar check (a torn write, bit rot),
    or a legacy file without a sidecar could not be parsed.
    :meth:`Checkpointer.restore_latest` quarantines the step and falls
    back; this escapes only from paths with nothing to fall back to."""


def atomic_write(path: str, data: bytes, *, checksum: bool = False) -> None:
    """Write ``data`` to ``path`` durably: a writer-unique temporary file,
    fsynced, then renamed into place. ``checksum`` also writes the
    ``<path>.sha256`` sidecar that :func:`read_verified` checks: any old
    sidecar is removed before the payload's rename and the new one lands
    after it."""
    uniq = f".{os.getpid()}.{threading.get_ident()}.tmp"
    tmp = path + uniq
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if checksum:
        try:
            os.remove(path + ".sha256")
        except FileNotFoundError:
            pass
    os.replace(tmp, path)
    if checksum:
        side_tmp = path + ".sha256" + uniq
        with open(side_tmp, "wb") as f:
            f.write(hashlib.sha256(data).hexdigest().encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(side_tmp, path + ".sha256")


def read_verified(path: str) -> bytes:
    """The bytes of ``path``, checked against its sha256 sidecar when one
    exists (a file without one is accepted as legacy). Raises
    :class:`CorruptCheckpointError` on a mismatch."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        with open(path + ".sha256") as f:
            expect = f.read().strip()
    except FileNotFoundError:
        return data
    got = hashlib.sha256(data).hexdigest()
    if got != expect:
        raise CorruptCheckpointError(
            f"{path}: sha256 mismatch (expected {expect[:12]}…, got "
            f"{got[:12]}…): a truncated or corrupted write")
    return data


def classified_parse(path: str, data: bytes, parse):
    """``parse(data)``, its failure classified by the module's rule: a
    verified file (it has a sidecar) re-raises, a legacy file raises
    :class:`CorruptCheckpointError`."""
    try:
        return parse(data)
    except Exception as e:
        if os.path.exists(path + ".sha256"):
            raise
        raise CorruptCheckpointError(
            f"{path}: cannot parse legacy (unchecksummed) file: "
            f"{type(e).__name__}: {e}") from e


def _host(x):
    """``x`` with every tensor detached and copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


class Checkpointer:
    """``step_<N>.pt`` checkpoints under ``directory``, the newest ``keep``
    kept. A state is the plain dict of the module docstring. ``fmt="jax"``
    reads the JAX package's ``step_<N>.msgpack`` files instead (decoded by
    ``train/jax_checkpoint.decode``; it saves nothing), with the same
    discovery, verification and quarantine."""

    def __init__(self, directory: str, *, keep: int = 3, fmt: str = "torch"):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if fmt not in SUFFIXES:
            raise ValueError(f"fmt must be one of {sorted(SUFFIXES)}, got "
                             f"{fmt!r}")
        self.directory = directory
        self.keep = keep
        self.fmt = fmt
        self._pat = re.compile(r"step_(\d+)" + re.escape(SUFFIXES[fmt]) + "$")
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        """Restorable steps, ascending."""
        return sorted(int(m.group(1)) for m in map(self._pat.match,
                                                   os.listdir(self.directory))
                      if m)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}{SUFFIXES[self.fmt]}")

    def has_checkpoint(self) -> bool:
        return bool(self._steps())

    def has_quarantined(self) -> bool:
        """Whether the directory holds ``*.quarantined`` files: checkpoints
        existed and were set aside as corrupt."""
        try:
            return any(n.endswith(".quarantined")
                       for n in os.listdir(self.directory))
        except OSError:
            return False

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: dict) -> str:
        """Write ``state`` (``state["step"]`` names the file) with its
        sidecar, then drop all but the newest ``keep`` steps. Returns the
        path."""
        if self.fmt != "torch":
            raise ValueError(f"a {self.fmt} checkpoint directory is read only")
        with span("checkpoint_save"):
            buf = io.BytesIO()
            torch.save(_host(state), buf)
            path = self.path_for(int(state["step"]))
            atomic_write(path, buf.getvalue(), checksum=True)
            for step in self._steps()[:-self.keep]:
                for name in (self.path_for(step),
                             self.path_for(step) + ".sha256"):
                    try:
                        os.remove(name)
                    except FileNotFoundError:
                        pass
        return path

    def _quarantine(self, step: int, reason: str) -> None:
        """Rename step ``step``'s file and sidecar to ``*.quarantined``: the
        discovery pattern stops matching it, the evidence stays."""
        print(f"checkpoint: QUARANTINING step {step}: {reason}", flush=True)
        for name in (self.path_for(step), self.path_for(step) + ".sha256"):
            try:
                os.replace(name, name + ".quarantined")
            except OSError:
                pass  # best effort: a quarantine that cannot rename ends too

    def restore_latest(self, parse=None):
        """The newest valid checkpoint, or None when there is none.
        ``parse(state) -> value`` turns the loaded dict into what the
        caller needs (it raises when the checkpoint does not fit the
        caller's model or optimizer); the value is returned. Corrupt
        steps are quarantined and the next-newest tried, each at most
        once; see the module docstring for what is re-raised."""
        attempted: set[int] = set()
        while True:
            steps = [s for s in self._steps() if s not in attempted]
            if not steps:
                return None
            step = steps[-1]
            attempted.add(step)
            path = self.path_for(step)
            try:
                data = read_verified(path)
                return classified_parse(
                    path, data, lambda d: _parse(d, parse, self.fmt))
            except CorruptCheckpointError as e:
                self._quarantine(step, str(e))
            except FileNotFoundError as e:
                # gone between discovery and read: quarantined by another
                # reader of the same directory
                self._quarantine(step, f"vanished mid-read: {e}")


def _parse(data: bytes, parse, fmt: str):
    if fmt == "jax":
        from .jax_checkpoint import decode

        state = decode(data)
    else:
        state = torch.load(io.BytesIO(data), map_location="cpu",
                           weights_only=True)
    if not isinstance(state, dict) or "step" not in state:
        raise ValueError(f"not a {fmt} checkpoint (no step)")
    return state if parse is None else parse(state)


def wire_checkpoint(args, logger, state, generators):
    """``(state, start_step, checkpoint_fn)`` of a run: with
    ``--checkpoint-dir`` a saver of ``state`` and the states of
    ``generators`` (the run's dropout generators), and under ``--resume``
    the newest valid checkpoint restored onto ``state``'s shapes and
    device, the generators set to its states before any call (a captured
    graph registers them at its first call). JAX ``_wire_checkpoint``'s
    refusals: checkpoints that were all found corrupt (quarantined), now or
    by an earlier attempt, exit; an empty directory is a fresh start."""
    if not args.checkpoint_dir:
        return state, 0, None
    from .loop import checkpoint_state, restore_state

    ckpt = Checkpointer(args.checkpoint_dir)
    start = 0
    if args.resume and ckpt.has_checkpoint():
        restored = ckpt.restore_latest(lambda saved: restore_state(state,
                                                                   saved))
        if restored is None:
            raise SystemExit(
                f"--resume: every checkpoint in {args.checkpoint_dir} failed "
                "verification (now quarantined); refusing to silently "
                "restart from step 0 — inspect the *.quarantined files")
        state, gen_states, start = restored
        if len(gen_states) != len(generators):
            raise SystemExit(f"--resume: the checkpoint holds "
                             f"{len(gen_states)} generator states, the run "
                             f"has {len(generators)} (other --dropout?)")
        for g, st in zip(generators, gen_states):
            g.set_state(st)
        logger.log({"note": f"resumed at step {state.step}"})
    elif args.resume and ckpt.has_quarantined():
        raise SystemExit(
            f"--resume: {args.checkpoint_dir} holds no valid checkpoint but "
            "contains *.quarantined files (an earlier attempt found them "
            "corrupt); refusing to silently restart from step 0 — inspect "
            "or clear the quarantined files first")

    def checkpoint_fn(st):
        return ckpt.save(checkpoint_state(st, generators))

    return state, start, checkpoint_fn
