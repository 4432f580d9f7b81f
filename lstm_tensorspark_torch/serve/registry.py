"""Model registry: sha256-verified artifacts between training and serving.

Port of ``lstm_tensorspark_tpu/serve/registry.py``. ``cli distill``
publishes a draft LM here and ``serve --speculative`` loads it back as a
verified pair with its target (``train/distill.py``). Every artifact is
written by ``train/checkpoint.atomic_write`` (fsync'd, renamed into place)
with a ``.sha256`` sidecar that is checked on every read.

Layout — one flat directory, three files per artifact, the JAX package's
names and bytes, so one directory serves both packages:

- ``<model>__v<version>.msgpack``            payload bytes
- ``<model>__v<version>.msgpack.sha256``     integrity sidecar
- ``<model>__v<version>.json``               metadata record

The metadata record holds {model, version, kind, config_hash, parent,
sha256, payload_bytes}. ``config_hash`` is :func:`config_fingerprint` of
the model's config, the JAX package's hash: a config of the port hashes
the JAX ``LMConfig``'s field set, with JAX's defaults for the three fields
the port's lacks (``scan_unroll``, ``use_pallas``, ``bptt``).

The in-memory manifest is an index rebuilt from the directory on every
:meth:`ModelRegistry.scan`, so a publisher and a server (or two servers)
share a registry through the filesystem's atomic rename alone. A payload
that fails its checksum is quarantined (its three files renamed
``*.quarantined``) and drops out of the manifest: it is never served.

Payload kinds:

- ``"params"``     a params tree as ``flax.serialization.to_bytes`` writes
  it (the port writes it with ``train/jax_checkpoint.encode``);
- ``"best_state"`` the ``best.msgpack`` a JAX training run's Checkpointer
  wrote (msgpack of {step, value, state}); its ``state["params"]`` is
  served.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading

from ..convert import params_from_numpy, params_to_numpy
from ..models.lstm_lm import LMConfig
from ..train.checkpoint import CorruptCheckpointError, atomic_write, read_verified
from ..train.jax_checkpoint import decode, encode, params_tree
from ..train.loop import param_leaves


class RegistryError(RuntimeError):
    """Lookup failure: unknown model id or version, or an artifact that
    was quarantined out from under the request."""


# one naming authority for artifact files; the version is zero-padded so a
# plain directory listing sorts in version order
_ARTIFACT_PAT = re.compile(r"^(?P<model>[A-Za-z0-9._\-]+)__v(?P<ver>\d+)"
                           r"\.msgpack$")

#: the fields of the JAX package's ``LMConfig`` that the port's lacks (XLA
#: and Pallas knobs), at JAX's defaults: hashed with a port config so that
#: both packages fingerprint one model alike
JAX_ONLY_LM_FIELDS = {"scan_unroll": 1, "use_pallas": False,
                      "bptt": "sequential"}


def artifact_name(model_id: str, version: int) -> str:
    return f"{model_id}__v{version:06d}.msgpack"


def config_fingerprint(cfg) -> str:
    """Stable short hash of a model config (dataclass or mapping), the JAX
    package's: sha256 of the sorted-key JSON of its fields, 16 hex
    digits. A port ``LMConfig`` is hashed with :data:`JAX_ONLY_LM_FIELDS`
    added, so it gives the hash of the JAX config of the same model."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        payload = dataclasses.asdict(cfg)
        if isinstance(cfg, LMConfig):
            payload = {**JAX_ONLY_LM_FIELDS, **payload}
    elif isinstance(cfg, dict):
        payload = cfg
    else:
        payload = {"repr": repr(cfg)}
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def encode_params(params) -> bytes:
    """The port's LM params as a ``"params"`` payload: the bytes the JAX
    package's ``flax.serialization.to_bytes`` writes for the same values
    in JAX's pytree order (after ``jax.device_get``: maps by sorted key,
    each layer's gates in ``LSTMParams`` field order), so both packages
    publish one model under one sha256."""
    tree = params_to_numpy(params)
    return encode({"embedding": tree["embedding"],
                   "head": dict(sorted(tree["head"].items())),
                   "layers": tree["layers"]})


def _check_like(params, template) -> None:
    """Raise ``ValueError`` unless ``params`` has ``template``'s tensors:
    the same head (tied or not), layer count and shapes."""
    if sorted(params["head"]) != sorted(template["head"]) or \
            len(params["layers"]) != len(template["layers"]):
        raise ValueError(
            f"artifact has head {sorted(params['head'])} and "
            f"{len(params['layers'])} layers; the model has head "
            f"{sorted(template['head'])} and {len(template['layers'])}")
    for i, (a, b) in enumerate(zip(param_leaves(params),
                                   param_leaves(template))):
        if a.shape != b.shape:
            raise ValueError(f"artifact param {i} is {tuple(a.shape)}, the "
                             f"model's {tuple(b.shape)}")


class ModelRegistry:
    """sha256-verified model artifact store (module docstring).

    Thread-safe: the lock guards only the manifest index; payload IO runs
    outside it (the filesystem rename is the arbiter)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._manifest: dict[str, dict[int, dict]] = {}
        self.quarantined = 0  # artifacts set aside by this process
        self.scan()

    # ---- publishing -----------------------------------------------------

    def publish(self, model_id: str, payload: bytes, *,
                version: int | None = None, kind: str = "params",
                config_hash: str | None = None,
                parent: str | None = None) -> dict:
        """Write one artifact atomically and index it; ``version=None``
        takes the model's next version (max + 1, from 1). Returns the
        metadata record. The payload and its sidecar land before the
        record, so a crash between them leaves a valid payload that the
        next scan adopts, never a record without its bytes."""
        if not model_id or "__v" in model_id or "/" in model_id:
            raise ValueError(
                f"invalid model id {model_id!r} (must be non-empty, no "
                "'__v' or '/')")
        if kind not in ("params", "best_state"):
            raise ValueError(f"unknown artifact kind {kind!r}")
        with self._lock:
            if version is None:
                have = self._manifest.get(model_id, {})
                version = max(have, default=0) + 1
            version = int(version)
            if version < 1:
                raise ValueError(f"version must be >= 1, got {version}")
            if version in self._manifest.get(model_id, {}):
                raise ValueError(
                    f"{model_id} v{version} already published — versions "
                    "are immutable, publish a new one")
        path = os.path.join(self.directory, artifact_name(model_id, version))
        atomic_write(path, payload, checksum=True)
        meta = {
            "model": model_id,
            "version": version,
            "kind": kind,
            "config_hash": config_hash,
            "parent": parent,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "payload_bytes": len(payload),
        }
        atomic_write(self._meta_path(path),
                     json.dumps(meta, sort_keys=True).encode())
        with self._lock:
            self._manifest.setdefault(model_id, {})[version] = meta
        return dict(meta)

    # ---- index ----------------------------------------------------------

    def scan(self) -> dict[str, list[int]]:
        """Rebuild the manifest from the directory, verifying every payload
        against its sidecar and quarantining failures here, before anything
        can pick them. Returns {model_id: sorted versions}."""
        manifest: dict[str, dict[int, dict]] = {}
        quarantined = 0
        for fname in sorted(os.listdir(self.directory)):
            m = _ARTIFACT_PAT.match(fname)
            if m is None:
                continue
            path = os.path.join(self.directory, fname)
            try:
                payload = read_verified(path)
            except (CorruptCheckpointError, OSError) as e:
                print(f"registry: QUARANTINING {fname}: {e}", flush=True)
                self._quarantine(path)
                quarantined += 1
                continue
            meta = self._read_meta(path, m, payload)
            manifest.setdefault(meta["model"], {})[meta["version"]] = meta
        with self._lock:
            self._manifest = manifest
            self.quarantined += quarantined
            return {mid: sorted(v) for mid, v in manifest.items()}

    def _read_meta(self, path: str, m: re.Match, payload: bytes) -> dict:
        try:
            with open(self._meta_path(path)) as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            # publish stopped between payload and record: the payload is
            # verified, so adopt it with a minimal record
            return {
                "model": m.group("model"),
                "version": int(m.group("ver")),
                "kind": "params",
                "config_hash": None,
                "parent": None,
                "sha256": hashlib.sha256(payload).hexdigest(),
                "payload_bytes": len(payload),
            }

    def _meta_path(self, payload_path: str) -> str:
        return payload_path[:-len(".msgpack")] + ".json"

    def _quarantine(self, path: str) -> None:
        for p in (path, path + ".sha256", self._meta_path(path)):
            try:
                os.replace(p, p + ".quarantined")
            except OSError:
                pass  # best effort; the next scan retries what remains

    def models(self) -> dict[str, list[int]]:
        with self._lock:
            return {mid: sorted(vers)
                    for mid, vers in self._manifest.items()}

    def latest(self, model_id: str) -> dict | None:
        """The newest version's metadata record, or None."""
        with self._lock:
            vers = self._manifest.get(model_id)
            if not vers:
                return None
            return dict(vers[max(vers)])

    def meta(self, model_id: str, version: int | None = None) -> dict:
        with self._lock:
            vers = self._manifest.get(model_id)
            if not vers:
                raise RegistryError(
                    f"unknown model {model_id!r} (registry has "
                    f"{sorted(self._manifest) or 'no models'})")
            if version is None:
                version = max(vers)
            if version not in vers:
                raise RegistryError(
                    f"{model_id} has no version {version} "
                    f"(have {sorted(vers)})")
            return dict(vers[version])

    # ---- loading --------------------------------------------------------

    def load_bytes(self, model_id: str,
                   version: int | None = None) -> tuple[dict, bytes]:
        """Verified payload bytes and the metadata record. A checksum
        failure here (corruption after the indexing scan) quarantines the
        artifact, drops it from the manifest and raises
        :class:`RegistryError`."""
        meta = self.meta(model_id, version)
        path = os.path.join(self.directory,
                            artifact_name(meta["model"], meta["version"]))
        try:
            payload = read_verified(path)
        except (CorruptCheckpointError, OSError) as e:
            print(f"registry: QUARANTINING {os.path.basename(path)} at "
                  f"load: {e}", flush=True)
            self._quarantine(path)
            with self._lock:
                vers = self._manifest.get(meta["model"], {})
                vers.pop(meta["version"], None)
                if not vers:  # no versions left: drop the model
                    self._manifest.pop(meta["model"], None)
                self.quarantined += 1
            raise RegistryError(
                f"{meta['model']} v{meta['version']} failed verification "
                f"and was quarantined: {e}") from e
        return meta, payload

    def load_params(self, model_id: str, template,
                    version: int | None = None) -> tuple[dict, dict]:
        """``(meta, params)``: the artifact decoded into the port's LM
        params on the device of ``template`` (the model's params, whose
        head and shapes the artifact must have; ``ValueError`` otherwise).
        A ``"params"`` payload is the tree itself, a ``"best_state"`` one
        the ``params`` of its state."""
        meta, payload = self.load_bytes(model_id, version)
        if meta.get("kind") == "best_state":
            tree = params_tree(decode(decode(payload)["state"]))
        else:
            tree = params_tree({"params": decode(payload)})
        params = params_from_numpy(tree,
                                   device=template["embedding"].device)
        _check_like(params, template)
        return meta, params

    # ---- views ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "models": {mid: sorted(vers)
                           for mid, vers in self._manifest.items()},
                "artifacts": sum(len(v) for v in self._manifest.values()),
                "quarantined": self.quarantined,
            }
