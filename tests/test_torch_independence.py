"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``lstm_tensorspark_torch`` and
checks that no ``jax``/``flax``/``optax``/``lstm_tensorspark_tpu`` module
was loaded; an AST scan of the package's sources finds no such import
either (including imports inside functions, which the first check would
not execute).
"""

import ast
import json
import pathlib
import subprocess
import sys

import lstm_tensorspark_torch

PKG = pathlib.Path(lstm_tensorspark_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lstm_tensorspark_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import lstm_tensorspark_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in %r)}))
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE % (FORBIDDEN,)], capture_output=True,
        text=True, timeout=120, cwd=str(PKG.parent), check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    for mod in ("serve.engine", "serve.server", "ops.cuda_decode", "cli",
                "convert", "kernels", "ops.cuda_lstm", "ops.scan",
                "ops.embedding", "models.lstm_lm", "data.corpus",
                "data.datasets", "data.batching", "train.optimizer",
                "train.loop", "train.metrics", "exit_codes",
                "ops.cuda_lstmx", "ops.cuda_bilstm", "ops.masking",
                "models.classifier", "tasks.classification", "ops.cuda_spec",
                "train.distill"):
        assert f"lstm_tensorspark_torch.{mod}" in report["modules"]


def test_no_source_file_imports_jax():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(PKG)}: {n}")
    assert offenders == []
