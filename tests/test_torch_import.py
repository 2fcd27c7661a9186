"""The port stands alone: ``horovod_tpu_torch`` and ``chip_smoke.py`` import
neither jax nor the JAX package ``horovod_tpu``, ``hvd.init()`` starts the
port's own native core, and it runs on the card unless the caller asks for
the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "horovod_tpu_torch"

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError

    class Refuse:
        # Refuses horovod_tpu and horovod_tpu.*, not horovod_tpu_torch.
        def find_spec(self, name, path=None, target=None):
            if name == "horovod_tpu" or name.startswith("horovod_tpu."):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, REPO_DIR)
    import horovod_tpu_torch
    names = ["horovod_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                              "horovod_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    hvd.init(device="cpu")
    core = HorovodContext.instance().core
    import torch
    total = hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist()
    print(core.name, core._lib._name, total)
    hvd.shutdown()
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and (m == "horovod_tpu" or m.startswith("horovod_tpu.")
                         or m.split(".")[0] in ("jax", "flax", "optax")))
    print(len(names), leaked, names)
""")


def test_imports_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c",
         _BLOCKED_IMPORT.replace("REPO_DIR", repr(str(REPO)))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    started, listed = out.stdout.splitlines()[-2:]
    core, lib, total = started.split(" ", 2)
    assert core == "native" and total == "[1.0, 1.0]"
    assert Path(lib).parent == PKG / "_build"
    assert Path(lib).name.startswith("libhvd_core-")
    count, leaked, names = listed.split(" ", 2)
    assert int(count) >= 17  # every module of the package was imported
    assert leaked == "[]"
    for module in ("ops.quantize", "ops.collectives", "optimizer",
                   "utils.env", "utils.metrics", "sync_batch_norm",
                   "models.resnet", "models.vgg", "models.inception",
                   "models.bert", "models.mlp", "models.convert",
                   "examples.cnn_benchmark",
                   "examples.bert_pretraining", "examples.mnist_mlp"):
        assert f"'horovod_tpu_torch.{module}'" in names


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# The package's sources; _build/ holds what chip_smoke.py builds (and may
# hold an unpacked copy of the repo).
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if PKG / "_build" not in p.parents)


@pytest.mark.parametrize("path", SOURCES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_names_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "flax", "optax", "horovod_tpu"), \
            f"{path.name} imports {name}"


def test_init_needs_a_card_unless_cpu_is_asked_for():
    import horovod_tpu_torch as hvd

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; init() would take it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.rank()
