"""The port stands alone: ``horovod_tpu_torch`` (``parallel``, the runner
with its autopilot and GPU discovery, ``elastic``, ``checkpoint``,
``callbacks``, ``data``, ``cockpit``, ``spark``, ``ray``, the compiler
data plane's ``ops.gspmd_plane`` and ``ops.hlo_inspect``, the ``tools``
and the benchmark tools included) and
``chip_smoke.py`` import neither jax nor the JAX package ``horovod_tpu``
(nor need pyspark, ray, pyarrow or cloudpickle), ``hvd.init()`` starts the
port's own native core and builds the global mesh, it runs on the card
unless the caller asks for the CPU, and its packaging names every
subpackage and ships the sources it builds."""

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
    # Any `import jax` now raises ImportError; so does every optional
    # package of the integrations (absent on the card machine too).
    for absent in ("jax", "pyspark", "ray", "pyarrow", "cloudpickle"):
        sys.modules[absent] = None

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
    assert hvd.parallel.global_mesh().axis("hvd").size == 1
    # The compiler data plane builds its mesh and resolves without jax.
    from horovod_tpu_torch.ops import gspmd_plane, hlo_inspect
    assert gspmd_plane.build_gspmd_mesh().size() == 1
    assert gspmd_plane.resolve_plane("gspmd") == ("eager", None)
    assert gspmd_plane.plane_counters() == {"demote_world1": 1}
    assert hlo_inspect.ring_wire_bytes("all-reduce", 8, 2) == 8
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
                   "examples.bert_pretraining", "examples.mnist_mlp",
                   "examples.gpt_long_context", "parallel",
                   "parallel.mesh", "parallel.collectives",
                   "parallel.ring_attention", "parallel.tensor_parallel",
                   "parallel.pipeline", "parallel.moe", "runner",
                   "runner.launch", "runner.elastic_driver",
                   "runner.run_api", "runner.driver_service",
                   "runner.js_run", "runner.util", "elastic",
                   "elastic.client", "elastic.state", "elastic.migrate",
                   "checkpoint", "examples.elastic_mnist", "callbacks",
                   "data", "cockpit", "runner.autopilot",
                   "runner.gpu_discovery", "runner._pickling", "spark",
                   "spark.store", "spark.data", "spark.estimator", "ray",
                   "examples.spark_estimator", "ops.gspmd_plane",
                   "ops.hlo_inspect", "examples.uneven_data_join",
                   "tools", "tools.test_matrix", "tools.hlo_report",
                   "examples.eager_device_plane", "examples.torch_mnist",
                   "examples.torch_elastic_mnist", "examples.microbenchmark",
                   "tools.bench_negotiation"):
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


def test_init_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics

    # A process whose first init() asks for no device (an earlier init of
    # this test process would have fixed the device for later bare ones).
    monkeypatch.setattr(basics, "_first_device", None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; init() would take it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.rank()


def test_packaging_names_every_subpackage_and_ships_the_sources():
    import glob
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    on_disk = sorted(
        ".".join(p.parent.relative_to(REPO).parts)
        for p in PKG.rglob("__init__.py") if PKG / "_build" not in p.parents)
    assert "horovod_tpu_torch.runner" in on_disk
    assert "horovod_tpu_torch.spark" in on_disk
    listed = [p for p in tool["packages"] if p.startswith("horovod_tpu_torch")]
    assert sorted(listed) == on_disk
    shipped = set()
    for pattern in tool["package-data"]["horovod_tpu_torch"]:
        shipped.update(glob.glob(str(PKG / pattern)))
    sources = {str(p) for p in (PKG / "csrc").rglob("*")
               if p.suffix in (".cu", ".cuh", ".cc", ".h")}
    assert any(s.endswith("core_api.cc") for s in sources)
    assert sources <= shipped
