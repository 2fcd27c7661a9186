"""The port's copies of the reference's eager and torch-binding examples
(``horovod_tpu_torch/examples/{eager_device_plane,torch_mnist,
torch_elastic_mnist}.py``) and the torch binding's API they stand on.

- ``eager_device_plane`` at world 1 on the CPU ends within ``EAGER_TOL``
  of ``examples/jax_eager_device_plane.py``'s final parameters, from the
  reference's initial ``MLP`` parameters (carried across by
  ``models/convert.py:from_jax``), the reference run single-process;
- ``torch_mnist`` and ``torch_elastic_mnist`` run at np=2 through the
  port's launcher with ``--device cpu``;
- every public name of ``horovod_tpu.torch`` and
  ``horovod_tpu.torch.elastic`` exists in the port, with the same call
  signature where both are functions (the reference's parameters, in its
  order and kinds, with its defaults; the port may add parameters after
  them), and the two gaps this found are pinned: ``hvd.init`` takes the
  reference's ``comm``, ``config`` and ``build_mesh``, and ``allreduce``
  takes ``compression=None``.

Each example runs in a process of its own.
"""

import inspect
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# Ten SGD steps of the MLP in fp32 from the same parameters and data: the
# two frameworks' matmul and softmax reduction orders differ by a few ulps
# a step (1.5e-8 at most on a CPU, against updates of 1.6e-3 to 1.2e-2).
EAGER_TOL = 1e-6
ENV = {"HOROVOD_SHM_DISABLE": "1", "OMP_NUM_THREADS": "1"}


def _run(argv, timeout=240, **env):
    full = dict(os.environ, **ENV, **env)
    full["PYTHONPATH"] = str(REPO) + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=full)


_REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax
    src = open(sys.argv[1]).read()
    hook = "params = hvd.broadcast_parameters(params, root_rank=0)\\n"
    assert src.count(hook) == 1
    src = src.replace(hook, hook + "    INIT.append(jax.device_get(params))\\n")
    end = "    stats = HorovodContext.instance().device_plane.stats\\n"
    assert src.count(end) == 1
    src = src.replace(end, "    FINAL.append(jax.device_get(params))\\n" + end)
    scope = {"__name__": "__main__", "INIT": [], "FINAL": []}
    exec(compile(src, sys.argv[1], "exec"), scope)
    with open(sys.argv[2], "wb") as f:
        pickle.dump({"init": scope["INIT"][0], "final": scope["FINAL"][0]}, f)
""")

_PORT = textwrap.dedent("""
    import pickle, sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.examples import eager_device_plane as ex
    from horovod_tpu_torch.models.convert import from_jax
    with open(sys.argv[1], "rb") as f:
        ref = pickle.load(f)
    hvd.init(device="cpu")
    model = ex.train(state=from_jax(ref["init"]))
    stats = dict(HorovodContext.instance().device_plane.stats)
    hvd.shutdown()
    with open(sys.argv[2], "wb") as f:
        pickle.dump({"final": {k: v.numpy() for k, v in
                               model.state_dict().items()},
                     "stats": stats}, f)
""")


def test_eager_device_plane_matches_the_reference(tmp_path):
    from horovod_tpu_torch.models.convert import from_jax

    ref_out, port_out = tmp_path / "ref.pkl", tmp_path / "port.pkl"
    ref = _run([sys.executable, "-c", _REFERENCE,
                str(REPO / "examples" / "jax_eager_device_plane.py"),
                str(ref_out)], JAX_PLATFORMS="cpu")
    assert ref.returncode == 0, ref.stderr[-2000:]
    port = _run([sys.executable, "-c", _PORT, str(ref_out), str(port_out)])
    assert port.returncode == 0, port.stderr[-2000:]
    with open(ref_out, "rb") as f:
        want = {k: v.numpy() for k, v in
                from_jax(pickle.load(f)["final"]).items()}
    with open(port_out, "rb") as f:
        got = pickle.load(f)
    assert sorted(got["final"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["final"][name], w, rtol=0,
                                   atol=EAGER_TOL, err_msg=name)
    # The gradients rode the device plane: one fused identity per step.
    assert got["stats"]["identity"] > 0
    assert got["stats"]["host_fallback"] == 0


def test_eager_device_plane_main_on_the_cpu():
    out = _run([sys.executable, "-m",
                "horovod_tpu_torch.examples.eager_device_plane",
                "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "device plane stats" in out.stdout
    assert "rank 0/1 done" in out.stdout


@pytest.mark.parametrize("example, launch, lines", [
    ("torch_mnist", [], ["epoch 0: avg loss", "epoch 1: avg loss"]),
    ("torch_elastic_mnist", ["--min-np", "1", "-H", "localhost:2"],
     ["epoch 0: loss", "epoch 2: loss", "(world size 2)"]),
])
def test_torch_examples_at_np2_on_the_cpu(example, launch, lines):
    out = _run([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                "-np", "2", *launch, sys.executable, "-m",
                f"horovod_tpu_torch.examples.{example}", "--device", "cpu"])
    assert out.returncode == 0, (out.stdout + out.stderr)[-2000:]
    for line in lines:
        assert line in out.stdout, out.stdout[-2000:]


def _reference_modules():
    import horovod_tpu.torch as ref
    import horovod_tpu.torch.elastic as ref_elastic

    import horovod_tpu_torch as port
    import horovod_tpu_torch.elastic as port_elastic

    return ((ref, port), (ref_elastic, port_elastic))


def _public(mod):
    """The module's public API: the classes and functions of the
    reference's own packages it holds (not typing, not modules)."""
    out = {}
    for name in dir(mod):
        obj = getattr(mod, name)
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if (getattr(obj, "__module__", "") or "").startswith("horovod_tpu"):
            out[name] = obj
        elif not callable(obj) and not hasattr(obj, "__module__"):
            out[name] = obj
    return out


def _default(value):
    if value is inspect.Parameter.empty:
        return value
    return getattr(value, "__name__", None) or getattr(value, "name",
                                                       None) or repr(value)


def _matches(ref_fn, port_fn) -> str:
    """'' when ``port_fn`` takes ``ref_fn``'s calls, else what differs."""
    want = [p for p in inspect.signature(ref_fn).parameters.values()
            if not p.name.startswith("_")]
    got = list(inspect.signature(port_fn).parameters.values())
    for i, p in enumerate(want):
        if i >= len(got) or got[i].name != p.name:
            return f"parameter {i} {p.name}"
        if got[i].kind != p.kind or _default(got[i].default) != \
                _default(p.default):
            return f"{p.name}: {got[i]} against {p}"
    extra = [p for p in got[len(want):]
             if p.default is inspect.Parameter.empty
             and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return f"required extras {extra}" if extra else ""


def test_every_public_name_of_the_torch_binding_exists_in_the_port():
    for ref, port in _reference_modules():
        names = _public(ref)
        assert len(names) >= (40 if ref.__name__ == "horovod_tpu.torch"
                              else 6)
        for name, obj in names.items():
            assert hasattr(port, name), f"{port.__name__}.{name}"
            mine = getattr(port, name)
            if inspect.isfunction(obj) and inspect.isfunction(mine):
                assert _matches(obj, mine) == "", \
                    f"{port.__name__}.{name}: {_matches(obj, mine)}"


_PINS = textwrap.dedent("""
    import json
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.env import Config
    out = {}
    try:
        hvd.init(comm=object(), device="cpu")
    except ValueError as exc:
        out["comm"] = str(exc)
    hvd.init(comm=[0], config=Config.from_env(), build_mesh=False,
             device="cpu")
    out["mesh"] = hvd.parallel.global_mesh() is None
    out["sum"] = hvd.allreduce(torch.ones(3), op=hvd.Sum, compression=None,
                               name="pin").tolist()
    hvd.shutdown()
    hvd.init(device="cpu")
    out["mesh_default"] = hvd.parallel.global_mesh() is not None
    hvd.shutdown()
    print(json.dumps(out))
""")


def test_init_and_allreduce_take_the_references_arguments():
    """Pins of the two gaps: on the parent, ``hvd.init(build_mesh=False)``
    (the reference's torch examples' first line) raised TypeError and
    ``hvd.allreduce(t, compression=None)`` raised AttributeError."""
    out = _run([sys.executable, "-c", _PINS])
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert "list of ranks" in res["comm"]
    assert res == {"comm": res["comm"], "mesh": True, "sum": [1.0] * 3,
                   "mesh_default": True}
