"""The port's copy of the native negotiation core: its sources, its build
and its ctypes declarations.

``horovod_tpu_torch/csrc/core/`` is a byte-for-byte copy of the C++ library
sources of ``horovod_tpu/cpp/`` (the 13 ``SRCS`` of its Makefile and every
header they include).  The reference is frozen, so the copy is pinned to
it: a later change to the port's C++ changes this test and says why.
``DIVERGENCES`` holds those changes, each as the reference's text and the
port's; every other byte is the reference's.
"""

import ast
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
REF_DIR = REPO / "horovod_tpu" / "cpp"
CORE_DIR = REPO / "horovod_tpu_torch" / "csrc" / "core"


def _makefile_srcs():
    text = (REF_DIR / "Makefile").read_text()
    block = re.search(r"^SRCS = (.*?)\nOBJS", text, re.S | re.M).group(1)
    return sorted(block.replace("\\", " ").split())


def _included_headers(names):
    """Every header the sources include by quotes, transitively."""
    seen, todo = set(), list(names)
    while todo:
        text = (REF_DIR / todo.pop()).read_text()
        for h in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            if h not in seen:
                seen.add(h)
                todo.append(h)
    return sorted(seen)


SRCS = _makefile_srcs()
FILES = SRCS + _included_headers(SRCS)


# A worker's cycle frame carries each step snapshot once: the coordinator
# keeps the first report of a (step, rank) and drops repeats, and the
# reference's repeat on every idle cycle (116 bytes) outweighed the
# response cache's saving on a slow step (the negotiation benchmark's
# announce ratio on one card).
DIVERGENCES = {
    "socket_controller.cc": [(
        """  // sums), feeding the coordinator's fleet attribution.
  int64_t st_sid = 0;
  int64_t st_phases[kStepPhases];
  const bool has_step =
      StepTraceOn() && StepTraceLastCompleted(&st_sid, st_phases);
""",
        """  // sums), feeding the coordinator's fleet attribution.  Each snapshot
  // travels once: the coordinator keeps the first report of a (step,
  // rank) and drops repeats, so a cycle with no newer step sends the
  // 4-byte empty marker (metrics off) instead of repeating 116 bytes.
  int64_t st_sid = 0;
  int64_t st_phases[kStepPhases];
  const bool has_step = StepTraceOn() &&
                        StepTraceLastCompleted(&st_sid, st_phases) &&
                        st_sid != step_sent_;
  if (has_step) step_sent_ = st_sid;
""")],
    "socket_controller.h": [(
        """  double fleet_leader_last_encode_ = 0;
""",
        """  double fleet_leader_last_encode_ = 0;
  // Background thread: the step id of the last step snapshot this rank's
  // cycle frames carried (BuildCycleFrame sends each one once).
  int64_t step_sent_ = -1;
""")],
}


@pytest.mark.parametrize("name", FILES)
def test_core_copy_is_the_reference_source(name):
    want = (REF_DIR / name).read_bytes()
    for ref, port in DIVERGENCES.get(name, ()):
        assert want.count(ref.encode()) == 1, (name, ref)
        want = want.replace(ref.encode(), port.encode())
    assert (CORE_DIR / name).read_bytes() == want


def test_core_copy_holds_the_library_and_nothing_else():
    assert len(SRCS) == 13 and "wire_codec.h" in FILES
    assert sorted(p.name for p in CORE_DIR.iterdir()) == sorted(FILES)


def _c_signatures():
    """name -> parameter count of every ``hvd_*`` function defined in the
    copy's ``extern "C"`` block."""
    text = (CORE_DIR / "core_api.cc").read_text()
    block = text[text.index('extern "C" {'):]
    sigs = {}
    for m in re.finditer(r"^[a-z][\w ]*?\**\s*(hvd_\w+)\(([^)]*)\)\s*\{",
                         block, re.M):
        params = m.group(2).strip()
        sigs[m.group(1)] = 0 if params in ("", "void") else \
            params.count(",") + 1
    return sigs


def test_library_builds_loads_and_matches_its_declarations():
    """The library builds (or is reused) into horovod_tpu_torch/_build/,
    exports every function ``_declare`` names, and each declaration has
    the C function's arity: hvd_init's 31 arguments, hvd_enqueue's 17."""
    from horovod_tpu_torch import _core
    from horovod_tpu_torch.ops import _build

    lib = _core.load_library()
    assert Path(lib._name).parent == _build.BUILD_DIR
    assert Path(lib._name).name == \
        f"libhvd_core-{_build.core_digest()}.so"
    sigs = _c_signatures()
    assert sigs["hvd_init"] == 31 and sigs["hvd_enqueue"] == 17
    tree = ast.parse(Path(_core.__file__).read_text())
    declare = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name == "_declare")
    declared = set(re.findall(r"lib\.(hvd_\w+)\.", ast.unparse(declare)))
    assert declared == set(sigs), set(sigs) ^ declared
    for name in declared:
        fn = getattr(lib, name)  # exported by the built library
        if fn.argtypes is not None:
            assert len(fn.argtypes) == sigs[name], name
    assert len(lib.hvd_init.argtypes) == 31
    assert len(lib.hvd_enqueue.argtypes) == 17


_FAKE_CXX = textwrap.dedent("""\
    #!/bin/sh
    # A stand-in compiler: logs its call, takes a while, writes its output.
    out=""
    prev=""
    for a in "$@"; do
        [ "$prev" = "-o" ] && out="$a"
        prev="$a"
    done
    echo "$$ $out" >> "{log}"
    {fail}
    sleep 0.3
    echo built > "$out"
    """)

_BUILD = textwrap.dedent("""\
    import sys
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from horovod_tpu_torch.ops import _build
    print(_build.build_core(Path({core!r}), Path({out!r}), {cxx!r}))
    """)


def _fake_tree(tmp_path, fail=""):
    core = tmp_path / "core"
    core.mkdir()
    for name in ("a.cc", "b.cc", "c.cc"):
        (core / name).write_text(f"// {name}\n")
    (core / "a.h").write_text("// header\n")
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(_FAKE_CXX.format(log=log, fail=fail))
    cxx.chmod(0o755)
    script = _BUILD.format(repo=str(REPO), core=str(core),
                           out=str(tmp_path / "build"), cxx=str(cxx))
    return script, log


def test_build_lock_builds_once_for_two_processes(tmp_path):
    """Two processes that need the library at once: one compiles every
    source and links once, under the lock; the other waits and reuses the
    result.  Neither leaves its work directory behind."""
    script, log = _fake_tree(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = Path(paths.pop())
    assert built.read_text() == "built\n"
    calls = log.read_text().splitlines()
    assert len(calls) == 3 + 1, calls  # three compiles, one link
    assert len({c.split()[0] for c in calls}) == 4
    left = sorted(p.name for p in built.parent.iterdir())
    assert left == sorted(["core.lock", built.name])


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    script, _ = _fake_tree(
        tmp_path, fail='echo "error: no such thing" >&2; exit 1')
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "native core build failed" in proc.stderr
    assert "error: no such thing" in proc.stderr


@pytest.mark.parametrize("controller", ["auto", "python"])
def test_native_core_unless_the_python_one_is_asked_for(monkeypatch,
                                                        controller):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext

    monkeypatch.setenv("HOROVOD_CONTROLLER", controller)
    own = hvd.ProcessSet([0])
    hvd.init(device="cpu", process_sets=[own])
    try:
        core = HorovodContext.instance().core
        assert core.name == ("pylocal" if controller == "python"
                             else "native")
        assert hvd.native_core_built() and hvd.gloo_built()
        assert own.process_set_id == 1 and own.size() == 1
        assert hvd.allgather_object(7) == [7]
        out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="ones",
                            process_set=own)
        assert out.tolist() == [1.0, 1.0, 1.0]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("hosts,mode,fanout,depth", [
    (["a"] * 4 + ["b"] * 4, "auto", 32, 0),
    ([f"h{r // 2}" for r in range(40)], "auto", 4, 0),
    ([f"h{r % 5}" for r in range(20)], "on", 32, 3),
    ({0: "a", 2: "a", 5: "b", 7: "c"}, "on", 2, 0),
    (["a"] * 6, "on", 32, 0),
    (["a", "b"] * 3, "off", 32, 0),
])
def test_ctrl_tree_matches_reference(hosts, mode, fanout, depth):
    from horovod_tpu.runtime import compute_ctrl_tree as reference

    from horovod_tpu_torch.runtime import PROTOCOL_VERSION, compute_ctrl_tree

    assert PROTOCOL_VERSION == 12
    assert compute_ctrl_tree(hosts, mode, fanout, depth) == \
        reference(hosts, mode, fanout, depth)
