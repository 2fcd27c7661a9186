"""The port's configuration matrix (``horovod_tpu_torch/tools/
test_matrix.py``), the counterpart of the JAX package's
``tools/test_matrix.py``: every row of its quick set, one case each, run
on the CPU (``--device cpu``) through the port's launcher.

Every row but the plane axis's own shm row runs with
``HOROVOD_SHM_DISABLE=1``: the JAX package's
``tests/integration/test_elastic.py`` counts ``hvd_*`` regions in
``/dev/shm`` while it runs, and the port's core names its regions alike.
The hierarchical rows then vote the shm handshake down and demote to the
flat ring, so their codec's engagement shows only in a run of the tool
itself.  A planted fault (an expected Sum off by one, or a quantized
ring that returns zeros) must make its row print FAIL with the detail
and ``main`` exit nonzero.
"""

import os

import pytest

from horovod_tpu_torch.tools import test_matrix as tm

QUICK = list(tm.combos(quick=True))
SHM_ROW = tm.row(np=3, plane="shm")
ROW_TIMEOUT_S = 120.0


def _row_id(r: dict) -> str:
    default = tm.row()
    return "-".join(f"{k}={v}" for k, v in r.items()
                    if k == "np" or v != default[k])


@pytest.fixture
def workload(tmp_path):
    path = tmp_path / "workload.py"
    path.write_text(tm.WORKLOAD)
    return str(path)


def test_quick_set_covers_every_axis_value_of_the_references():
    """Each axis value of the reference's quick set
    (``tools/test_matrix.py:565-620``) appears in a row; the reference's
    in-jit axes run on ranks."""
    seen = {name: {r[name] for r in QUICK} for name, _ in tm.AXES}
    assert seen["core"] == {"native", "purepy"}
    assert seen["plane"] == {"shm", "tcp", "tcp0", "hier"}
    assert seen["wire"] == {"none", "bf16", "int8"}
    assert seen["tree"] == {"auto", "on", "d3"}
    assert seen["qdev"] == {"off", "int8", "int4:bidi"}
    for axis, value in (("flight", "on"), ("autopilot", "on"),
                        ("migrate", "on"), ("trace", "on"),
                        ("fleet", "on"), ("dplane", "gspmd"),
                        ("hloinspect", "on"), ("fusion", "off"),
                        ("cache", "off")):
        assert value in seen[axis], axis
    for r in QUICK:
        if r["qdev"] != "off":
            assert r["np"] == tm.QDEV_NP
        if r["dplane"] != "off" or r["hloinspect"] != "def":
            assert r["np"] == tm.DPLANE_NP
    # A codec row on an all-local topology: the coordinator demotes it.
    assert any(r["wire"] != "none" and r["plane"] != "hier" for r in QUICK)
    assert len({tm.label(r) for r in QUICK}) == len(QUICK)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread a rank: the rows' ranks share the test run's
    cores with the other workers' jobs."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("r", QUICK, ids=_row_id)
def test_quick_row(r, workload, monkeypatch):
    if r == SHM_ROW:
        monkeypatch.delenv("HOROVOD_SHM_DISABLE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_SHM_DISABLE", "1")
    ok, _, detail, reports = tm.run_combo(r, workload, ROW_TIMEOUT_S,
                                          device="cpu")
    assert ok, detail
    assert [rep["rank"] for rep in reports] == list(range(r["np"]))
    for rep in reports:
        moved = rep["device_plane"]
        assert moved["host_fallback"] == 0
        if r["qdev"] not in ("off", "demote"):
            raw, enc = rep["qdev_bytes"]
            assert 0 < enc < raw


def test_fault_spec_check_row(monkeypatch):
    monkeypatch.setenv("HOROVOD_SHM_DISABLE", "1")
    (check,) = list(tm.checks(quick=True))
    name, cmds, cwd = check[:3]
    ok, _, detail = tm.run_check(cmds, cwd, ROW_TIMEOUT_S)
    assert name == "fault-spec" and ok, detail


# (row, a line of the workload, the line with the fault planted): an
# expected Sum off by one, and a quantized ring that returns zeros, whose
# error the ring's bound must refuse.
PLANTED = {
    "sum_off_by_one": (tm.row(np=1, cache="off"),
                       "total = s * (s + 1) / 2.0\n",
                       "total = s * (s + 1) / 2.0 + 1\n"),
    "qdev_zeros": (tm.row(np=tm.QDEV_NP, plane="tcp", qdev="int4:bidi"),
                   "name=\"m.qdev\").cpu().numpy()\n",
                   "name=\"m.qdev\").cpu().numpy() * 0\n"),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_a_planted_fault_fails_its_row(fault, monkeypatch, capsys):
    monkeypatch.setenv("HOROVOD_SHM_DISABLE", "1")
    target, right, wrong = PLANTED[fault]
    assert right in tm.WORKLOAD
    monkeypatch.setattr(tm, "WORKLOAD", tm.WORKLOAD.replace(right, wrong))
    monkeypatch.setattr(tm, "combos", lambda quick: iter([target]))
    monkeypatch.setattr(tm, "checks", lambda quick: iter([]))
    lab = tm.label(target)
    rc = tm.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 1
    assert f"FAIL  {lab}" in out.out
    assert "1 FAILED" in out.out and "ALL PASS" not in out.out
    assert f"--- {lab} ---" in out.err
    assert "Mismatched elements" in out.err or "AssertionError" in out.err


def test_the_full_set_refuses_without_a_checkout(tmp_path, monkeypatch,
                                                 capsys):
    """Installed without its checkout, the full set names the repo's files
    its check rows need and runs nothing."""
    assert tm.checkout_missing() == []
    monkeypatch.setattr(tm, "REPO", str(tmp_path))
    assert tm.checkout_missing() == list(tm.CHECKOUT_FILES)
    monkeypatch.setattr(tm, "run_check", None)
    monkeypatch.setattr(tm, "run_combo", None)
    assert tm.main(["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "tools/postmortem.py" in err and "--quick" in err


def test_row_owns_its_knobs(monkeypatch):
    """An ambient knob of an axis never reaches a row that leaves the axis
    at its default; ``--device cuda`` rows of more ranks than cards share
    the first card over gloo."""
    for knob in tm.OWNED_KNOBS:
        monkeypatch.setenv(knob, "1")
    env = tm.row_env(tm.row(np=3), "cpu")
    assert not set(tm.OWNED_KNOBS) & set(env)
    env = tm.row_env(tm.row(np=tm.QDEV_NP, qdev="int4:bidi"), "cuda")
    assert env["HOROVOD_GPU_OPERATIONS"] == "GLOO"
    assert env["HVD_MATRIX_DEVICE"] == "cuda:0"
    assert env["HOROVOD_WIRE_COMPRESSION"] == "device=int4"
    assert env["HOROVOD_DEVICE_SCHEDULE"] == "bidi"
    assert env["HOROVOD_WIRE_COMPRESSION_MIN_BYTES"] == str(tm.QDEV_FLOOR)
    env = tm.row_env(tm.row(np=tm.QDEV_NP), "cuda", cards=4)
    assert "HOROVOD_GPU_OPERATIONS" not in env
    assert env["HVD_MATRIX_DEVICE"] == "cuda"
    assert "HOROVOD_GPU_OPERATIONS" not in tm.row_env(tm.row(np=1), "cuda")
    assert [tm.label(r) for r in tm.card_rows()] == [
        tm.label(r) for r in QUICK
        if r == SHM_ROW or r == tm.row(np=1, cache="off")
        or r["qdev"] != "off" or r["dplane"] != "off"
        or r["hloinspect"] != "def"]
    assert os.path.isdir(tm.REPO)
