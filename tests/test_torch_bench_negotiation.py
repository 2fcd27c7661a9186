"""The port's negotiation benchmark (``horovod_tpu_torch/tools/
bench_negotiation.py``) on the CPU, section by section, against the bars
of the reference's tests and, for the host wire codec, against the
reference tool itself (``tools/bench_negotiation.py``, loaded by file path
and run on the JAX package's launcher).

Every job runs through the port's ``runner.run`` with ``--device cpu``
and ``HOROVOD_SHM_DISABLE=1`` (an ``hvd_*`` region in ``/dev/shm`` would
outlive a killed job), at most 4 ranks and a few steps:

- the response cache (np 2, 30 tensors, 20 steps): cache_on announces
  under half of cache_off's bytes, under 40 B a tensor against over 60
  (``tests/parallel/test_negotiation_cache.py``'s bars), and an idle
  cycle's frame repeats no step snapshot;
- the np sweep at np 4 over 2 fake hosts: 3 coordinator messages a cycle
  flat, (2-1)+(2-1) = 2 through the tree (``docs/benchmarks.md``);
- the wire codec at np 2 over two fake hosts, 0.25 MiB: the error equal
  to the bit and the bytes ratios to three decimals to the reference
  tool's on the same arguments (the two cores are one C++ source).  At
  np 4 the two fake hosts hold two ranks each, whose hierarchical plane
  needs shared memory: without it both tools stay on the flat ring,
  whose same-host hops keep the codec cold (error 0, ratio 1.0);
- the device codec at np 4, int8 (auto: bidi) and int4 (ring): the
  baseline's raw bytes 0, the encoded-to-raw ratio the ring's analytic
  one, the error inside the ring's bound;
- the data planes at np 2 over ``aot_eager``: the gspmd leg's inventory
  of all-reduces carries ``w``'s fp32 bytes;
- the summaries' best-of, ratio and overhead arithmetic on fixed rows.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import quantize as qz
from horovod_tpu_torch.ops.device_plane import bucket_len
from horovod_tpu_torch.tools import bench_negotiation as bn

REPO = Path(__file__).resolve().parent.parent

NEG_NP, NEG_STEPS, NEG_TENSORS = 2, 20, 30
SWEEP_NP = 4
WIRE_NP, WIRE_STEPS = 2, 2
WIRE_ELEMS = int(0.25 * (1 << 20)) // 4     # above the 64 KiB codec floor
DEVICE_NP, DEVICE_STEPS = 4, 1
DEVICE_ELEMS = int(0.25 * (1 << 20)) // 4
PLANE_NP, PLANE_STEPS = 2, 2
PLANE_ELEMS = 4096

# The reference's line keys, per section (tools/bench_negotiation.py).
CONFIG_KEYS = {"config", "np", "steps_per_s", "tensor_ops_per_s",
               "worker_ctrl_bytes_per_step",
               "worker_announce_bytes_per_step"}
SUMMARY_KEYS = {"metric", "steps_ratio_cache_on_vs_off",
                "steps_ratio_cache_on_vs_fusion_off",
                "ctrl_bytes_ratio_on_vs_off",
                "announce_bytes_ratio_on_vs_off"}
SWEEP_KEYS = {"metric", "np", "hosts", "flat_msgs_per_cycle",
              "flat_bytes_per_cycle", "tree_msgs_per_cycle",
              "tree_bytes_per_cycle", "msgs_ratio"}
WIRE_KEYS = {"config", "np", "payload_bytes", "steps_per_s",
             "xhost_bytes_per_step", "raw_xhost_bytes_per_step",
             "max_abs_err"}
DEVICE_KEYS = {"steps_per_s", "max_abs_err", "device_raw_bytes_per_step",
               "device_encoded_bytes_per_step", "config", "payload_bytes"}
DEVICE_SUMMARY_KEYS = {"metric", "codec", "schedule",
                       "device_encoded_vs_raw_ratio", "max_abs_err",
                       "steps_ratio_vs_fp32"}
PLANE_KEYS = {"steps_per_s", "plane", "grad_bytes", "config"}
WHERE = {"device", "shared_card"}


@pytest.fixture(scope="module", autouse=True)
def shm_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_SHM_DISABLE", "1")
        yield


def _at_once(*calls):
    """Each ``(fn, *args)`` in a thread of its own (separate jobs,
    separate processes); their results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(*call) for call in calls]
        return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# The response cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def negotiation(shm_off):
    lines = []
    rows = {name: bn.run_config(name, env, NEG_NP, NEG_STEPS, NEG_TENSORS,
                                "cpu", lines)
            for name, env in (("cache_on", {}),
                              ("cache_off", {"HOROVOD_CACHE_CAPACITY": "0"}))}
    assert lines == list(rows.values())
    return rows


def test_negotiation_lines_carry_the_references_keys(negotiation):
    for name in ("cache_on", "cache_off"):
        row = negotiation[name]
        assert set(row) == CONFIG_KEYS | WHERE
        assert (row["np"], row["device"], row["shared_card"]) == \
            (NEG_NP, "cpu", False)


def _announce_per_tensor(negotiation, config):
    return (negotiation[config]["worker_announce_bytes_per_step"]
            / NEG_TENSORS)


def test_cache_halves_the_announce_bytes(negotiation):
    assert _announce_per_tensor(negotiation, "cache_on") < \
        0.5 * _announce_per_tensor(negotiation, "cache_off")


@pytest.mark.parametrize("config,bar", [("cache_on", 40), ("cache_off", 60)])
def test_announce_bytes_per_tensor(negotiation, config, bar):
    """The cached announce is the (id, handle) pair form; without the
    cache the full request metadata travels."""
    got = _announce_per_tensor(negotiation, config)
    assert (got < bar) if config == "cache_on" else (got > bar), got


def _idle_frames(device):
    import time

    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    x = torch.ones(64)
    for i in range(3):
        hvd.allreduce(x, name=f"idle.{i}", op=hvd.Sum)
    hvd.barrier()
    c0 = hvd.metrics()["counters"]
    time.sleep(0.3)
    c1 = hvd.metrics()["counters"]
    trace = hvd.step_trace()
    rank = hvd.rank()
    hvd.shutdown()
    return {"rank": rank,
            "bytes": c1["ctrl_bytes_sent"] - c0["ctrl_bytes_sent"],
            "frames": c1["ctrl_msgs_sent"] - c0["ctrl_msgs_sent"],
            "fleet": trace.get("fleet", [])}


def test_an_idle_cycle_repeats_no_step_snapshot(shm_off):
    """Each cycle a worker sends a frame; an idle one carries the metrics
    trailer (60 bytes after the three 4-byte counts) but not the last
    step's snapshot again (116 bytes more), which the coordinator keeps
    once per step and rank.  Every step still reaches the fleet view from
    every rank."""
    from horovod_tpu_torch.runner import run

    res = run(_idle_frames, args=("cpu",), np=2, stream_prefix=False,
              env={"HOROVOD_METRICS": "1", "HOROVOD_FLEET_TELEMETRY": "0"})
    worker = next(r for r in res if r["rank"] == 1)
    assert worker["frames"] > 20
    assert worker["bytes"] / worker["frames"] < 100, worker
    fleet = next(r for r in res if r["rank"] == 0)["fleet"]
    assert fleet and all(row["reported"] == 2 for row in fleet), fleet


# ---------------------------------------------------------------------------
# The control-plane sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep(shm_off):
    # The reference's 30 steps of 50 tensors: fewer, shorter steps let a
    # partial cycle at the edges move the per-cycle count by 0.1.
    lines = bn.main(["--device", "cpu", "--np-sweep", str(SWEEP_NP)])
    assert len(lines) == 1
    return lines[0]


def test_np_sweep_line_has_the_references_keys(sweep):
    # Two fake hosts grow no super layer: no depth-3 leg.
    assert set(sweep) == SWEEP_KEYS | WHERE
    assert (sweep["np"], sweep["hosts"]) == (SWEEP_NP, 2)


@pytest.mark.parametrize("mode,msgs", [("flat", SWEEP_NP - 1),
                                       ("tree", (2 - 1) + (2 - 1))])
def test_np_sweep_messages_are_the_topology_constants(sweep, mode, msgs):
    assert sweep[f"{mode}_msgs_per_cycle"] == pytest.approx(msgs, abs=0.05)
    assert sweep[f"{mode}_bytes_per_cycle"] > 0


# ---------------------------------------------------------------------------
# The host wire codec against the reference tool
# ---------------------------------------------------------------------------

def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_bench_negotiation", REPO / "tools" / "bench_negotiation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wire(shm_off):
    """Each codec's line from both tools, the two tools' jobs at once."""
    ref = _reference_tool()

    def port():
        return {codec: bn.run_wire_config(codec, WIRE_NP, WIRE_STEPS,
                                          WIRE_ELEMS, "cpu", [])
                for codec in ("none", "int8")}

    def theirs():
        return {codec: ref.run_wire_config(codec, WIRE_NP, WIRE_STEPS,
                                           WIRE_ELEMS)
                for codec in ("none", "int8")}

    return tuple(_at_once((port,), (theirs,)))


def test_wire_lines_carry_the_references_keys(wire):
    port, theirs = wire
    for codec in ("none", "int8"):
        assert set(theirs[codec]) == WIRE_KEYS
        assert set(port[codec]) == WIRE_KEYS | WHERE
        assert port[codec]["device"] == "cpu"


def test_wire_error_is_the_references_to_the_bit(wire):
    port, theirs = wire
    got, want = port["int8"]["max_abs_err"], theirs["int8"]["max_abs_err"]
    assert got > 0
    assert np.float64(got).tobytes() == np.float64(want).tobytes()
    assert port["none"]["max_abs_err"] == theirs["none"]["max_abs_err"] == 0


@pytest.mark.parametrize("key", ["xhost_bytes_ratio_vs_fp32",
                                 "wire_vs_raw_ratio"])
def test_wire_bytes_ratios_are_the_references(wire, key):
    port, theirs = wire
    ours = bn.wire_summary("int8", port["none"], port["int8"])
    ref = bn.wire_summary("int8", theirs["none"], theirs["int8"])
    assert ours[key] == ref[key]
    assert ours[key] < 0.3  # int8: a quarter of fp32 plus the scales


# ---------------------------------------------------------------------------
# The device plane's quantized ring
# ---------------------------------------------------------------------------

DEVICE_CASES = [("int8", None), ("int4", "ring")]


@pytest.fixture(scope="module")
def device(shm_off):
    lines = []
    base = bn.run_device_config("none", DEVICE_STEPS, DEVICE_ELEMS,
                                DEVICE_NP, "cpu", lines)
    comps = _at_once(*[(bn.run_device_config, codec, DEVICE_STEPS,
                        DEVICE_ELEMS, DEVICE_NP, "cpu", lines, schedule)
                       for codec, schedule in DEVICE_CASES])
    out = {}
    for (codec, schedule), comp in zip(DEVICE_CASES, comps):
        bound = bn.device_error_bound(codec, DEVICE_NP, DEVICE_ELEMS,
                                      schedule)
        out[codec] = (comp, bn.device_summary(codec, schedule, base, comp,
                                              bound))
    return base, out


def test_device_baseline_leaves_the_codec_cold(device):
    base, _ = device
    assert set(base) == DEVICE_KEYS | WHERE | {"np", "launches"}
    assert base["device_raw_bytes_per_step"] == 0
    assert base["device_encoded_bytes_per_step"] == 0
    # The uncompressed ring's sum of 4 fp32 rows: fp32 rounding only.
    assert base["max_abs_err"] < 1e-6


@pytest.mark.parametrize("codec,schedule", DEVICE_CASES)
def test_device_ratio_is_the_rings_analytic_one(device, codec, schedule):
    from horovod_tpu_torch.ops.collectives import resolve_device_schedule

    comp, summary = device[1][codec]
    assert set(summary) == DEVICE_SUMMARY_KEYS | {"max_abs_err_bound"}
    assert summary["schedule"] == (schedule or "auto")
    sched = resolve_device_schedule(DEVICE_NP, schedule or "auto")
    raw, enc = qz.ring_bytes(bucket_len(DEVICE_ELEMS // DEVICE_NP),
                             DEVICE_NP, codec, sched)
    assert (comp["device_raw_bytes_per_step"],
            comp["device_encoded_bytes_per_step"]) == (raw, enc)
    assert summary["device_encoded_vs_raw_ratio"] == round(enc / raw, 3) \
        == {"int8": 0.254, "int4": 0.129}[codec]
    # On the CPU the codec runs its plain versions: no kernel launch.
    assert all(set(r.values()) == {0} for r in comp["launches"])


@pytest.mark.parametrize("codec,schedule", DEVICE_CASES)
def test_device_error_is_inside_the_rings_bound(device, codec, schedule):
    comp, summary = device[1][codec]
    assert 0 < summary["max_abs_err"] <= summary["max_abs_err_bound"]
    assert summary["max_abs_err"] == comp["max_abs_err"]


def test_device_summary_refuses_a_baseline_that_touched_the_codec():
    base = {"device_raw_bytes_per_step": 8, "steps_per_s": 1.0}
    comp = {"device_raw_bytes_per_step": 8,
            "device_encoded_bytes_per_step": 2, "steps_per_s": 1.0,
            "max_abs_err": 0.0}
    with pytest.raises(RuntimeError, match="baseline"):
        bn.device_summary("int8", None, base, comp, 1.0)


def test_matrix_bound_is_the_rings_bound_over_the_world():
    """The matrix's qdev rows hold their average to the Sum's bound over
    the world; at world 4 on bidi their CPU run reads inside it."""
    bound = qz.ring_error_bound("int8", 4, 0.5, "bidi") / 4 + 1e-6 * 0.5
    assert 0.004161 < bound < 0.005
    torus = qz.ring_error_bound("int8", 16, 0.5, "torus")
    assert torus < qz.ring_error_bound("int8", 16, 0.5, "ring")


# ---------------------------------------------------------------------------
# The data planes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planes(shm_off):
    lines = []
    return tuple(_at_once(*[(bn.run_plane_config, plane, PLANE_STEPS,
                             PLANE_ELEMS, PLANE_NP, "cpu", lines)
                            for plane in ("eager", "gspmd")]))


def test_plane_lines_carry_the_references_keys(planes):
    eager, gspmd = planes
    assert set(eager) == PLANE_KEYS | WHERE | {"np"}
    assert set(gspmd) == PLANE_KEYS | WHERE | {"np", "hlo"}
    assert eager["grad_bytes"] == gspmd["grad_bytes"] == PLANE_ELEMS * 4


def test_gspmd_inventory_all_reduces_the_weights_bytes(planes):
    _, gspmd = planes
    hlo = gspmd["hlo"]
    assert set(hlo["kinds"]) == {"all-reduce"}
    assert hlo["collectives"] == hlo["kinds"]["all-reduce"] >= 1
    assert hlo["raw_bytes"] == PLANE_ELEMS * 4
    # The ring model at g = 2: 2 * raw * (g - 1) / g.
    assert hlo["wire_bytes"] == hlo["raw_bytes"]


def test_plane_summary_stamps_the_gspmd_inventory(planes):
    eager, gspmd = planes
    out = bn.plane_summary([eager], [gspmd])
    assert out["hlo"] == gspmd["hlo"]
    assert out["steps_ratio_gspmd_vs_eager"] == round(
        gspmd["steps_per_s"] / eager["steps_per_s"], 3)


# ---------------------------------------------------------------------------
# The summaries' arithmetic on fixed rows
# ---------------------------------------------------------------------------

def _rows(*rates):
    return [{"steps_per_s": r} for r in rates]


def test_overhead_takes_the_best_of_each_leg():
    out = bn.overhead("flight_recorder_overhead", _rows(90.0, 100.0, 95.0),
                      _rows(97.0, 99.0, 80.0))
    assert out == {"metric": "flight_recorder_overhead", "best_of": 3,
                   "steps_ratio_on_vs_off": 0.99, "overhead_pct": 1.0}


def test_overhead_of_a_faster_leg_is_zero():
    out = bn.overhead("metrics_overhead", _rows(100.0), _rows(104.0))
    assert out == {"metric": "metrics_overhead",
                   "steps_ratio_on_vs_off": 1.04, "overhead_pct": 0.0}


def test_step_trace_overhead_prices_the_metrics_leg():
    out = bn.overhead("step_trace_overhead", _rows(100.0, 110.0, 105.0),
                      _rows(108.0, 99.0, 100.0), _rows(88.0, 99.0, 101.0))
    assert out["steps_ratio_on_vs_off"] == round(108 / 110, 3)
    assert out["overhead_pct"] == round((1 - 108 / 110) * 100, 2)
    assert out["steps_ratio_with_metrics_vs_off"] == round(101 / 110, 3)


def test_cache_summary_ratios():
    on = {"steps_per_s": 100.0, "worker_ctrl_bytes_per_step": 600.0,
          "worker_announce_bytes_per_step": 150.0}
    off = {"steps_per_s": 50.0, "worker_ctrl_bytes_per_step": 1200.0,
           "worker_announce_bytes_per_step": 800.0}
    out = bn.cache_summary(on, off, {"steps_per_s": 8.0})
    assert set(out) == SUMMARY_KEYS
    assert out == {"metric": "negotiation_cache_speedup",
                   "steps_ratio_cache_on_vs_off": 2.0,
                   "steps_ratio_cache_on_vs_fusion_off": 12.5,
                   "ctrl_bytes_ratio_on_vs_off": 0.5,
                   "announce_bytes_ratio_on_vs_off": 0.188}


def test_plane_summary_best_of_three():
    out = bn.plane_summary(_rows(10.0, 12.0, 11.0),
                           [{"steps_per_s": 6.0}, {"steps_per_s": 8.0,
                                                   "hlo": {"x": 1}},
                            {"steps_per_s": 7.0}])
    assert out == {"metric": "data_plane", "best_of": 3,
                   "steps_ratio_gspmd_vs_eager": round(8 / 12, 3),
                   "step_time_ratio_gspmd_vs_eager": 1.5,
                   "hlo": {"x": 1}}


def test_wire_summary_ratios():
    base = {"xhost_bytes_per_step": 1000.0, "steps_per_s": 10.0}
    comp = {"xhost_bytes_per_step": 254.0,
            "raw_xhost_bytes_per_step": 1000.0, "steps_per_s": 9.0,
            "max_abs_err": 0.5}
    assert bn.wire_summary("int8", base, comp) == {
        "metric": "wire_compression", "codec": "int8",
        "xhost_bytes_ratio_vs_fp32": 0.254, "wire_vs_raw_ratio": 0.254,
        "max_abs_err": 0.5, "steps_ratio_vs_fp32": 0.9}


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("np_,cards,shared", [(1, 0, True), (4, 1, True),
                                              (2, 2, False), (4, 8, False)])
def test_jobs_of_more_ranks_than_cards_share_card_0(monkeypatch, np_, cards,
                                                    shared):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    env = bn.job_env("cuda", np_, {"X": "1"})
    assert bn.shares_card("cuda", np_) is shared
    assert ("HOROVOD_GPU_OPERATIONS" in env) is shared
    if shared:
        assert (env["HOROVOD_GPU_OPERATIONS"], env["HOROVOD_CUDA_DEVICE"]) \
            == ("GLOO", "0")
    assert bn.device_keys("cuda", np_) == {
        "device": "cuda:0" if shared else "cuda", "shared_card": shared}
    assert env["X"] == "1" and env["PYTHONPATH"].startswith(str(REPO))
    assert not bn.shares_card("cpu", np_)


def test_a_cuda_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        bn.main(["--np", "2"])
