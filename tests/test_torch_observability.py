"""The port's observability API against the JAX package's, on the CPU.

Two ranks of the port and two ranks of the reference run the same named
eager collectives at once (``tests/test_torch_spine.py``'s harness: spawned
workers, each pair with its own native core, never two cores in one
process), with the metrics registry, the timeline, the flight recorder and
the step trace on.  Both cores are one C++ source, so what they record must
agree wherever it does not depend on timing:

- ``metrics()``: its keys, and the counters of responses, fused tensors
  and bytes, stalls and aborts, exactly;
- the timeline: the multiset of (event name, phase) over the named ops;
- the flight recorder: the event-type legend, and the number of its
  events of each type that comes one per collective or ring hop
  (rendezvous, verdict, ring_hop, abort, fault_trip);
- the step trace: its schema, phases, row width and steps closed.

Beside them, with no worker: ``Config.from_env`` field by field against the
reference's (the flight recorder and the step trace are on by default
there), ``render_prometheus`` byte for byte against the reference's on the
dump shapes of ``tests/single/test_metrics_prom.py``, the fault-spec
verdicts of ``tests/single/test_fault_spec.py`` (asked of the port's core in
a worker), the build queries, ``num_devices``, ``start_device_trace`` and
``set_backward_passes_per_step``.  Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_spine import _build_cores, _env, _phase_port

WORLD = 2
JOIN_TIMEOUT_S = 120
ELASTIC_GENERATION = 3


def _named_ops(hvd, rank):
    """The same named collectives for both packages, each waited for before
    the next, on numpy arrays (the core's host ring in both)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((WORLD, 6, 4)).astype(np.float32)[rank]
    out = {
        "ar": hvd.allreduce(x, op=hvd.Sum, name="obs.ar"),
        "ar_avg": hvd.allreduce(x, name="obs.ar_avg"),
        # Equal rows on both ranks: the core counts a response's bytes from
        # the first request it saw, which for a ragged gather is a race.
        "ag": hvd.allgather(x[:2], name="obs.ag"),
        "bc": hvd.broadcast(x, root_rank=1, name="obs.bc"),
        "a2a": hvd.alltoall(x, name="obs.a2a"),
        "rs": hvd.reducescatter(x, op=hvd.Sum, name="obs.rs"),
    }
    hvd.barrier()
    return {k: np.asarray(v[0] if isinstance(v, tuple) else v)
            for k, v in out.items()}


def _observe(hvd, outdir, pkg, rank):
    """Run the named ops under a timeline and read every plane."""
    path = os.path.join(outdir, f"{pkg}{rank}.timeline.json")
    hvd.start_timeline(path)
    res = {"ops": _named_ops(hvd, rank)}
    hvd.stop_timeline()
    res["metrics"] = hvd.metrics()
    res["prometheus"] = hvd.metrics_prometheus()
    res["flight"] = hvd.flight_record()
    res["steps"] = hvd.step_trace()
    res["fleet"] = hvd.fleet_history()
    with open(path) as f:
        res["timeline"] = json.load(f)
    res["object"] = hvd.broadcast_object_fn(root_rank=1, name="obs.obj")(
        {"rank": rank, "epoch": 7})
    return res


FAULT_SPECS_VALID = [
    "",
    "ring-send:*:*:drop",
    "ring-recv:0:2:truncate",
    "shm-fence:*:1:drop",
    "frame-header:3:0:corrupt-tag",
    "coordinator-recv:0:1:drop",
    "rendezvous-accept:0:1:drop",
    "ring-send:*:1:delay:250",
    "ring-send:7:1:die",
    "ring-send:7:1:die:/tmp/latch.flag",
    "ring-send:7:1:die:/tmp/with:colon.flag",
    "ring-send:*:1:delay:250,frame-header:3:0:corrupt-tag,,",
]
FAULT_SPECS_MALFORMED = [
    ("nosite:*:*:drop",
     ["unknown site", "valid sites", "ring-send", "shm-fence"]),
    ("ring-send:*:*", ["expected site:cycle:rank:action"]),
    ("ring-send:x:*:drop", ["cycle 'x'", "non-negative"]),
    ("ring-send:*:x:drop", ["rank 'x'", "non-negative"]),
    ("ring-send:*:*:explode",
     ["unknown action 'explode'", "valid actions", "corrupt-tag"]),
    ("ring-send:*:*:delay", ["delay requires a numeric millisecond arg"]),
    ("ring-send:*:*:drop:arg", ["takes no arg"]),
    ("ring-send:*:1:delay:250,nosite:*:*:drop", ["unknown site"]),
]


def _port_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "port"), HOROVOD_METRICS="1",
         HOROVOD_ELASTIC_GENERATION=str(ELASTIC_GENERATION))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _core
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.ops import quantize as qz

    hvd.init(device="cpu")
    res = _observe(hvd, outdir, "port", rank)
    res["stats"] = dict(HorovodContext.instance().stats)
    # The device plane's quantized bytes reach the native registry.
    qz.reset_device_byte_counters()
    hvd.quantized_allreduce(torch.ones(20000), codec="int8")
    res["device_bytes"] = qz.device_byte_counters()
    res["device_metrics"] = hvd.metrics()["counters"]
    res["fault_specs"] = {
        spec: _core.check_fault_spec(spec) for spec in
        FAULT_SPECS_VALID + [s for s, _ in FAULT_SPECS_MALFORMED]}
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"port{rank}.pt"))


def _reference_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "reference"), JAX_PLATFORMS="cpu",
         HOROVOD_METRICS="1",
         HOROVOD_ELASTIC_GENERATION=str(ELASTIC_GENERATION))
    import horovod_tpu as hvd

    hvd.init(build_mesh=False)
    res = _observe(hvd, outdir, "reference", rank)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"reference{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("observability")
    _build_cores()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_port_worker, args=(r, str(outdir)))
             for r in range(WORLD)]
    procs += [ctx.Process(target=_reference_worker, args=(r, str(outdir)))
              for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"{len(alive)} worker(s) did not finish in " \
                      f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return {pkg: [torch.load(outdir / f"{pkg}{r}.pt", weights_only=False)
                  for r in range(WORLD)]
            for pkg in ("port", "reference")}


def _counts(flight, types):
    """Events of each of ``types`` in a flight record."""
    legend = {v: int(k) for k, v in flight["types"].items()}
    rows = [row[2] for row in flight["events"]]
    return {t: rows.count(legend[t]) for t in types}


# Counters that follow from the named ops alone (cycles, control frames and
# fleet sketches follow from timing).
DETERMINISTIC_COUNTERS = (
    "responses_total", "tensors_fused_total", "bytes_fused_total",
    "stall_warnings_total", "aborts_total", "faults_injected_total",
    "device_raw_bytes", "device_encoded_bytes", "migrate_events_total")
# Flight-recorder events one per collective or per ring hop, not per cycle.
DETERMINISTIC_FLIGHT = ("rendezvous", "verdict", "ring_hop", "abort",
                        "fault_trip")


@pytest.mark.parametrize("rank", range(WORLD))
def test_metrics_keys_and_counters_match_reference(runs, rank):
    port = runs["port"][rank]["metrics"]
    ref = runs["reference"][rank]["metrics"]
    assert sorted(port) == sorted(ref)
    assert sorted(port["counters"]) == sorted(ref["counters"])
    assert sorted(port["histograms"]) == sorted(ref["histograms"])
    for name in DETERMINISTIC_COUNTERS:
        assert port["counters"][name] == ref["counters"][name], name
    assert port["counters"]["responses_total"] == 7  # six ops and a barrier
    assert port["gauges"] == {**ref["gauges"],
                              "goodput_ratio_ppm":
                                  port["gauges"]["goodput_ratio_ppm"]}


def test_elastic_generation_gauge_is_published(runs):
    for pkg in ("port", "reference"):
        for r in runs[pkg]:
            assert r["metrics"]["gauges"]["elastic_generation"] == \
                ELASTIC_GENERATION, pkg


def test_metrics_count_what_the_context_negotiated(runs):
    """The core's response and tensor counters against the executor's own
    count of what it popped (``HorovodContext.stats``); the quantized
    allreduce in between runs on the caller's group and adds to neither."""
    port = runs["port"][0]
    assert port["stats"] == {
        "responses": port["device_metrics"]["responses_total"],
        "tensors": port["device_metrics"]["tensors_fused_total"]}


def test_native_metrics_carry_device_plane_bytes(runs):
    """The quantized collectives' wire bytes reach the native registry, as
    the reference routes them (``set_native_byte_sink``)."""
    for r in runs["port"]:
        raw, encoded = r["device_bytes"]
        assert raw > encoded > 0
        assert r["device_metrics"]["device_raw_bytes"] == raw
        assert r["device_metrics"]["device_encoded_bytes"] == encoded


@pytest.mark.parametrize("rank", range(WORLD))
def test_timeline_events_match_reference(runs, rank):
    def events(res):
        return sorted((e.get("name"), e.get("ph")) for e in res["timeline"])

    port = events(runs["port"][rank])
    assert port == events(runs["reference"][rank])
    names = {e["args"]["tensor"] for e in runs["port"][rank]["timeline"]
             if e.get("ph") == "B" and e.get("name") == "NEGOTIATE"}
    assert {"obs.ar", "obs.ar_avg", "obs.ag", "obs.bc", "obs.a2a",
            "obs.rs"} <= names


@pytest.mark.parametrize("rank", range(WORLD))
def test_flight_record_matches_reference(runs, rank):
    port = runs["port"][rank]["flight"]
    ref = runs["reference"][rank]["flight"]
    assert sorted(port) == sorted(ref)
    assert port["types"] == ref["types"]
    assert port["events"] and port["dropped"] == ref["dropped"] == 0
    assert _counts(port, DETERMINISTIC_FLIGHT) == \
        _counts(ref, DETERMINISTIC_FLIGHT)


@pytest.mark.parametrize("rank", range(WORLD))
def test_step_trace_matches_reference(runs, rank):
    port = runs["port"][rank]["steps"]
    ref = runs["reference"][rank]["steps"]
    assert sorted(port) == sorted(ref)
    for key in ("schema", "rank", "world", "slots", "phases", "completed"):
        assert port[key] == ref[key], key
    assert port["phases"] == ["negotiation_wait", "fusion", "ring", "fence",
                              "idle"]
    # One row per step the core closed (a cycle that shipped work), each
    # [step, start_us, end_us, <5 phase us>, plane]; the port tags the eager
    # plane (0), the reference's eager ranks leave it unknown (-1).
    assert [row[0] for row in port["steps"]] == list(range(port["completed"]))
    assert {len(row) for row in port["steps"]} == \
        {len(row) for row in ref["steps"]} == {9}
    assert {row[-1] for row in port["steps"]} == {0}
    assert sorted(runs["port"][rank]["fleet"]) == \
        sorted(runs["reference"][rank]["fleet"])


def test_named_ops_and_object_broadcast_match_reference(runs):
    for rank in range(WORLD):
        port, ref = runs["port"][rank], runs["reference"][rank]
        assert port["object"] == ref["object"] == {"rank": 1, "epoch": 7}
        for key, want in ref["ops"].items():
            assert np.array_equal(port["ops"][key], want), key


# -- Prometheus -----------------------------------------------------------

_HISTOGRAM = {"buckets": [1, 2, 0, 4], "sum_us": 99, "count": 7}
_TENANTS = {"a": {"responses": 1, "tensors": 2, "bytes": 3,
                  "negotiation_wait_us": {"buckets": [1, 1], "sum_us": 4,
                                          "count": 2}},
            "b": {"responses": 9, "tensors": 9, "bytes": 9,
                  "negotiation_wait_us": {"buckets": [2, 0], "sum_us": 1,
                                          "count": 2}}}
_FLEET = {
    "negotiation_wait_us": {"buckets": [4, 4], "sum_us": 40, "count": 8},
    "ring_hop_us": {"buckets": [1, 0], "sum_us": 1, "count": 1},
    "step_time_us": {"buckets": [0, 3], "sum_us": 90, "count": 3},
    "shm_fence_us": {"buckets": [], "sum_us": 0, "count": 0},
    "tenants": {"a": {"buckets": [2, 2], "sum_us": 20, "count": 4}},
}
# The dump shapes of tests/single/test_metrics_prom.py.
PROM_DUMPS = {
    "empty": {},
    "disabled": None,
    "shapes": {"rank": 2, "counters": {"steps_total": 5,
                                       "bytes_reduced": 7},
               "gauges": {"elastic_generation": 3},
               "histograms": {"negotiation_us": _HISTOGRAM}},
    "hostile_labels": {"rank": 0, "counters": {}, "tenants": {
        'team"a\\prod\nsecond_line': {
            "responses": 4, "tensors": 8, "bytes": 256,
            "negotiation_wait_us": {"buckets": [2, 2], "sum_us": 10,
                                    "count": 4}}}},
    "fleet_section": {"rank": 0,
                      "counters": {"steps_total": 5,
                                   "fleet_sketches_merged_total": 12},
                      "gauges": {"elastic_generation": 2,
                                 "goodput_ratio_ppm": 731250},
                      "histograms": {"negotiation_wait_us": _HISTOGRAM},
                      "tenants": _TENANTS, "fleet": _FLEET},
    "per_tenant": {"rank": 0, "counters": {"steps_total": 5},
                   "gauges": {"elastic_generation": 2,
                              "goodput_ratio_ppm": 731250},
                   "histograms": {"negotiation_wait_us": _HISTOGRAM},
                   "tenants": _TENANTS},
    "goodput_absent": {"rank": 1, "gauges": {"x": 1}},
}


@pytest.mark.parametrize("dump", sorted(PROM_DUMPS))
def test_render_prometheus_matches_reference(dump):
    from horovod_tpu.utils.metrics import render_prometheus as reference

    from horovod_tpu_torch.utils.metrics import render_prometheus

    assert render_prometheus(PROM_DUMPS[dump]) == \
        reference(PROM_DUMPS[dump])


@pytest.mark.parametrize("rank", range(WORLD))
def test_live_prometheus_matches_reference_renderer(runs, rank):
    """The port's metrics_prometheus() has the lines of the reference's
    rendering of a live dump taken a moment before (values aside: cycle
    counters move in between), with one HELP and one TYPE line per
    family."""
    from horovod_tpu.utils.metrics import render_prometheus as reference

    def series(text):
        return [line.rsplit(" ", 1)[0] if not line.startswith("#") else line
                for line in text.splitlines()]

    port = runs["port"][rank]
    text = port["prometheus"]
    assert text and series(text) == series(reference(port["metrics"]))
    for kind in ("HELP", "TYPE"):
        fams = [line.split()[2] for line in text.splitlines()
                if line.startswith(f"# {kind} ")]
        assert len(fams) == len(set(fams)), kind


# -- fault specs ------------------------------------------------------------

@pytest.mark.parametrize("spec", FAULT_SPECS_VALID)
def test_valid_fault_specs_accepted(runs, spec):
    assert runs["port"][0]["fault_specs"][spec] == ""


@pytest.mark.parametrize("spec,needles", FAULT_SPECS_MALFORMED,
                         ids=[m[0] for m in FAULT_SPECS_MALFORMED])
def test_malformed_fault_specs_rejected(runs, spec, needles):
    msg = runs["port"][0]["fault_specs"][spec]
    assert msg
    bad = spec.split(",")[-1]
    assert bad in msg  # names the offending entry verbatim
    for needle in needles:
        assert needle in msg, (needle, msg)


# -- configuration ----------------------------------------------------------

# One non-default value for each variable Config.from_env reads.
ENV_CASES = {
    "HOROVOD_RANK": "3", "HOROVOD_SIZE": "8", "HOROVOD_LOCAL_RANK": "1",
    "HOROVOD_LOCAL_SIZE": "4", "HOROVOD_CROSS_RANK": "1",
    "HOROVOD_CROSS_SIZE": "2", "HOROVOD_GLOO_RENDEZVOUS_ADDR": "10.0.0.9",
    "HOROVOD_RENDEZVOUS_ADDR": "10.0.0.8",
    "HOROVOD_GLOO_RENDEZVOUS_PORT": "29500",
    "HOROVOD_RENDEZVOUS_PORT": "29501",
    "HOROVOD_WIRE_COMPRESSION": "host=bf16,device=int4",
    "HOROVOD_WIRE_COMPRESSION_MIN_BYTES": "4097",
    "HOROVOD_DEVICE_SCHEDULE": "torus", "HOROVOD_CONTROLLER": "Socket",
    "HOROVOD_FUSION_THRESHOLD": "1048576", "HOROVOD_CYCLE_TIME": "2.5",
    "HOROVOD_CACHE_CAPACITY": "0", "HOROVOD_AUTOTUNE": "1",
    "HOROVOD_AUTOTUNE_LOG": "/tmp/at.csv",
    "HOROVOD_HIERARCHICAL_ALLREDUCE": "yes",
    "HOROVOD_TIMELINE": "/tmp/tl.json", "HOROVOD_TIMELINE_MARK_CYCLES": "1",
    "HOROVOD_METRICS": "1", "HOROVOD_METRICS_FILE": "/tmp/m.json",
    "HOROVOD_METRICS_INTERVAL": "0.5", "HOROVOD_FLIGHT_RECORDER": "off",
    "HOROVOD_FLIGHT_RECORDER_SLOTS": "64", "HOROVOD_POSTMORTEM_DIR": "/tmp/pm",
    "HOROVOD_LOG_LEVEL": "DEBUG", "HOROVOD_STALL_CHECK_DISABLE": "1",
    "HOROVOD_STALL_CHECK_TIME_SECONDS": "5",
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "9",
    "HOROVOD_AUTOPILOT_PORT": "7777", "HOROVOD_STEP_TRACE": "0",
    "HOROVOD_STEP_TRACE_SLOTS": "32", "HVD_TPU_PURE_PY": "1",
}


@pytest.mark.parametrize("var", ["(empty)", "(all)"] + sorted(ENV_CASES))
def test_config_matches_reference(monkeypatch, var):
    """Every field Config.from_env shares with the reference's takes the
    reference's value, in an empty environment and with each variable set."""
    import dataclasses

    from horovod_tpu.utils.env import Config as Reference

    from horovod_tpu_torch.utils.env import Config

    for name in list(os.environ):
        if name.startswith(("HOROVOD_", "HVD_")):
            monkeypatch.delenv(name)
    env = ENV_CASES if var == "(all)" else \
        {} if var == "(empty)" else {var: ENV_CASES[var]}
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    port, ref = Config.from_env(), Reference.from_env()
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert len(shared) >= 35
    diff = {n: (getattr(port, n), getattr(ref, n)) for n in sorted(shared)
            if getattr(port, n) != getattr(ref, n)}
    assert not diff
    if var == "(empty)":
        assert port.flight_recorder_enabled and port.step_trace_enabled


# -- build queries, devices, device trace, bpps -------------------------------

BUILD_QUERIES = {
    "mpi_threads_supported": False, "mpi_enabled": False, "mpi_built": False,
    "ddl_built": False, "ccl_built": False, "rocm_built": False,
    "tpu_built": False, "gloo_enabled": True, "gloo_built": True,
    "nccl_built": torch.distributed.is_nccl_available(),
    "cuda_built": torch.backends.cuda.is_built(),
}


@pytest.mark.parametrize("query", sorted(BUILD_QUERIES))
def test_build_queries_report_the_port(query):
    import horovod_tpu_torch as hvd

    assert getattr(hvd, query)() is BUILD_QUERIES[query]


def test_num_devices_counts_cuda_devices_or_the_host():
    import horovod_tpu_torch as hvd

    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert hvd.num_devices() == want


def test_start_device_trace_writes_a_chrome_trace(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.start_device_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        hvd.start_device_trace(str(tmp_path))
    with torch.profiler.record_function("obs.traced_range"):
        torch.ones(64).add_(1.0)
    path = hvd.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        trace = json.load(f)
    assert "obs.traced_range" in {e.get("name")
                                  for e in trace["traceEvents"]}
    with pytest.raises(RuntimeError, match="no device trace"):
        hvd.stop_device_trace()


@pytest.fixture()
def world_one(monkeypatch):
    """A world of one in this process on the pure-Python core (the JAX
    package's native core may be loaded here already)."""
    import horovod_tpu_torch as hvd

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("HOROVOD_CONTROLLER", "python")
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_set_backward_passes_per_step(world_one):
    """tests/single/test_torch_binding.py:139 against the port: after the
    setter, the first backward only accumulates, the second reduces."""
    hvd = world_one
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1, bias=False)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1.0),
        named_parameters=model.named_parameters())
    opt.set_backward_passes_per_step(2)
    model(torch.ones(1, 3)).sum().backward()
    assert not opt._handles
    model(torch.ones(1, 3)).sum().backward()
    assert opt._handles
    before = model.weight.detach().clone()
    opt.step()
    # Two passes of gradient 1 each, prescaled by 1/2, at lr 1.
    assert torch.equal(model.weight.detach(), before - 1.0)
