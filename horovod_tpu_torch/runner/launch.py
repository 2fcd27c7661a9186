"""horovodrun-equivalent launcher of the port.

Reference: horovod/runner/launch.py (parse_args/_run/run_commandline) +
gloo_run.py (launch_gloo: rendezvous env + one worker per slot), and its
own copy in ``horovod_tpu/runner/launch.py``.  One worker process per slot
with the env-var contract ``hvd.init()`` reads (HOROVOD_RANK/SIZE/
LOCAL_RANK/..., HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT: the torch store's
address), ssh for remote hosts, and the elastic driver when ``--min-np``,
``--max-np`` or a discovery script is given.  A worker takes
``cuda:<local_rank>`` itself, so no device mask is set.

``--autopilot`` (the driver evicts persistent stragglers) and
``--cockpit`` (rank 0 serves a live loopback endpoint), or their env
spellings ``HOROVOD_AUTOPILOT`` / ``HOROVOD_COCKPIT``, route as the
reference's do; ``--autopilot`` implies the elastic driver.
``--gpu-discovery`` takes the elastic host set from a GPU fleet
(``runner/gpu_discovery.py``).  The reference's ``--jax-distributed`` has
no counterpart on a GPU and is not a flag here; its ``--tpu-discovery``
exits 2 naming ``--gpu-discovery``.

Usage:
    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch --min-np 2 -np 2 \
        -H localhost:2 python train.py
    python -m horovod_tpu_torch.runner.launch --min-np 2 -np 3 \
        --autopilot --cockpit -H hostA:2,hostB:1 python train.py
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional

from .util import (assign_ranks, find_free_port, forwardable_env,
                   local_hostnames, parse_hosts, ssh_command)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="horovodrun",
        description="Launch a horovod_tpu_torch distributed job.")
    p.add_argument("-np", "--num-proc", type=int, required=False,
                   help="Total number of worker processes.")
    p.add_argument("-H", "--hosts", default=None,
                   help="host1:slots,host2:slots (default: localhost:np)")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("--network-interface", default=None,
                   help="accepted for reference parity; unused")
    p.add_argument("--start-timeout", type=int, default=60)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--disable-cache", action="store_true",
                   help="disable the response cache")
    # Elastic flags (reference parity; the driver is runner.elastic_driver).
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None)
    p.add_argument("--tpu-discovery", action="store_true",
                   help="refused with exit code 2: a GPU fleet has no "
                        "TPU-VM metadata; use --gpu-discovery")
    p.add_argument("--gpu-discovery", action="store_true",
                   help="elastic host discovery over a GPU fleet: the "
                        "workers of HOROVOD_GPU_WORKERS that answer a TCP "
                        "probe (HOROVOD_GPU_PROBE_PORT, default 22), "
                        "instead of a discovery script")
    p.add_argument("--slots-per-host", type=int, default=1,
                   help="slots per discovered host (elastic mode)")
    p.add_argument("--autopilot", action="store_true",
                   help="fleet autopilot: the driver polls the "
                        "coordinator's straggler verdicts and evicts "
                        "persistent offenders into the expiring elastic "
                        "blacklist, scaling back up when sentences lapse "
                        "(implies elastic mode and HOROVOD_METRICS=1; "
                        "knobs HOROVOD_AUTOPILOT_EVICT_WINDOWS, _MIN_NP, "
                        "_COOLDOWN_SECS)")
    p.add_argument("--cockpit", action="store_true",
                   help="live cluster cockpit: rank 0 serves /metrics, "
                        "/state, /history and /events (SSE) on a loopback "
                        "port the elastic driver keeps stable across "
                        "re-formations; watch it with tools/hvd_top.py")
    # Tuning flags mirroring the reference CLI -> env contract.
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--metrics-file", default=None,
                   help="periodic per-rank JSON metrics snapshots; a "
                        "literal {rank} in the path is substituted, "
                        "otherwise .<rank> is appended "
                        "(HOROVOD_METRICS_FILE; implies HOROVOD_METRICS)")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--hierarchical-allreduce", action="store_true",
                   help="compose shm-local reduce + leader-only cross-host "
                        "ring + shm-local broadcast when hosts hold "
                        "co-located ranks (HOROVOD_HIERARCHICAL_ALLREDUCE)")
    p.add_argument("--wire-compression", default=None,
                   help="codec for fp32 allreduce payloads: a bare codec "
                        "(none|bf16|int8) applies to the host ring's hops, "
                        "or per-plane plane=codec assignments, e.g. "
                        "'host=bf16,device=int8' ('device=int8' puts "
                        "DistributedOptimizer's gradients on the quantized "
                        "ring with error feedback); accumulation stays "
                        "fp32 (HOROVOD_WIRE_COMPRESSION)")
    p.add_argument("--data-plane", default=None,
                   choices=["auto", "eager", "gspmd"],
                   help="the plane DistributedOptimizer reduces gradients "
                        "on: 'eager' (the negotiated spine's grad hooks), "
                        "'gspmd' (DTensor gradients pinned replicated, the "
                        "all-reduce inside the compiled step), or 'auto' "
                        "(gspmd for DTensor parameters where it composes) "
                        "(HOROVOD_DATA_PLANE)")
    p.add_argument("--control-tree", default=None,
                   choices=["auto", "on", "off"],
                   help="leader-tree control plane (protocol v12): host "
                        "leaders aggregate worker cycle frames so the "
                        "coordinator handles O(fanout) messages instead of "
                        "O(ranks); auto engages on multi-host jobs with "
                        "np >= 8 (HOROVOD_CONTROL_TREE)")
    p.add_argument("--ctrl-tree-fanout", default=None, type=int,
                   metavar="N",
                   help="per-node fan-in bound of the adaptive-depth "
                        "leader tree (default 32, min 2): when a job spans "
                        "more hosts than this, mid-level super-leaders are "
                        "inserted until every node gathers at most N "
                        "aggregate links (HOROVOD_CTRL_TREE_FANOUT)")
    p.add_argument("--control-tree-depth", default=None, type=int,
                   metavar="D",
                   help="force an exact leader-tree level count instead of "
                        "the adaptive fanout rule: 2 pins the v9 two-level "
                        "shape, 3+ always inserts super-leader layers; 0 "
                        "or unset = adaptive (HOROVOD_CONTROL_TREE_DEPTH)")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="crash-bundle directory: every rank dumps its "
                        "flight-recorder ring there on abort or fatal "
                        "signal, and the coordinator writes a merged "
                        "postmortem.json naming the culprit; a literal "
                        "{rank} in the path is substituted "
                        "(HOROVOD_POSTMORTEM_DIR; render with "
                        "tools/postmortem.py)")
    p.add_argument("--no-flight-recorder", action="store_true",
                   help="disable the always-on flight recorder "
                        "(HOROVOD_FLIGHT_RECORDER=off)")
    p.add_argument("--fault-inject", default=None, metavar="SPEC",
                   help="deterministic fault injection for chaos testing: "
                        "comma-separated site:cycle:rank:action[:arg] rules "
                        "exported to every worker as HOROVOD_FAULT_INJECT "
                        "(validated before any worker spawns; see "
                        "docs/observability.md)")
    p.add_argument("--stall-check-disable", action="store_true")
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None)
    p.add_argument("--log-level", default=None)
    p.add_argument("--check-build", action="store_true")
    p.add_argument("--config-file", default=None,
                   help="YAML file of launcher parameters (reference "
                        "horovodrun --config-file layout); explicit CLI "
                        "flags win over file values")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command")
    args = p.parse_args(argv)
    if args.config_file:
        _apply_config_file(args, p,
                           argv if argv is not None else sys.argv[1:])
    return args


def _apply_config_file(args: argparse.Namespace,
                       parser: argparse.ArgumentParser,
                       argv: List[str]) -> None:
    """Merge a YAML config file under explicit CLI flags (reference:
    runner/launch.py parse_args' --config-file handling: file values fill
    in, command line overrides)."""
    import yaml

    with open(args.config_file) as f:
        cfg = yaml.safe_load(f) or {}
    # Reference layout: flat keys plus nested timeline/autotune/stall-check.
    flat = {
        "verbose": cfg.get("verbose"),
        "num_proc": cfg.get("num-proc", cfg.get("np")),
        "hosts": cfg.get("hosts"),
        "ssh_port": cfg.get("ssh-port"),
        "start_timeout": cfg.get("start-timeout"),
        "network_interface": cfg.get("network-interface"),
        "fusion_threshold_mb": cfg.get("fusion-threshold-mb"),
        "cycle_time_ms": cfg.get("cycle-time-ms"),
        "cache_capacity": cfg.get("cache-capacity"),
        "min_np": cfg.get("min-np"),
        "max_np": cfg.get("max-np"),
        "host_discovery_script": cfg.get("host-discovery-script"),
        "slots_per_host": cfg.get("slots-per-host"),
        "log_level": cfg.get("log-level"),
        "wire_compression": cfg.get("wire-compression"),
        "data_plane": cfg.get("data-plane"),
        "control_tree": cfg.get("control-tree"),
        "ctrl_tree_fanout": cfg.get("ctrl-tree-fanout"),
        "control_tree_depth": cfg.get("control-tree-depth"),
    }
    tl = cfg.get("timeline") or {}
    flat["timeline_filename"] = tl.get("filename")
    flat["timeline_mark_cycles"] = tl.get("mark-cycles")
    mt = cfg.get("metrics") or {}
    flat["metrics_file"] = mt.get("file")
    pm = cfg.get("postmortem") or {}
    flat["postmortem_dir"] = pm.get("dir")
    at = cfg.get("autotune") or {}
    flat["autotune"] = at.get("enabled")
    flat["autotune_log_file"] = at.get("log-file")
    sc = cfg.get("stall-check") or {}
    flat["stall_check_disable"] = sc.get("disable")
    flat["stall_check_warning_time_seconds"] = sc.get(
        "warning-time-seconds")
    # Only fill values the user did not pass on the command line.  Presence
    # is detected from argv itself (comparing against parser defaults would
    # let the file override an explicitly-passed default value).  Only the
    # launcher's own flags — everything before the command remainder — are
    # scanned, so flags inside the training command don't confuse it.
    own_argv = argv[:len(argv) - len(args.command)]
    explicit = set()
    for action in parser._actions:
        if any(opt in own_argv for opt in action.option_strings):
            explicit.add(action.dest)
    for key, value in flat.items():
        if value is None or not hasattr(args, key) or key in explicit:
            continue
        setattr(args, key, value)


def _tuning_env(args: argparse.Namespace) -> Dict[str, str]:
    env = {}
    if args.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.disable_cache:
        env["HOROVOD_CACHE_CAPACITY"] = "0"
    if args.timeline_filename:
        env["HOROVOD_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if args.metrics_file:
        env["HOROVOD_METRICS_FILE"] = args.metrics_file
    if args.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.hierarchical_allreduce:
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.wire_compression:
        env["HOROVOD_WIRE_COMPRESSION"] = args.wire_compression
    if args.data_plane:
        env["HOROVOD_DATA_PLANE"] = args.data_plane
    if args.control_tree:
        env["HOROVOD_CONTROL_TREE"] = args.control_tree
    if args.ctrl_tree_fanout is not None:
        env["HOROVOD_CTRL_TREE_FANOUT"] = str(args.ctrl_tree_fanout)
    if args.control_tree_depth is not None:
        env["HOROVOD_CONTROL_TREE_DEPTH"] = str(args.control_tree_depth)
    if args.postmortem_dir:
        env["HOROVOD_POSTMORTEM_DIR"] = args.postmortem_dir
    if args.no_flight_recorder:
        env["HOROVOD_FLIGHT_RECORDER"] = "off"
    if args.fault_inject:
        env["HOROVOD_FAULT_INJECT"] = args.fault_inject
    if args.stall_check_disable:
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_check_warning_time_seconds)
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if getattr(args, "autopilot", False):
        # Straggler attribution (the autopilot's input) lives behind the
        # metrics plane; the policy loop is useless without it.
        env["HOROVOD_METRICS"] = "1"
    if getattr(args, "cockpit", False):
        # The cockpit's /state straggler and tenant sections come from the
        # metrics plane too; the step trace is on by default.
        env["HOROVOD_COCKPIT"] = "1"
        env["HOROVOD_METRICS"] = "1"
    return env


def check_build(out=None) -> None:
    """What this installation of the port is built with: torch and its
    CUDA, NCCL and gloo, ``nvcc`` for the kernels, and whether the native
    core builds and loads (printed to ``out``, default stdout)."""
    import shutil

    import torch
    import torch.distributed as dist

    from .. import __version__
    from ..runtime import PROTOCOL_VERSION

    out = out or sys.stdout

    def mark(ok) -> str:
        return "X" if ok else " "

    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    try:
        from .. import _core

        _core.load_library()
        core_ok = True
    except Exception:  # noqa: BLE001 - a diagnostic, not a failure
        core_ok = False
    print("horovod_tpu_torch v%s (control protocol v%d):"
          % (__version__, PROTOCOL_VERSION), file=out)
    print("Available Frameworks:", file=out)
    print(f"    [X] PyTorch {torch.__version__}", file=out)
    print("Available Controllers:", file=out)
    print(f"    [{mark(core_ok)}] native C++ core (socket controller)",
          file=out)
    print("Available Tensor Operations:", file=out)
    print(f"    [{mark(torch.cuda.is_available())}] CUDA "
          f"{torch.version.cuda or '(not built)'}", file=out)
    print(f"    [{mark(dist.is_nccl_available())}] NCCL", file=out)
    print(f"    [{mark(dist.is_gloo_available())}] Gloo", file=out)
    print(f"    [{mark(nvcc)}] nvcc (hand-written kernels)"
          + (f" {nvcc}" if nvcc else ""), file=out)


class WorkerProcesses:
    """Spawn and supervise one process per rank (reference: gloo_run's
    exec + the launcher's output streaming/exit handling)."""

    def __init__(self):
        self.procs: List[subprocess.Popen] = []
        self._lock = threading.Lock()
        self._failed_rank: Optional[int] = None

    def launch(self, assignments, command: List[str], base_env: Dict[str, str],
               rendezvous_addr: str, rendezvous_port: int,
               ssh_port: Optional[int] = None, verbose: bool = False,
               stream_prefix: bool = True):
        threads = []
        for a in assignments:
            env = dict(base_env)
            env.update({
                "HOROVOD_RANK": str(a["rank"]),
                "HOROVOD_SIZE": str(len(assignments)),
                "HOROVOD_LOCAL_RANK": str(a["local_rank"]),
                "HOROVOD_LOCAL_SIZE": str(a["local_size"]),
                "HOROVOD_CROSS_RANK": str(a["cross_rank"]),
                "HOROVOD_CROSS_SIZE": str(a["cross_size"]),
                "HOROVOD_CONTROLLER": "socket",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR": rendezvous_addr,
                "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rendezvous_port),
            })
            if a["hostname"] in local_hostnames():
                proc = subprocess.Popen(
                    command, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            else:  # remote launch over ssh with env forwarding
                env_str = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in env.items()
                    if forwardable_env(k))
                ssh_cmd = ssh_command(ssh_port=ssh_port)
                remote = f"cd {shlex.quote(os.getcwd())} && env {env_str} " + \
                    " ".join(shlex.quote(c) for c in command)
                proc = subprocess.Popen(
                    ssh_cmd + [a["hostname"], remote], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            self.procs.append(proc)
            t = threading.Thread(target=self._stream, daemon=True,
                                 args=(a["rank"], proc, stream_prefix))
            t.start()
            threads.append(t)
        return threads

    def _stream(self, rank: int, proc: subprocess.Popen, prefix: bool):
        for line in iter(proc.stdout.readline, ""):
            if prefix:
                sys.stdout.write(f"[{rank}]<stdout>: {line}")
            else:
                sys.stdout.write(line)
            sys.stdout.flush()

    def wait(self, kill_on_failure: bool = True) -> int:
        """Wait for all workers; on the first failure, terminate the rest
        (matching horovodrun's behavior)."""
        exit_code = 0
        pending = {i: p for i, p in enumerate(self.procs)}
        while pending:
            for rank, proc in list(pending.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                del pending[rank]
                if rc != 0 and exit_code == 0:
                    exit_code = rc
                    self._failed_rank = rank
                    if kill_on_failure:
                        for other in pending.values():
                            try:
                                other.send_signal(signal.SIGTERM)
                            except OSError:
                                pass
            if pending:
                import time

                time.sleep(0.05)
        return exit_code

    def terminate(self):
        for p in self.procs:
            try:
                p.terminate()
            except OSError:
                pass


def _run(args: argparse.Namespace) -> int:
    if args.check_build:
        check_build()
        return 0
    from ..utils.env import get_bool

    # The env-var spellings of --autopilot and --cockpit, for launchers
    # driven from job templates where editing argv is awkward.
    args.autopilot = args.autopilot or get_bool("HOROVOD_AUTOPILOT", False)
    args.cockpit = args.cockpit or get_bool("HOROVOD_COCKPIT", False)
    if args.tpu_discovery:
        print("error: --tpu-discovery reads the TPU-VM metadata server, "
              "which a GPU fleet does not have; use --gpu-discovery "
              "(workers from HOROVOD_GPU_WORKERS)", file=sys.stderr)
        return 2
    if not args.command:
        print("error: no command given", file=sys.stderr)
        return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if args.fault_inject:
        # Pre-validate the spec against the native parser so a typo fails
        # here with one actionable message instead of failing hvd.init()
        # on every spawned worker at once.
        try:
            from .._core import check_fault_spec

            err = check_fault_spec(args.fault_inject)
        except Exception:
            err = ""  # no native core on the launch host; workers validate
        if err:
            print(f"error: --fault-inject: {err}", file=sys.stderr)
            return 2
    if args.host_discovery_script or args.gpu_discovery \
            or args.min_np is not None or args.autopilot:
        from .elastic_driver import run_elastic

        return run_elastic(args, command)
    # LSF allocation without explicit hosts: delegate placement to jsrun
    # (reference: launch.py routes to js_run on LSF clusters).
    from .js_run import LSFUtils, js_run

    if args.hosts is None and LSFUtils.using_lsf():
        return js_run(args, command)
    if args.num_proc is None:
        print("error: -np is required", file=sys.stderr)
        return 2

    hosts = parse_hosts(args.hosts) if args.hosts else [
        type("H", (), {"hostname": "localhost", "slots": args.num_proc})()]
    assignments = assign_ranks(hosts, args.num_proc)

    rendezvous_addr = "127.0.0.1"
    if any(a["hostname"] not in local_hostnames() for a in assignments):
        # Pre-flight probe (reference: driver/task services, SURVEY.md §2.5):
        # verify every host can exec us and find a mutually-routable
        # interface; fail fast with host names instead of hanging the first
        # collective.
        from .driver_service import preflight_probe

        probe = preflight_probe(hosts, ssh_port=args.ssh_port,
                                timeout=args.start_timeout)
        rendezvous_addr = probe["rendezvous_addr"]
        if args.verbose:
            print(f"pre-flight: all hosts reachable; rendezvous over "
                  f"{rendezvous_addr}", file=sys.stderr)
    rendezvous_port = find_free_port(
        "0.0.0.0" if rendezvous_addr != "127.0.0.1" else "127.0.0.1")

    base_env = dict(os.environ)
    base_env.update(_tuning_env(args))

    workers = WorkerProcesses()
    workers.launch(assignments, command, base_env, rendezvous_addr,
                   rendezvous_port, args.ssh_port, args.verbose)
    try:
        return workers.wait()
    except KeyboardInterrupt:
        workers.terminate()
        return 130


def run_commandline(argv: Optional[List[str]] = None) -> int:
    return _run(parse_args(argv))


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
