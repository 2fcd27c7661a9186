"""Hold the ``compiled_plane`` phase's checks against planted faults on one
NVIDIA card.

    python3 chip_plane_faults.py [--seed N]

Builds the flash kernels and the native core as ``chip_smoke.py`` does,
then runs that phase's two ranks (GPT_SMALL's width at
``chip_smoke.PLANE_LAYERS`` blocks on replicated DTensor parameters,
``PLANE_STEPS`` compiled gspmd steps over Inductor and the eager replay,
gloo on ``cuda:0``) once for each entry of ``FAULTS``, all sharing one
Inductor cache:

- ``sound``: as ``chip_smoke.py`` runs them;
- ``dup_shard``: the compiled run's rank 1 trains on rank 0's sequences, a
  batch split that repeats one shard (the ranks stay equal, and the first
  loss is that of random weights either way);
- ``unreduced_embeddings``: ``wte``'s and ``wpe``'s gradients are labelled
  replicated without their all-reduce, so each rank steps those leaves on
  its own share of the gradient.

Each run prints one JSON line: per rank ||update difference|| / ||update||
and the largest element difference against the eager replay, the first
check of ``chip_smoke.check_plane`` that refuses it (None where all pass)
and the profiled last step's device ms of K4-K6 and the GEMMs; whether
the ranks' parameters agree; the seconds.  It exits 0 when
the sound run passes every check and each fault is refused by one of them
(the ranks' agreement included), 1 otherwise or without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

FAULTS = ("sound", "dup_shard", "unreduced_embeddings")


def plant(fault: str) -> None:
    """Patch this process's compiled-plane path for ``fault``."""
    if fault == "dup_shard":
        compiled = chip_smoke.plane_compiled

        def plane_compiled(hvd, fa, qz, seed, rank, tokens):
            per = chip_smoke.PLANE_BATCH // 2
            dup = tokens.clone()
            dup[:, per:] = tokens[:, :per]
            return compiled(hvd, fa, qz, seed, rank, dup)

        chip_smoke.plane_compiled = plane_compiled
    elif fault == "unreduced_embeddings":
        from torch.distributed.tensor import DTensor, Replicate

        from horovod_tpu_torch.models import GPT_SMALL as cfg
        from horovod_tpu_torch.ops import gspmd_plane

        pin = gspmd_plane.constrain_grad_leaf
        shapes = {(cfg.vocab_size, cfg.hidden_size),
                  (cfg.max_seq_len, cfg.hidden_size)}

        def constrain_grad_leaf(leaf, mesh, count=True):
            if tuple(leaf.shape) in shapes:
                return DTensor.from_local(leaf.to_local(), mesh,
                                          [Replicate()], run_check=False)
            return pin(leaf, mesh, count=count)

        gspmd_plane.constrain_grad_leaf = constrain_grad_leaf
    elif fault != "sound":
        raise ValueError(f"unknown fault {fault!r}")


def fault_rank(rank, port, seed, cache, fault, queue):
    """One rank of :func:`chip_smoke.plane_rank` with ``fault`` planted."""
    plant(fault)
    chip_smoke.plane_rank(rank, port, seed, "GLOO", cache, queue)


def run(seed: int, fault: str, cache: str, card: str) -> dict:
    """One pair of ranks with ``fault`` planted: its readings and whether
    the phase's checks refuse it."""
    t0 = time.perf_counter()
    reports, codes = chip_smoke.RankPair(
        fault_rank, (seed, cache, fault)).collect(chip_smoke.PLANE_TIMEOUT_S)
    row = {"fault": fault, "card": card, "exit_codes": codes}
    refused = False
    for r, rep in sorted(reports.items()):
        if "error" in rep:
            row[f"rank{r}"] = {"error": rep["error"][-3000:]}
            continue
        try:
            chip_smoke.check_plane(rep, chip_smoke.PLANE_LAYERS)
            caught = None
        except AssertionError as e:
            caught, refused = str(e)[:400], True
        row[f"rank{r}"] = {
            "vs_eager": rep["vs_eager"], "check_plane": caught,
            "losses": rep["compiled"]["losses"],
            "eager_losses": rep["eager"]["losses"],
            "compile_and_first_step_s":
                rep["compiled"]["compile_and_first_step_s"],
            "profiled_step_ms": {
                k: v for k, v in
                rep["compiled"]["breakdown"]["by_category_ms"].items()
                if k in chip_smoke.FLASH_CATEGORIES or k == "gemm"}}
    digests = {rep.get("params_digest") for rep in reports.values()}
    row["ranks_agree"] = len(digests) == 1
    row["refused"] = refused or not row["ranks_agree"]
    row["complete"] = codes == [0, 0] and len(reports) == 2 and \
        not any("error" in rep for rep in reports.values())
    row["seconds"] = round(time.perf_counter() - t0, 3)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and token ids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_plane_faults: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        core = pool.submit(_build.build_core)
        list(pool.map(_build.build, ("flash_attention", "quantize")))
        core.result()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3)}),
          flush=True)
    cache = tempfile.mkdtemp(prefix="hvd_plane_faults_")
    ok = True
    try:
        for fault in FAULTS:
            row = run(args.seed, fault, cache, card)
            print(json.dumps(row), flush=True)
            want = fault != "sound"
            ok = ok and row["complete"] and row["refused"] == want
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
